"""Temp-file registry wiped at process exit.

Reference: src/tempfile.cpp — a registry of created temp paths under one
mkdtemp parent directory, deleted by a static destructor at std::exit so
crashes and early exits never leak intermediates.  Here the registry is a
module-level set cleaned by atexit; `create()` mirrors the reference's
per-run parent directory, `register()` tracks files created elsewhere
(per-iteration GFAs, the mmap seqindex, debug FASTA dumps).
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

_FILES: set[str] = set()
_PARENT: str | None = None
_DIR: str = ""


def set_dir(d: str) -> None:
    """Base directory for the per-run temp parent (reference:
    temp_file::set_dir, src/main.cpp:230-236)."""
    global _DIR
    _DIR = d


def create(base: str = "smoothxg") -> str:
    """Path of a fresh registered temp file inside the per-run parent
    directory (created lazily, removed wholesale at exit)."""
    global _PARENT
    if _PARENT is None:
        _PARENT = tempfile.mkdtemp(prefix=f"{base}-",
                                   dir=_DIR or None)
    fd, path = tempfile.mkstemp(dir=_PARENT)
    os.close(fd)
    _FILES.add(path)
    return path


def unique(prefix: str, suffix: str = "") -> str:
    """Path of a fresh empty file in the base directory (`set_dir`),
    named `prefix` + random characters + `suffix`, so that processes
    sharing that directory never write one another's file.  Not
    registered: the caller decides whether it is wiped at exit."""
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=suffix,
                                dir=_DIR or None)
    os.close(fd)
    return path


def register(path: str) -> str:
    _FILES.add(path)
    return path


def unregister(path: str) -> None:
    _FILES.discard(path)


def cleanup() -> None:
    global _PARENT
    for p in list(_FILES):
        try:
            os.remove(p)
        except OSError:
            pass
        _FILES.discard(p)
    if _PARENT is not None:
        shutil.rmtree(_PARENT, ignore_errors=True)
        _PARENT = None


atexit.register(cleanup)
