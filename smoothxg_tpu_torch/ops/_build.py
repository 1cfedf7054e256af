"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

The sources compile into one shared library with a plain C interface
(pointers and the stream go in as c_void_p), keyed by a hash of the sources
and flags, under smoothxg_tpu_torch/_build/ — built at first use, never when
a module is imported.  No PyTorch headers are involved, so a build takes
seconds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# what the last build printed and how long it took (None: loaded from cache)
build_log = {"seconds": None, "ptxas": "", "path": ""}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsmoothxg_cuda_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless a library for these exact sources exists."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, *_sources()],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log.update(seconds=time.perf_counter() - t0,
                     ptxas=res.stderr.strip(), path=path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.poa_win_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
            lib.poa_win_launch.restype = ci
            lib.poa_win_error_string.argtypes = [ci]
            lib.poa_win_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
