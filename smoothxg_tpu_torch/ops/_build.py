"""Build the port's native code at first use, never when a module is
imported, into smoothxg_tpu_torch/_build/, keyed by a hash of the sources
and flags.

* CUDA kernels (the POA kernels, --engine jax's poa_batch.cu, the probes,
  the SGD layout's sgd.cu, the split stage's minhash.cu and ident.cu, and
  repeat_batch's autocorr.cu):
  each csrc/*.cu (with the
  shared csrc/*.cuh) compiles with its own nvcc process, all started
  together, and one nvcc call links the objects into one shared library
  with a plain C interface (pointers and the stream go in as c_void_p),
  loaded with ctypes.  No PyTorch headers are involved, so a build takes
  seconds.
* Host libraries: each csrc/host/<name>.cpp compiles with g++ into
  lib<name>.so (graphcore, cpoa, sgd, wfa), with the flags the JAX
  package's native/Makefile uses, so both packages compute the same bytes;
  build_sanitized_host builds them under AddressSanitizer and UBSan, and
  SMOOTHXG_TORCH_NATIVE_DIR points the bindings at such builds.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsmoothxg_cuda_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless a library for these exact sources exists:
    one nvcc process per source, all at once, then one link."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    procs = []
    try:
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [_nvcc(), *FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        for src, _, proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}{err}")
            logs.append(err.strip())
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", tmp,
                              *(obj for _, obj, _ in procs)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    build_log.update(seconds=time.perf_counter() - t0,
                     ptxas="\n".join(logs), path=path)
    return path


HOST_CSRC = os.path.join(CSRC, "host")
HOST_NAMES = ("graphcore", "cpoa", "sgd", "wfa")
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared"]
# AddressSanitizer and UBSan, as the JAX package's native/Makefile builds
# its native/asan/ libraries; the CUDA emulation (testing/cuda_emu.py)
# builds a kernel source with them too
SANITIZE_FLAGS = ["-g", "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all", "-fno-omit-frame-pointer"]
HOST_SANITIZE_FLAGS = ["-O1", *SANITIZE_FLAGS, "-march=native", "-fPIC",
                       "-std=c++17", "-Wall", "-shared"]
_HOST_EXTRA = {"sgd": ["-pthread"]}
# a directory of lib<name>.so builds that every host library loads from in
# place of _build/ (the counterpart of the JAX package's
# SMOOTHXG_NATIVE_DIR, under a name of its own, since both packages load
# in one test process)
NATIVE_DIR_ENV = "SMOOTHXG_TORCH_NATIVE_DIR"
# seconds of each host library's last g++ build in this process
host_build_log: dict = {}


def _host_cmd(name: str, flags=HOST_FLAGS) -> list[str]:
    return [os.environ.get("CXX", "g++"), *flags,
            *_HOST_EXTRA.get(name, [])]


def _host_hash(name: str, flags=HOST_FLAGS) -> str:
    h = hashlib.sha256(" ".join(_host_cmd(name, flags)).encode())
    with open(os.path.join(HOST_CSRC, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def host_lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_host_hash(name)}.so")


def _compile_host(name: str, flags, path: str) -> bool:
    """g++ csrc/host/<name>.cpp into `path` (through a temporary file
    beside it); False when the build fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [*_host_cmd(name, flags), "-o", tmp,
             os.path.join(HOST_CSRC, f"{name}.cpp")],
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return False
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    host_build_log[name] = time.perf_counter() - t0
    return True


def host_lib(name: str) -> str | None:
    """Path of csrc/host/<name>.cpp built as a shared library, compiling
    it unless a build of these exact sources exists; None when the build
    fails (the bindings then take their Python route, as the JAX
    package's do when native/ does not build).

    Where the environment's SMOOTHXG_TORCH_NATIVE_DIR names a directory,
    the library is that directory's lib<name>.so (the sanitized builds of
    build_sanitized_host), and a directory without it raises: the run
    must not quietly take the plain build.  It is an environment variable,
    as the reference's hook is, since that is the one setting that also
    reaches the spawn-context workers of utils/procpool.py."""
    hook = os.environ.get(NATIVE_DIR_ENV)
    if hook:
        path = os.path.join(hook, f"lib{name}.so")
        if not os.path.isfile(path):
            raise RuntimeError(f"{NATIVE_DIR_ENV}={hook} holds no "
                               f"lib{name}.so")
        return path
    path = host_lib_path(name)
    if os.path.exists(path) or _compile_host(name, HOST_FLAGS, path):
        return path
    return None


def sanitized_host_dir() -> str:
    """The directory build_sanitized_host builds into: _build/asan_<hash of
    the four sources and the sanitizer flags>/."""
    h = hashlib.sha256("".join(_host_hash(n, HOST_SANITIZE_FLAGS)
                               for n in HOST_NAMES).encode())
    return os.path.join(BUILD_DIR, f"asan_{h.hexdigest()[:16]}")


def build_sanitized_host() -> str:
    """Build csrc/host/{graphcore,cpoa,sgd,wfa}.cpp under AddressSanitizer
    and UBSan (HOST_SANITIZE_FLAGS, the reference's native/Makefile asan
    flags) as lib<name>.so in sanitized_host_dir(), unless built already;
    returns the directory, to be named by SMOOTHXG_TORCH_NATIVE_DIR in a
    process that preloads the sanitizer runtimes (tools/sanitize.py)."""
    from concurrent.futures import ThreadPoolExecutor
    d = sanitized_host_dir()
    todo = [n for n in HOST_NAMES
            if not os.path.exists(os.path.join(d, f"lib{n}.so"))]
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        built = dict(zip(todo, pool.map(
            lambda n: _compile_host(n, HOST_SANITIZE_FLAGS,
                                    os.path.join(d, f"lib{n}.so")), todo)))
    failed = [n for n, ok in built.items() if not ok]
    if failed:
        raise RuntimeError("sanitized g++ build of csrc/host/"
                           f"{', '.join(failed)} failed")
    return d


def loaded() -> bool:
    """Whether this process has loaded the kernel library."""
    return _LIB is not None


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.poa_round_launch.argtypes = [vp] * 10 + [ci] * 5 + [vp]
            lib.poa_round_launch.restype = ci
            lib.poa_round_geometry.argtypes = [ci] * 3 + [vp]
            lib.poa_round_geometry.restype = ci
            # the batched round of --engine jax (csrc/poa_batch.cu)
            lib.poa_batch_launch.argtypes = [vp] * 11 + [ci] * 5 + [vp]
            lib.poa_batch_launch.restype = ci
            lib.poa_batch_task_words.argtypes = [ci, ci]
            lib.poa_batch_task_words.restype = ctypes.c_longlong
            lib.poa_batch_geometry.argtypes = [ci] * 4 + [vp]
            lib.poa_batch_geometry.restype = ci
            # (..., B, RW, LW, VW, then W, pcap, LS (poa_win) or pcap,
            # stage, LS, then local, banded, stream) and the geometry (B,
            # VW, (poa_win: W,) pcap, LS, banded, int[4] (poa_win: int[6]))
            for name in ("poa_win", "poa_code", "poa_stacked"):
                getattr(lib, f"{name}_launch").argtypes = \
                    [vp] * 8 + [ci] * 9 + [vp]
                getattr(lib, f"{name}_launch").restype = ci
                getattr(lib, f"{name}_geometry").argtypes = \
                    [ci] * (6 if name == "poa_win" else 5) + [vp]
                getattr(lib, f"{name}_geometry").restype = ci
            lib.poa_win_prepare.argtypes = []
            lib.poa_win_prepare.restype = ci
            # the probes (csrc/probes.cu, smoothxg_tpu_torch/tools/_probe.py)
            lib.probe_scalar_launch.argtypes = [ci] * 4 + [vp] * 3
            lib.probe_row_launch.argtypes = [ci] * 4 + [vp] * 4
            lib.probe_tile_launch.argtypes = [ci] * 2 + [vp] * 4
            lib.probe_step_launch.argtypes = [ci] * 3 + [vp] * 4
            for fam in ("scalar", "row", "tile", "step"):
                getattr(lib, f"probe_{fam}_launch").restype = ci
            # the SGD layout and the split stage (csrc/sgd.cu, minhash.cu,
            # ident.cu)
            lib.sgd_plan_launch.argtypes = [vp] * 7 + [ctypes.c_float, ci,
                                                       vp, vp]
            lib.sgd_chain_launch.argtypes = [vp, vp, ci, vp]
            lib.minhash_hash_launch.argtypes = [vp] * 4 + [ci] * 4 + [vp]
            lib.minhash_inter_launch.argtypes = [vp] * 3 + [ci] * 3 + [vp]
            lib.ident_launch.argtypes = [vp] * 7 + [ci] * 5 + [vp]
            # the batched autocorrelation screen (csrc/autocorr.cu)
            lib.autocorr_launch.argtypes = [vp] * 5 + [ci] * 3 + [vp]
            lib.autocorr_geometry.argtypes = [ci] * 3 + [vp]
            lib.autocorr_geometry.restype = ci
            lib.autocorr_scratch_bytes.argtypes = [ci] * 3
            lib.autocorr_scratch_bytes.restype = ctypes.c_longlong
            for fn in ("sgd_plan_launch", "sgd_chain_launch",
                       "minhash_hash_launch",
                       "minhash_inter_launch", "ident_launch",
                       "autocorr_launch"):
                getattr(lib, fn).restype = ci
            lib.poa_win_error_string.argtypes = [ci]
            lib.poa_win_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
