"""The port stands alone: no file of smoothxg_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package (smoothxg_tpu),
of its tools/ or of native/,
checked statically on every file and at run time by importing every module
of the port (test_torch_pipeline.py runs both GPU engines so); and the host
C++ libraries the port loads are its own builds of csrc/host/, never the
JAX package's native/*.so."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "smoothxg_tpu_torch")
FORBIDDEN = ("jax", "smoothxg_tpu", "tools", "native")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def forbidden_imports(src: str) -> list[str]:
    """Module names of `src` that are jax, smoothxg_tpu, tools or native
    or lie under them (relative imports stay inside their own
    package)."""
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if any(n == f or n.startswith(f + ".") for f in FORBIDDEN)]
    return bad


def test_the_walk_sees_every_kind_of_import():
    src = ("import jax\nimport numpy, jax.numpy as jnp\n"
           "from smoothxg_tpu.ops import poa_host\n"
           "from smoothxg_tpu import x\n"
           "from smoothxg_tpu_torch.ops import poa_host\nfrom . import jax\n"
           "def f():\n    import smoothxg_tpu.cli\n")
    assert forbidden_imports(src) == ["jax", "jax.numpy", "smoothxg_tpu.ops",
                                      "smoothxg_tpu", "smoothxg_tpu.cli"]


def test_the_walk_covers_the_ports_tools_and_flags_the_repos():
    """The port's own tools/ (the probes, the stage profile) are walked;
    the repository's TPU tools/ and native/ are forbidden."""
    tools = [p for p in _port_files()
             if p.startswith(os.path.join("smoothxg_tpu_torch", "tools"))]
    names = {os.path.basename(p) for p in tools}
    assert {"_probe.py", "probe_scalar_latency.py", "probe_smem.py",
            "probe_loop.py", "probe_loop2.py", "probe_smem2.py",
            "probe_stack.py", "profile_fused.py"} <= names
    src = ("import tools.probe_loop2\nfrom native import x\n"
           "from tools import probe_stack\n"
           "from smoothxg_tpu_torch.tools import _probe\n")
    assert forbidden_imports(src) == ["tools.probe_loop2", "native", "tools"]


@pytest.mark.parametrize("rel", _port_files())
def test_no_port_file_imports_jax_or_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        assert forbidden_imports(f.read()) == []


RUN = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import smoothxg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(smoothxg_tpu_torch.__path__,
                                              "smoothxg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from smoothxg_tpu_torch import native_bindings
from smoothxg_tpu_torch.ops import poa_native, sgd, wfa
for lib in (native_bindings.load(), poa_native.load(), sgd._native_lib(),
            wfa._native_lib()):
    print("LIB", lib._name)
print("MODULES", len(mods))
print("JAX", "jax" in sys.modules)
print("PKG", sorted(m for m in sys.modules
                    if m == "smoothxg_tpu" or m.startswith("smoothxg_tpu.")))
"""


def test_every_module_and_host_library_is_the_ports_own():
    """Importing every module of the port in a fresh interpreter loads
    neither jax nor any smoothxg_tpu module, and each host C++ library
    (graphcore, cpoa, sgd, wfa) is the port's g++ build of csrc/host/ in
    its own build directory, not the JAX package's native/*.so.  (The
    guard in test_torch_pipeline.py runs both GPU engines the same way.)"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run(
        [sys.executable, "-c", RUN.format(repo=REPO)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout.splitlines()
    assert int(next(ln for ln in out if ln.startswith("MODULES")).split()[1]) \
        >= 40
    libs = [ln.split(" ", 1)[1] for ln in out if ln.startswith("LIB")]
    assert len(libs) == 4
    for name, path in zip(("graphcore", "cpoa", "sgd", "wfa"), libs):
        assert os.path.dirname(path) == os.path.join(PORT, "_build"), path
        assert os.path.basename(path).startswith(f"lib{name}_")
    assert "JAX False" in out
    assert "PKG []" in out
