"""The host half of the port's sanitizer lane (tools/sanitize.py --host):
the SMOOTHXG_TORCH_NATIVE_DIR hook of ops/_build.host_lib, through which
all four host-library loaders (native_bindings, ops/poa_native, ops/sgd,
ops/wfa) load, and the four libraries built under AddressSanitizer and
UBSan (ops/_build.build_sanitized_host) running the pipeline.

* The hook: each loader loads its library from the directory the variable
  names, and a directory without it raises (never the plain build in
  its place); the JAX package's own hook, SMOOTHXG_NATIVE_DIR, moves none
  of the port's loaders.
* A child process with libasan, libubsan and libstdc++ preloaded and the
  hook on the sanitized builds runs run_smoothing(Config(engine="native"),
  device="cpu") on the divergent fixture over a seeded 4 x 4 kb
  pangenome, with the split stage's settings of test_torch_pipeline.py
  (so that it reaches cpoa, graphcore, sgd and wfa): no sanitizer report,
  every library mapped from the sanitized directory, and the GFA and MAF
  bytes of the same run on the plain builds."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from smoothxg_tpu_torch import native_bindings
from smoothxg_tpu_torch.ops import _build, poa_native, sgd, wfa
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.tools.sanitize import host_env

# each library's loader and the module globals that cache it
LOADERS = {"graphcore": (native_bindings, "load", "_LIB", "_TRIED"),
           "cpoa": (poa_native, "load", "_LIB", "_TRIED"),
           "sgd": (sgd, "_native_lib", "_NATIVE", "_NATIVE_TRIED"),
           "wfa": (wfa, "_native_lib", "_NATIVE", "_NATIVE_TRIED")}


def _fresh(monkeypatch, name):
    """The loader of `name` with its cache emptied (restored after)."""
    mod, fn, lib, tried = LOADERS[name]
    monkeypatch.setattr(mod, lib, None)
    monkeypatch.setattr(mod, tried, False)
    return getattr(mod, fn)


def test_hook_loads_each_library_from_its_directory(tmp_path, monkeypatch):
    for name in LOADERS:
        shutil.copy(_build.host_lib(name), tmp_path / f"lib{name}.so")
    monkeypatch.setenv("SMOOTHXG_NATIVE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv(_build.NATIVE_DIR_ENV, str(tmp_path))
    for name in LOADERS:
        assert _build.host_lib(name) == str(tmp_path / f"lib{name}.so")
        lib = _fresh(monkeypatch, name)()
        assert lib is not None and lib._name == str(tmp_path /
                                                    f"lib{name}.so")


def test_hook_without_the_library_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv(_build.NATIVE_DIR_ENV, str(tmp_path))
    for name in LOADERS:
        with pytest.raises(RuntimeError, match=f"holds no lib{name}.so"):
            _fresh(monkeypatch, name)()


def test_jax_package_hook_moves_no_port_loader(tmp_path, monkeypatch):
    monkeypatch.delenv(_build.NATIVE_DIR_ENV, raising=False)
    monkeypatch.setenv("SMOOTHXG_NATIVE_DIR", str(tmp_path))
    assert _build.host_lib("wfa") == _build.host_lib_path("wfa")


CHILD = r"""
import hashlib, json, sys
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
cfg = json.loads(sys.argv[1])
run_smoothing(Config(**cfg), device="cpu")
maps = [ln.split()[-1] for ln in open("/proc/self/maps") if ".so" in ln]
print(json.dumps({"maps": sorted(set(maps)), "sha": [
    hashlib.sha256(open(p, "rb").read()).hexdigest()
    for p in (cfg["smoothed_out"], cfg["write_msa_in_maf_format"])]}))
"""


def _cfg(gfa, tmp, tag):
    return dict(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
                write_msa_in_maf_format=str(tmp / f"{tag}.maf"), n_haps=4,
                max_path_jump=5000, max_edge_jump=5000,
                poa_length_targets=[700], threads=1, add_consensus=True,
                tmp_base=str(tmp), engine="native", max_poa_length=1400,
                block_group_identity=0.95, block_group_est_identity=0.9,
                min_dedup_depth_for_block_splitting=2)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_sanitized_libraries_give_the_plain_bytes(tmp_path):
    from smoothxg_tpu_torch.io.synth import make_divergent_gfa
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    src = write_pangenome(str(tmp_path / "a.gfa"), haplotypes=4,
                          length=4000, seed=11)
    gfa = str(tmp_path / "div.gfa")
    make_divergent_gfa(src, gfa, tiles=2, seed=7)
    d = _build.build_sanitized_host()
    res = subprocess.run([sys.executable, "-c", CHILD,
                          json.dumps(_cfg(gfa, tmp_path, "asan"))],
                         env=host_env(d), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-6000:]
    assert "AddressSanitizer" not in res.stderr
    assert "runtime error" not in res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for name in LOADERS:
        assert os.path.join(d, f"lib{name}.so") in got["maps"], name
    run_smoothing(Config(**_cfg(gfa, tmp_path, "plain")), device="cpu")
    assert got["sha"] == [_sha(tmp_path / "plain.gfa"),
                          _sha(tmp_path / "plain.maf")]
