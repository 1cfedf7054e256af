"""The port's slice end to end on the CPU: the seeded synthetic pangenome,
run_smoothing with the port's engine against the JAX package's native run
(same GFA and MAF bytes), the CLI's refusal to run without CUDA, and the
guard that the port never imports JAX."""
import hashlib
import os
import re
import subprocess
import sys

import pytest

from smoothxg_tpu.io.gfa import read_gfa
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch import cli
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import make_pangenome, write_pangenome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cfg(gfa, tmp, tag, engine):
    return Config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
                  write_msa_in_maf_format=str(tmp / f"{tag}.maf"),
                  n_haps=4, max_path_jump=5000, max_edge_jump=5000,
                  poa_length_targets=[700], threads=1, add_consensus=True,
                  tmp_base=str(tmp), engine=engine)


def test_synth_is_deterministic_and_valid(tmp_path):
    a = make_pangenome(haplotypes=4, length=3000, seed=3)
    assert a == make_pangenome(haplotypes=4, length=3000, seed=3)
    assert a != make_pangenome(haplotypes=4, length=3000, seed=4)
    g = read_gfa(write_pangenome(str(tmp_path / "p.gfa"), haplotypes=4,
                                 length=3000, seed=3))
    assert g.path_count() == 4
    lens = [len(g.path_seq(i)) for i in range(4)]
    assert all(2000 < n < 4000 for n in lens), lens
    assert len(set(g.path_seq(i) for i in range(4))) == 4
    kinds = {ln[0] for ln in a.splitlines()}
    assert kinds == {"H", "S", "L", "P"}


def test_slice_matches_native_bytes(tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    _, _, eng = run_smoothing(_cfg(gfa, tmp_path, "port", "fused"),
                              device="cpu")
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native"))
    st = eng.stats()
    assert st["device_blocks"] > 0 and st["fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


def test_cli_maps_flags_like_the_jax_package_cli(tmp_path):
    from smoothxg_tpu import cli as jax_cli
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=3,
                          length=1500, seed=5)
    common = ["-g", gfa, "-r", "3", "-j", "5k", "-e", "5k", "-l", "400",
              "-t", "1", "--engine", "native"]
    rc, _ = cli.run(common + ["-o", str(tmp_path / "a.gfa"),
                              "-m", str(tmp_path / "a.maf")])
    assert rc == 0
    assert jax_cli.main(common + ["-o", str(tmp_path / "b.gfa"),
                                  "-m", str(tmp_path / "b.maf")]) == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"a.{ext}") == _sha(tmp_path / f"b.{ext}")


def _port_cli(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "smoothxg_tpu_torch.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_cli_without_cuda_fails_loudly(tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=2,
                          length=500, seed=1)
    res = _port_cli(["-g", gfa, "-o", str(tmp_path / "o.gfa"), "-r", "2"])
    assert res.returncode != 0
    assert "CUDA required" in res.stderr
    assert not os.path.exists(tmp_path / "o.gfa")


@pytest.mark.parametrize("flags", [
    ["--engine", "jax"], ["--engine", "pallas"], ["--dist-size", "2"],
    ["--device-split-minhash"], ["--device-split-wfa"]])
def test_cli_refuses_engines_not_yet_ported(tmp_path, capsys, flags):
    """Routes that would need the JAX package's device code exit 1 with a
    "not yet ported" message instead of importing jax."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=2,
                          length=500, seed=1)
    rc, _ = cli.run(["-g", gfa, "-o", str(tmp_path / "o.gfa"), "-r", "2",
                     *flags])
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o.gfa")


GUARD = """
import sys
sys.path.insert(0, {repo!r})
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome
d = {tmp!r}
g = write_pangenome(d + "/g.gfa", haplotypes=3, length=1200, seed=2)
_, _, eng = run_smoothing(Config(gfa_in=g, smoothed_out=d + "/o.gfa",
    write_msa_in_maf_format=d + "/o.maf", n_haps=3, max_path_jump=5000,
    max_edge_jump=5000, poa_length_targets=[400], threads=1,
    tmp_base=d, engine="fused"), device="cpu")
assert eng.stats()["device_blocks"] > 0
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_slice_runs_without_importing_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run(
        [sys.executable, "-c", GUARD.format(repo=REPO, tmp=str(tmp_path))],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "JAX_LOADED False" in res.stdout


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    bad = []
    root = os.path.join(REPO, "smoothxg_tpu_torch")
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(d, fn)) as f:
                    if pat.search(f.read()):
                        bad.append(fn)
    assert not bad
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pat.search(f.read())
