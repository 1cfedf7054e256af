"""The port's slice end to end on the CPU: the seeded synthetic pangenome,
run_smoothing with the port's engine against the JAX package's native run
(same GFA and MAF bytes), the CLI's refusal to run without CUDA, and the
guard that the port never imports JAX nor the JAX package.  Each package's
objects come from its own modules."""
import hashlib
import os
import re
import subprocess
import sys

import pytest

from smoothxg_tpu.pipeline.run import Config as JaxConfig
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch import cli
from smoothxg_tpu_torch.io.gfa import read_gfa
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import make_pangenome, write_pangenome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cfg(gfa, tmp, tag, engine, config=Config):
    return config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
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
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
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


def test_cli_pallas_engine_without_cuda_fails_loudly(tmp_path):
    """--engine pallas runs its round kernel on the GPU: without CUDA it
    exits nonzero with "CUDA required" and writes nothing."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=2,
                          length=500, seed=1)
    res = _port_cli(["-g", gfa, "-o", str(tmp_path / "o.gfa"), "-r", "2",
                     "-m", str(tmp_path / "o.maf"), "--engine", "pallas"])
    assert res.returncode != 0
    assert "CUDA required" in res.stderr
    assert not os.path.exists(tmp_path / "o.gfa")
    assert not os.path.exists(tmp_path / "o.maf")


def test_api_default_engine_needs_cuda(tmp_path, monkeypatch):
    """run_smoothing(Config(...)) with no engine named runs the GPU engine,
    as the CLI does: without CUDA it raises and writes nothing."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=2,
                          length=500, seed=1)
    cfg = Config(gfa_in=gfa, smoothed_out=str(tmp_path / "o.gfa"), n_haps=2)
    assert cfg.engine == "fused"
    with pytest.raises(RuntimeError, match="CUDA required"):
        run_smoothing(cfg)
    assert not os.path.exists(tmp_path / "o.gfa")


@pytest.mark.parametrize("flags", [
    ["--engine", "jax"], ["--dist-size", "2"]])
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


# the split stage's settings of tests/test_divergent.py (-I 0.95, -E 0.9,
# -d 2), with mash clustering on for the MinHash route and off for the
# alignment-identity route
SPLIT_KW = dict(max_poa_length=1400, block_group_identity=0.95,
                block_group_est_identity=0.9,
                min_dedup_depth_for_block_splitting=2)
MASH_KW = dict(min_dedup_depth_for_mash_clustering=2,
               min_length_mash_based_clustering=100)


@pytest.fixture(scope="module")
def divergent(tmp_path_factory):
    """The divergent fixture (the port's copy of make_divergent_gfa) over
    the seeded generator's 6 x 10 kb pangenome, prepped and indexed by
    each package; and the blocks: the first two and the first four that
    the host alignment-identity route splits."""
    from smoothxg_tpu.graph.index import FlatIndex as JaxFlatIndex
    from smoothxg_tpu.io.gfa import read_gfa as jax_read_gfa
    from smoothxg_tpu.pipeline.prep import prep as jax_prep
    from smoothxg_tpu_torch.graph.index import FlatIndex
    from smoothxg_tpu_torch.io.synth import make_divergent_gfa
    from smoothxg_tpu_torch.pipeline.blocks import Blockset, smoothable_blocks
    from smoothxg_tpu_torch.pipeline.breaks import break_blocks
    from smoothxg_tpu_torch.pipeline.prep import prep
    d = tmp_path_factory.mktemp("divergent")
    src = write_pangenome(str(d / "a1.gfa"), haplotypes=6, length=10_000,
                          seed=11)
    gfa = str(d / "div.gfa")
    make_divergent_gfa(src, gfa, tiles=2, seed=7)
    idx = FlatIndex(prep(read_gfa(gfa), 100, device="cpu"))
    jidx = JaxFlatIndex(jax_prep(jax_read_gfa(gfa), 100))
    blocks = list(smoothable_blocks(idx, 700 * 12, 700, 5000, 5000))
    pick = [0, 1]
    for n, b in enumerate(blocks):
        one = Blockset()
        one.add_block(b)
        if len(pick) < 6 and len(break_blocks(idx, one, **SPLIT_KW)) > 1:
            pick.append(n)
    return idx, jidx, pick


def _partition(out):
    return out.break_stats, [tuple((pr.pid, pr.begin, pr.end)
                                   for pr in b.path_ranges) for b in out]


@pytest.mark.parametrize("flag,kw", [("device_minhash", MASH_KW),
                                     ("device_wfa", {})])
def test_split_device_routes_on_cpu_match_the_jax_package(divergent, flag,
                                                          kw):
    """--device-split-minhash / --device-split-wfa through the API on a CPU
    run (device="cpu": the plain versions of csrc/minhash.cu and
    csrc/ident.cu) give the same blocks as the JAX package's
    break_blocks with the same flag, and split some."""
    from smoothxg_tpu.pipeline.blocks import Blockset as JaxBlockset
    from smoothxg_tpu.pipeline.blocks import \
        smoothable_blocks as jax_smoothable_blocks
    from smoothxg_tpu.pipeline.breaks import break_blocks as jax_break_blocks
    from smoothxg_tpu_torch.pipeline.blocks import Blockset, smoothable_blocks
    from smoothxg_tpu_torch.pipeline.breaks import break_blocks
    idx, jidx, pick = divergent
    sets = []
    for ix, make, find, brk, extra in (
            (idx, Blockset, smoothable_blocks, break_blocks,
             {"device": "cpu"}),
            (jidx, JaxBlockset, jax_smoothable_blocks, jax_break_blocks,
             {})):
        bs = make()
        for n, b in enumerate(find(ix, 700 * 12, 700, 5000, 5000)):
            if n in pick:
                bs.add_block(b)
        sets.append(_partition(brk(ix, bs, **SPLIT_KW, **kw, **{flag: True},
                                   **extra)))
    assert sets[0] == sets[1]
    assert sets[0][0]["split"] > 0


def test_split_device_routes_need_cuda_on_a_gpu_run(divergent, monkeypatch):
    """On a GPU run (the default device) the split routes take their
    kernels: without CUDA they raise "CUDA required", never the host."""
    import torch
    from smoothxg_tpu_torch.pipeline.blocks import smoothable_blocks
    from smoothxg_tpu_torch.pipeline.breaks import break_blocks
    idx, _, _ = divergent
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag, kw in (("device_minhash", MASH_KW), ("device_wfa", {})):
        with pytest.raises(RuntimeError, match="CUDA required"):
            break_blocks(idx, smoothable_blocks(idx, 700 * 12, 700, 5000,
                                                5000),
                         **SPLIT_KW, **kw, **{flag: True})


GUARD = """
import sys
sys.path.insert(0, {repo!r})
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome
d = {tmp!r}
g = write_pangenome(d + "/g.gfa", haplotypes=3, length=1200, seed=2)
for engine in ("fused", "pallas"):
    _, _, eng = run_smoothing(Config(gfa_in=g, smoothed_out=d + "/o.gfa",
        write_msa_in_maf_format=d + "/o.maf", n_haps=3, max_path_jump=5000,
        max_edge_jump=5000, poa_length_targets=[400], threads=1,
        tmp_base=d, engine=engine), device="cpu")
    st = eng.stats()
    assert st.get("device_blocks", st.get("device_tasks")) > 0
print("JAX_LOADED", "jax" in sys.modules)
print("PKG_LOADED", any(m == "smoothxg_tpu" or m.startswith("smoothxg_tpu.")
                        for m in sys.modules))
"""


def test_slice_runs_without_importing_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run(
        [sys.executable, "-c", GUARD.format(repo=REPO, tmp=str(tmp_path))],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "JAX_LOADED False" in res.stdout
    assert "PKG_LOADED False" in res.stdout


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+(jax|smoothxg_tpu)|"
                     r"from\s+(jax|smoothxg_tpu))\b", re.M)
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
