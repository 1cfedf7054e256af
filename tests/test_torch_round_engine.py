"""The port's round engine (smoothxg_tpu_torch/ops/poa_round.
TorchRoundPOAEngine) on the CPU, where it runs the kernel's plain version:
against the JAX package's PallasPOAEngine in interpret mode on a seeded
batch, through smooth_blocks' two-wave pipeline, with banded tasks routed
to the oracle, and end to end (`run_smoothing(engine="pallas")`) against
the JAX package's native run and its interpret-mode Pallas run, byte for
byte.  Each package's objects come from its own modules."""
import hashlib

import numpy as np
import pytest

from smoothxg_tpu.ops import poa_host as jax_host
from smoothxg_tpu.ops.poa_pallas import PallasPOAEngine
from smoothxg_tpu.pipeline.run import Config as JaxConfig
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_round import TorchRoundPOAEngine
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome

from test_torch_poa_round import ALPHA, grow, mutate, params


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _batch(seed, local, n=6, banded=False):
    """n seeded (jax task, port task) pairs over graphs of 2-5 sequences."""
    rng = np.random.default_rng(seed)
    pset = (1, 4, 6, 2, 26, 1)
    jt, pt = [], []
    for _ in range(n):
        base = rng.choice(ALPHA, int(rng.integers(50, 160)))
        fam = [base] + [mutate(rng, base, 0.05)
                        for _ in range(int(rng.integers(1, 5)))]
        gj, gp = grow(fam, local)
        q = mutate(rng, base, 0.05)
        pj = jax_host.POAParams(*pset, local=local,
                                wb=311 if banded else -1)
        pp = poa_host.POAParams(*pset, local=local,
                                wb=311 if banded else -1)
        jt.append((gj, q, pj))
        pt.append((gp, q, pp))
    return jt, pt


@pytest.mark.parametrize("local", [True, False])
def test_align_batch_equals_interpret_pallas_engine(local):
    jt, pt = _batch(40 + local, local)
    port = TorchRoundPOAEngine(device="cpu", max_batch=4)
    got = port.align_batch(pt)
    want = PallasPOAEngine(interpret=True).align_batch(jt)
    assert got == want
    assert got == [jax_host.align(*t) for t in jt]
    st = port.stats()
    assert st["device_tasks"] == 6 and st["calls"] == 2
    assert st["fallbacks"] == 0 and st["stuck_fallbacks"] == 0
    assert st["kernel_launches"] == 0          # no launch on the CPU


def test_banded_tasks_go_to_the_oracle_and_are_counted():
    """A banded task (abPOA params, as the long-block policy makes for
    blocks past --long-poa-band) never reaches the kernel, which has no
    band."""
    jt, pt = _batch(7, False, n=3, banded=True)
    eng = TorchRoundPOAEngine(device="cpu")
    got = eng.align_batch(pt)
    assert got == [jax_host.align(*t) for t in jt]
    st = eng.stats()
    assert st["fallback_reasons"] == {"band": 3}
    assert st["fallbacks"] == 3 and st["device_tasks"] == 0
    assert st["calls"] == 0


def test_interpret_pallas_engine_ignores_the_band_the_port_keeps():
    """ROADMAP C7 on one banded task (abPOA's wb = 311, as the long-block
    policy sets it): the JAX package's PallasPOAEngine passes no band to
    its kernel (poa_pallas.py:533-559, :636), so in interpret mode it
    returns the unbanded alignment, not poa_host.align's banded one.  The
    port's round engine sends the task to the oracle and gives the banded
    alignment.  The query carries an insertion and a deletion of 400
    bases, so its length equals the graph's depth and the unbanded path
    leaves the band (half-width 347)."""
    rng = np.random.default_rng(11)
    n, shift = 1200, 400
    base = rng.choice(ALPHA, n)
    gj, gp = grow([base, mutate(rng, base, 0.02)], False)
    a, b = n // 4, n // 2
    q = np.concatenate([base[:a], rng.choice(ALPHA, shift), base[a:b],
                        base[b + shift:]]).astype(np.uint8)
    pset = (1, 4, 6, 2, 26, 1)
    pj = jax_host.POAParams(*pset, local=False, wb=311)
    pp = poa_host.POAParams(*pset, local=False, wb=311)
    assert len(q) == n and pp.band_w(n) < shift
    banded = jax_host.align(gj, q, pj)
    unbanded = jax_host.align(gj, q, jax_host.POAParams(*pset, local=False))
    assert banded != unbanded
    pallas = PallasPOAEngine(interpret=True).align_batch([(gj, q, pj)])[0]
    assert pallas == unbanded != banded          # the reference diverges
    eng = TorchRoundPOAEngine(device="cpu")
    assert eng.align_batch([(gp, q, pp)]) == [poa_host.align(gp, q, pp)] \
        == [banded]
    assert eng.stats()["fallback_reasons"] == {"band": 1}


def test_long_sequence_runs_on_the_kernel():
    """A sequence past the Pallas packing (L + 2 >= 2^15), which the JAX
    engine sends to the host, stays on the kernel's route."""
    rng = np.random.default_rng(12)
    gj, gp = grow([rng.choice(ALPHA, 30)], True)
    q = rng.choice(ALPHA, 1 << 15)
    pj, pp = params(True)
    eng = TorchRoundPOAEngine(device="cpu")
    assert eng.align_batch([(gp, q, pp)]) == [jax_host.align(gj, q, pj)]
    st = eng.stats()
    assert st["device_tasks"] == 1 and st["fallbacks"] == 0
    assert st["stuck_fallbacks"] == 0


def test_stats_keys_extend_the_pallas_engine():
    eng = TorchRoundPOAEngine(device="cpu")
    assert set(eng.stats()) == \
        set(PallasPOAEngine(interpret=True).stats()) | {"kernel_launches"}


def test_cuda_engine_refuses_to_run_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        TorchRoundPOAEngine(device="cuda")


def test_two_wave_pipeline_keeps_every_path_sequence(tmp_path):
    """max_batch=2 sends smooth_blocks down its two-wave path (a round of
    one wave on the device while the host updates the other); every
    block graph must spell its path ranges."""
    from smoothxg_tpu_torch.graph.index import FlatIndex
    from smoothxg_tpu_torch.io.gfa import read_gfa
    from smoothxg_tpu_torch.pipeline.blocks import smoothable_blocks
    from smoothxg_tpu_torch.pipeline.smooth import smooth_blocks

    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=3,
                          length=900, seed=3)
    idx = FlatIndex(read_gfa(gfa).compact())
    bs = smoothable_blocks(idx, 3 * 120, 120, 5000, 5000)
    assert len(bs) >= 4
    eng = TorchRoundPOAEngine(device="cpu", max_batch=2)
    results = smooth_blocks(idx, bs, params=poa_host.POAParams(local=True),
                            engine=eng)
    assert eng.stats()["device_tasks"] > 0
    for res, blk in zip(results, bs):
        for ri, pr in enumerate(blk.path_ranges):
            assert res.graph.path_seq(ri) == \
                idx.range_seq(pr.pid, pr.begin, pr.end)


def _cfg(config, gfa, tmp, tag, engine, **kw):
    return config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
                  write_msa_in_maf_format=str(tmp / f"{tag}.maf"),
                  max_path_jump=5000, max_edge_jump=5000, threads=1,
                  add_consensus=True, tmp_base=str(tmp), engine=engine,
                  **kw)


@pytest.mark.parametrize("band", [4096, 1100])
def test_pallas_slice_matches_native_bytes(tmp_path, band):
    """-r 4 -j 5k -e 5k -l 700 -t 1 on a 4 x 2 kb pangenome, with
    consensus and MAF; with --long-poa-band 1100 the longer blocks align
    banded, which the engine sends to the oracle."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=2000, seed=7)
    kw = dict(n_haps=4, poa_length_targets=[700], long_poa_band=band)
    _, _, eng = run_smoothing(_cfg(Config, gfa, tmp_path, "port", "pallas",
                                   **kw), device="cpu")
    jax_pkg_run(_cfg(JaxConfig, gfa, tmp_path, "native", "native", **kw))
    st = eng.stats()
    assert st["device_tasks"] > 0 and st["stuck_fallbacks"] == 0
    assert (st["fallback_reasons"]["band"] > 0) == (band < 4096)
    assert st["fallbacks"] == st["fallback_reasons"]["band"]
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


def test_pallas_slice_matches_interpret_pallas_run(tmp_path):
    """3 x 1.2 kb against the JAX package's run with a
    PallasPOAEngine(interpret=True) instance."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=3,
                          length=1200, seed=2)
    kw = dict(n_haps=3, poa_length_targets=[400])
    _, _, eng = run_smoothing(_cfg(Config, gfa, tmp_path, "port", "pallas",
                                   **kw), device="cpu")
    jax_pkg_run(_cfg(JaxConfig, gfa, tmp_path, "pal",
                     PallasPOAEngine(interpret=True, max_batch=4), **kw))
    st = eng.stats()
    assert st["device_tasks"] > 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"pal.{ext}")
