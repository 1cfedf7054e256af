"""The port's block engine (smoothxg_tpu_torch/ops/poa_engine.TorchPOAEngine)
on the CPU against the numpy oracle FusedPOA and the JAX package's
FusedPallasEngine in interpret mode, on the random and degenerate blocks of
test_engine_fuzz, plus the native redo and fallback routes.  Graphs must be
equal: bases, per-sequence paths, topological order and
aligned groups (integers, no tolerance)."""
import functools

import numpy as np
import pytest

from smoothxg_tpu.ops.poa_fused import FusedPOA
from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import FusedPallasEngine
from smoothxg_tpu.utils.dna import encode_seq
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine

from test_engine_fuzz import _params, _random_block

DEGENERATE = (["ACGT"], ["ACGTACGTAA", "ACGTACGTAA"], ["A", "A"],
              ["AC", "AG", "AT"])


def _oracle(seqs, p):
    f = FusedPOA()
    for s in seqs:
        f.add_sequence(s, p)
    return f


def _same_graph(g, f):
    assert g.base == f.base
    assert g.seq_paths == f.paths
    assert g._topo == f.topo_order()


@functools.lru_cache(maxsize=None)
def _fuzz_results():
    """Every fuzz and degenerate block through both engines, one batch
    each (one launch per kernel variant)."""
    blocks = []
    for seed in range(12):
        rng = np.random.default_rng(1000 + seed)
        seqs = _random_block(rng)
        p = _params(rng)
        blocks.append(([encode_seq(s) for s in seqs], [1] * len(seqs), p))
    for seqs in DEGENERATE:
        for p in (POAParams(local=True), POAParams(local=False, wb=311)):
            blocks.append(([encode_seq(s) for s in seqs], [1] * len(seqs),
                           p))
    port = TorchPOAEngine(device="cpu", tiers=((1024, 256, 256),),
                          max_seqs=16)
    pallas = FusedPallasEngine(shape=(512, 256), max_seqs=16, max_batch=4,
                               interpret=True)
    return (blocks, port.poa_block_batch(blocks),
            pallas.poa_block_batch(blocks), port.stats())


@pytest.mark.parametrize("seed", range(12))
def test_engine_matches_oracle_and_pallas_on_random_blocks(seed):
    blocks, got, pal, _ = _fuzz_results()
    seqs, _, p = blocks[seed]
    g = got[seed]
    _same_graph(g, _oracle(seqs, p))
    assert g.base == pal[seed].base
    assert g.seq_paths == pal[seed].seq_paths
    assert g._topo == pal[seed]._topo
    assert g.group == pal[seed].group


def test_engine_matches_oracle_on_degenerate_blocks():
    blocks, got, pal, stats = _fuzz_results()
    for k in range(12, len(blocks)):
        seqs, _, p = blocks[k]
        _same_graph(got[k], _oracle(seqs, p))
        assert got[k].seq_paths == pal[k].seq_paths
    # every block ran the plain version of the kernel; no launch on CPU
    assert stats["device_blocks"] == len(blocks)
    assert stats["fallbacks"] == 0 and stats["redo"] == 0
    assert stats["kernel_launches"] == 0


def test_overflow_redo_and_fallback_are_native_and_counted():
    """A node with more than 4 predecessors overflows the kernel and is
    redone on the native engine; a block with more sequences than the
    engine takes never reaches the kernel.  Both give oracle graphs."""
    fan_in = [encode_seq("AAAA" + x + "CCCC") for x in "ACGTNR"]
    p = POAParams(local=False)
    many = [encode_seq("ACGTTGCA")] * 7
    eng = TorchPOAEngine(device="cpu", tiers=((512, 256, 256),),
                         max_seqs=6)
    blocks = [(fan_in, [1] * 6, p), (many, [1] * 7, p)]
    graphs = eng.poa_block_batch(blocks)
    for (sq, _, pp), g in zip(blocks, graphs):
        _same_graph(g, _oracle(sq, pp))
    st = eng.stats()
    assert st["redo"] == 1 and st["fallbacks"] == 1
    assert st["device_blocks"] == 0 and st["calls"] == 1


def test_stats_keys_extend_the_pallas_engine():
    pal = FusedPallasEngine(shape=(512, 256), max_seqs=16, max_batch=4,
                            interpret=True)
    eng = TorchPOAEngine(device="cpu")
    assert set(eng.stats()) == set(pal.stats()) | {"kernel_launches"}


def test_cuda_engine_refuses_to_run_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        TorchPOAEngine(device="cuda")
