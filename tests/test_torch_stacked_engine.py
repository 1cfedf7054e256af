"""The port's block engine with kernel="stacked"
(smoothxg_tpu_torch/ops/poa_engine.TorchPOAEngine over ops/poa_stacked) on
the CPU against FusedPallasEngine(kernel="stacked") in interpret mode, whose
tiers are given so that interpret mode does not take its legacy kernel,
and the oracle FusedPOA, on the random and degenerate blocks of
test_torch_engine; the native redo of a 6-way fan-in (4 predecessor
slots); and batches sized from the launch's row stride.  Graphs must be
equal: bases, paths, topological order, groups."""
import functools

import numpy as np
import pytest

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import FusedPallasEngine
from smoothxg_tpu.utils.dna import encode_seq
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_host import POAParams as PortParams
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

from test_engine_fuzz import _params, _random_block
from test_torch_engine import (DEGENERATE, _oracle, _same_graph,
                               port_blocks)

K = 2


@functools.lru_cache(maxsize=None)
def _engine_results():
    blocks = []
    for seed in range(12):
        rng = np.random.default_rng(1000 + seed)
        seqs = _random_block(rng)
        blocks.append(([encode_seq(s) for s in seqs], [1] * len(seqs),
                       _params(rng)))
    for seqs in DEGENERATE:
        for p in (POAParams(local=True), POAParams(local=False, wb=311)):
            blocks.append(([encode_seq(s) for s in seqs], [1] * len(seqs),
                           p))
    port = TorchPOAEngine(device="cpu", kernel="stacked",
                          tiers=((512, 256, 256),), max_seqs=16)
    pallas = FusedPallasEngine(tiers=((K, 512, 256, 256),), max_seqs=16,
                               max_batch=4, interpret=True, kernel="stacked")
    return (blocks, port.poa_block_batch(port_blocks(blocks)),
            pallas.poa_block_batch(blocks), port.stats())


@pytest.mark.parametrize("k", range(12 + 2 * len(DEGENERATE)))
def test_engine_stacked_matches_pallas_and_oracle(k):
    blocks, got, pal, _ = _engine_results()
    seqs, _, p = blocks[k]
    g = got[k]
    _same_graph(g, _oracle(seqs, p))
    assert g.base == pal[k].base
    assert g.seq_paths == pal[k].seq_paths
    assert g._topo == pal[k]._topo
    assert g.group == pal[k].group


def test_engine_stacked_counts():
    blocks, _, _, stats = _engine_results()
    assert stats["device_blocks"] + stats["redo"] == len(blocks)
    assert stats["fallbacks"] == 0
    assert stats["kernel_launches"] == 0       # plain version on the CPU


def test_fan_in_of_six_is_redone_natively():
    """4 predecessor slots: a node of in-degree 6 overflows the kernel and
    the block is redone on the native engine, counted."""
    rng = np.random.default_rng(13)
    sq = make_fan_in_block(rng, 6, 40)
    eng = TorchPOAEngine(device="cpu", kernel="stacked",
                         tiers=((512, 256, 256),), max_seqs=8)
    g = eng.poa_block_batch([(sq, [1] * 6, PortParams(local=False))])[0]
    _same_graph(g, _oracle(sq, POAParams(local=False)))
    st = eng.stats()
    assert st["redo"] == 1 and st["device_blocks"] == 0


def test_batch_is_sized_from_the_row_stride():
    """At the (4352, 2048) tier a launch holds 206 full-width blocks but
    366 of ~1.1 kb; up to 1,056 (8 a thread block) where they fit."""
    eng = TorchPOAEngine(device="cpu", kernel="stacked")
    assert eng._tier_batch(0, False, 2047) == 206
    assert eng._tier_batch(0, False, 1100) == 366
    small = TorchPOAEngine(device="cpu", kernel="stacked",
                           tiers=((512, 256, 256),))
    assert small._tier_batch(0, False, 100) == 1056


def test_short_blocks_share_a_launch_with_the_same_graphs():
    """A scratch budget that holds four full-width blocks holds all six
    short ones at their row stride (128 for this kernel's lane-major
    rows): one launch, oracle graphs."""
    rng = np.random.default_rng(19)
    seqs = [make_block(rng, int(rng.integers(20, 28)), 3, 0.05)
            for _ in range(6)]
    eng = TorchPOAEngine(device="cpu", kernel="stacked",
                         tiers=((512, 256, 256),))
    eng.SCRATCH_BUDGET = 4 * 4 * eng._kernel(512, 256, 256, False,
                                             False)[2](256)
    assert eng._tier_batch(0, False, 255) == 4
    got = eng.poa_block_batch([(sq, [1] * 3, PortParams(local=False))
                               for sq in seqs])
    assert eng.stats()["calls"] == 1
    for g, sq in zip(got, seqs):
        _same_graph(g, _oracle(sq, POAParams(local=False)))
