"""The port's block engine with `shape` (smoothxg_tpu_torch/ops/poa_engine.
TorchPOAEngine over ops/poa_code, one full-width tier) on the CPU against
FusedPallasEngine(shape=...) in interpret mode (its unwindowed kernel
_pallas_core) and the oracle FusedPOA, on the random and degenerate blocks
of test_torch_engine; a 6-way fan-in that stays on the kernel (8
predecessor slots); and batches sized from the launch's row stride.
Graphs must be equal: bases, paths, topological order, groups."""
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


@functools.lru_cache(maxsize=None)
def _engine_results():
    """Every fuzz and degenerate block of test_torch_engine through the
    port's engine with `shape` and the Pallas engine with `shape` (the
    unwindowed kernel _pallas_core), one batch each."""
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
    port = TorchPOAEngine(device="cpu", shape=(512, 256), max_seqs=16)
    pallas = FusedPallasEngine(shape=(512, 256), max_seqs=16, max_batch=4,
                               interpret=True)
    return (blocks, port.poa_block_batch(port_blocks(blocks)),
            pallas.poa_block_batch(blocks), port.stats())


@pytest.mark.parametrize("k", range(12 + 2 * len(DEGENERATE)))
def test_engine_shape_matches_pallas_and_oracle(k):
    blocks, got, pal, _ = _engine_results()
    seqs, _, p = blocks[k]
    g = got[k]
    _same_graph(g, _oracle(seqs, p))
    assert g.base == pal[k].base
    assert g.seq_paths == pal[k].seq_paths
    assert g._topo == pal[k]._topo
    assert g.group == pal[k].group


def test_engine_shape_runs_every_block_on_its_one_tier():
    blocks, _, _, stats = _engine_results()
    eng = TorchPOAEngine(device="cpu", shape=(512, 256))
    assert eng.kernel == "code" and eng.tiers == ((512, 256, 256),)
    assert stats["device_blocks"] == len(blocks)
    assert stats["fallbacks"] == 0 and stats["redo"] == 0
    assert stats["tier_blocks"] == {"V512xL256": len(blocks)}
    assert stats["kernel_launches"] == 0       # plain version on the CPU


def test_fan_in_of_six_stays_on_the_kernel():
    """8 predecessor slots: a node of in-degree 6 needs no native redo."""
    rng = np.random.default_rng(13)
    sq = make_fan_in_block(rng, 6, 40)
    p = POAParams(local=False)
    eng = TorchPOAEngine(device="cpu", shape=(512, 256), max_seqs=8)
    g = eng.poa_block_batch([(sq, [1] * 6, PortParams(local=False))])[0]
    _same_graph(g, _oracle(sq, p))
    st = eng.stats()
    assert st["redo"] == 0 and st["device_blocks"] == 1
    assert max(len(x) for x in g.preds) == 6


def test_batch_is_sized_from_the_row_stride():
    """At the main path's tier a launch holds 45 full-width blocks but 164
    of ~1.1 kb: the main path's 308 blocks in 3 iterations take 3
    launches, not 8."""
    eng = TorchPOAEngine(device="cpu", shape=(8704, 4096))
    assert eng._tier_batch(0, False, 4095) == 45
    assert eng._tier_batch(0, False, 1100) == 164


def test_short_blocks_share_a_launch_with_the_same_graphs():
    """A scratch budget that holds two full-width blocks holds all six
    short ones at their row stride: one launch, oracle graphs."""
    rng = np.random.default_rng(17)
    p = POAParams(local=True)
    seqs = [make_block(rng, int(rng.integers(20, 28)), 3, 0.05)
            for _ in range(6)]
    eng = TorchPOAEngine(device="cpu", shape=(512, 256))
    eng.SCRATCH_BUDGET = 2 * 4 * eng._kernel(512, 256, 256, True,
                                             False)[2](256)
    assert eng._tier_batch(0, False, 255) == 2
    got = eng.poa_block_batch([(sq, [1] * 3, PortParams(local=True))
                               for sq in seqs])
    assert eng.stats()["calls"] == 1
    for g, sq in zip(got, seqs):
        _same_graph(g, _oracle(sq, p))
