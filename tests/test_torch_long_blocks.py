"""Long blocks (the CLI's default -l 4000: ranges cut at 2 x 4000 bp and
padded by 311 a side, so sequences of up to 8,622 bp) through the port's
block engine on the CPU.  The tier table is the card's: two full-width
tiers (8704, 8704) and (VW_MAX, 8704) take what the TPU's VMEM sent to the
host pool, full-width blocks past 4,095 bp and banded blocks whose window
passes the windowed tier's 3,072 columns.  Held here: where blocks of ~4.6
kb route (and that blocks of -l 700,900,1100's shapes keep the tier they
took under the TPU's table), a launch's size at the new tiers against the
budget, one long block through the engine's plain version against the JAX
package's native engine, and, on a reduced copy of the new tier (VW = LW
= W), poa_win's plain version against the Pallas kernel in interpret mode.
Integers throughout: no tolerance."""
import functools

import numpy as np
import pytest

from smoothxg_tpu.ops.poa_host import POAParams as JaxParams
from smoothxg_tpu.ops.poa_native import NativePOAEngine as JaxNative
from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_win import VW_MAX, stride_for
from smoothxg_tpu_torch.testing.synth import make_block, make_population_block

from test_poa_pallas_win import codes
from test_torch_poa_win import _oracle, _run, _unpack

# the tier table before it was re-derived for the card (the TPU's)
TPU_TIERS = ((4352, 2048, 2048), (8704, 2048, 2048), (6144, 3072, 3072),
             (8704, 4096, 4096), (8704, 10240, 3072))
LONG = (8704, 8704, 8704)
DEEP = (VW_MAX, 8704, 8704)
LOCAL = POAParams(local=True)
# the long-block policy's params (pipeline/smooth.py): global, abPOA band
BANDED = POAParams(local=False, wb=311, wf_milli=30)


def engine(**kw) -> TorchPOAEngine:
    return TorchPOAEngine(device="cpu", **kw)


def spread(rng, n: int, short: int) -> list:
    """n population sequences of ~4.6 kb, every fifth cut to `short`
    bases: the length spread of a block whose window passes 3,072."""
    sq = make_population_block(rng, 4600, n, 0.01)
    return [s[:short] if r % 5 == 4 else s for r, s in enumerate(sq)]


# (case, sequences, params, the tier it takes), 16 sequences of ~4.6 kb
# unless named otherwise
LONG_CASES = {
    "full width": (lambda r: make_block(r, 4600, 16, 0.01), LOCAL, LONG),
    "banded, narrow window": (
        lambda r: make_population_block(r, 4600, 16, 0.01), BANDED,
        (8704, 10240, 3072)),
    "banded, 3.4 kb spread": (lambda r: spread(r, 16, 1200), BANDED, LONG),
    "full width, 90 deep": (
        lambda r: make_population_block(r, 4600, 90, 0.01), LOCAL, DEEP),
}


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_long_blocks_route_to_a_tier(case):
    """Each long block routes to the smallest tier that holds it; under
    the TPU's table the full-width and wide-window ones went native.  The
    90-deep block's growth estimate (it overcounts deep blocks) passes
    VW 8704 and takes the VW_MAX tier."""
    make, p, tier = LONG_CASES[case]
    sq = make(np.random.default_rng(17))
    eng = engine()
    assert eng.tiers[eng._route(sq, p)] == tier
    if tier in TPU_TIERS:
        assert engine(tiers=TPU_TIERS)._route(sq, p) == eng._route(sq, p)
    else:
        assert engine(tiers=TPU_TIERS)._route(sq, p) is None


@pytest.mark.parametrize("case", ["past LW", "past VW_MAX"])
def test_a_block_past_the_largest_tier_goes_native(case):
    """A sequence of 8,704 bases fits no tier (LW - 1 = 8,703 is the
    longest); a block whose growth estimate passes VW_MAX neither (counted
    as a predicted overflow)."""
    rng = np.random.default_rng(5)
    eng = engine()
    if case == "past LW":
        sq = make_block(rng, 8704, 4, 0.01)
        assert max(map(len, sq)) >= 8704
    else:
        sq = make_block(rng, 4600, 16, 0.3)
    assert eng._route(sq, LOCAL) is None
    assert eng.predicted_overflow == (case == "past VW_MAX")


# blocks of -l 700,900,1100's shapes (ranges to 2 x 1100 bp, padded by 311
# a side) and the longer ones the TPU's table took: (length, sequences,
# divergence), each local and banded
SHORT_CASES = [(900, 16, 0.01), (1000, 16, 0.06), (1100, 16, 0.1),
               (1700, 12, 0.02), (2100, 14, 0.01), (2800, 8, 0.01),
               (3500, 8, 0.01), (4500, 16, 0.01)]


@pytest.mark.parametrize("p", [LOCAL, BANDED], ids=["local", "banded"])
@pytest.mark.parametrize("shape", SHORT_CASES)
def test_blocks_the_tpu_table_held_keep_their_tier(shape, p):
    """Every block the TPU's table routed to a tier takes the same tier
    index under the card's table (its first five tiers are the TPU's, in
    the same order); the full-width 4.5 kb block, which the TPU sent to
    the host, is the one that moves."""
    length, n, div = shape
    sq = make_block(np.random.default_rng(length + n), length, n, div)
    old = engine(tiers=TPU_TIERS)._route(sq, p)
    new = engine()._route(sq, p)
    if old is None:
        assert (length, p) == (4500, LOCAL)
        assert engine().tiers[new] == LONG
    else:
        assert new == old


@pytest.mark.parametrize("depth", [16, 90])
@pytest.mark.parametrize("tier", [LONG, DEEP])
@pytest.mark.parametrize("banded", [False, True])
def test_tier_batch_at_the_new_tiers_stays_in_the_budget(tier, banded,
                                                         depth):
    """A launch at a new tier holds at least one block and its blocks'
    DP scratch and sequence and path planes stay within SCRATCH_BUDGET,
    at the default run's longest sequence (4,619 bp) and at the longest a
    tier holds, 16 and 90 sequences deep."""
    eng = engine()
    ti = eng.tiers.index(tier)
    VW, LW, W = tier
    for maxlen in (4619, LW - 1):
        n = eng._tier_batch(ti, banded, maxlen, depth)
        words = eng._kernel(VW, LW, W, True, banded)[2](
            stride_for(maxlen, LW))
        assert n >= 1
        assert n * (4 * words + eng.PLANE_BYTES * depth * LW) \
            <= eng.SCRATCH_BUDGET
    # the default run's 21 full-width blocks fit one launch of (8704, 8704)
    if (tier, banded) == (LONG, False):
        assert eng._tier_batch(ti, False, 4619, depth) >= 22


@functools.lru_cache(maxsize=None)
def small_long_block() -> list:
    """Three sequences of ~4.6 kb: a full-width block past the TPU's 4,095
    bp, small enough for the plain version."""
    return make_block(np.random.default_rng(46), 4600, 3, 0.01)


def test_long_block_on_the_new_tier_equals_the_jax_native_engine():
    """The engine's plain version takes a long full-width block at
    (8704, 8704) and builds the graph of the JAX package's native engine
    (the engine the JAX package runs such blocks on): bases, edges and
    paths equal."""
    sq = small_long_block()
    eng = engine()
    assert eng.tiers[eng._route(sq, LOCAL)] == LONG
    got = eng.poa_block_batch([(sq, [1] * len(sq), LOCAL)])[0]
    want = JaxNative().poa_block_batch(
        [(sq, [1] * len(sq), JaxParams(local=True))])[0]
    assert eng.stats()["device_blocks"] == 1
    assert eng.stats()["tier_blocks"]["V8704xL8704"] == 1
    assert got.base == want.base
    assert got.seq_paths == want.seq_paths
    assert got._topo == want._topo

    def edges(g):
        return {(u, v) for pth in g.seq_paths for u, v in zip(pth, pth[1:])}
    assert edges(got) == edges(want)


# a reduced copy of the new tier: VW = LW = W, as (8704, 8704, 8704)
SMALL_TIER = (384, 384, 384)


@pytest.mark.parametrize("p", [LOCAL, BANDED], ids=["local", "banded"])
def test_reduced_new_tier_equals_pallas_interpret(p):
    """poa_win's plain version at a reduced copy of the new tier equals
    the Pallas kernel _win_core (interpret mode) and the numpy oracle on a
    block that nearly fills its LW: full width, and banded with its
    window at full width (W = LW: a banded block whose band passes the
    windowed tier's window runs so at (8704, 8704))."""
    jp = JaxParams(local=p.local, wb=p.wb, wf_milli=p.wf_milli)
    rng = np.random.default_rng(384)
    sq = make_block(rng, 340, 4, 0.02)
    sq[3] = sq[3][:120]
    blocks = [[codes(s.tobytes().decode()) for s in sq]]   # 0-3 codes
    VW, LW, W = SMALL_TIER
    pal, port = _run(blocks, [jp], 1, VW, LW, W, 8, p.local, p.wb >= 0)
    got = _unpack(port, 0, blocks[0], VW, LW, 8)
    assert got[0][1] == 0
    assert got == _unpack(pal, 0, blocks[0], VW, LW, 8)
    assert got == _oracle(blocks[0], jp)
