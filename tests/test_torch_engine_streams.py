"""The block engine's launch plan and its redo on the card
(smoothxg_tpu_torch/ops/poa_engine.TorchPOAEngine), on the CPU: a call's
chunks start longest block first across tiers, each on a lane (a stream a
device) of its own while the lanes' bytes stay within INFLIGHT_BUDGET; a
block whose launch at a windowed tier overflows its band is launched again
at the next full-width tier that holds it (here through the kernel's plain
version), and only a block no tier holds goes to the native engine.
Graphs are held to the JAX package's native engine: integers, no
tolerance."""
import numpy as np
import pytest

from smoothxg_tpu.ops.poa_host import POAParams as JaxParams
from smoothxg_tpu.ops.poa_native import NativePOAEngine as JaxNative
from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_win import VW_MAX

GIB = 1 << 30
S = TorchPOAEngine.SCRATCH_BUDGET


def held(sizes, lanes) -> list:
    """Each lane's bytes under a plan: the most of its chunks' (a lane's
    stream reuses its chunks' freed scratch, one chunk after another)."""
    out = [0] * (max(lanes) + 1)
    for b, k in zip(sizes, lanes):
        out[k] = max(out[k], b)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_plan_never_passes_the_inflight_budget(seed):
    """Chunks of at most SCRATCH_BUDGET (what _tier_batch and seq_cap
    allow), in seeded orders and mixes of small, middling and full ones:
    the lanes' bytes at once never pass INFLIGHT_BUDGET, at every step of
    the plan."""
    rng = np.random.default_rng(seed)
    eng = TorchPOAEngine(device="cpu")
    for _ in range(200):
        top = int(rng.choice([S // 64, S // 3, S]))
        sizes = [int(x) for x in
                 rng.integers(1, top + 1, int(rng.integers(1, 25)))]
        lanes = eng._plan_lanes(sizes)
        assert len(lanes) == len(sizes) and lanes[0] == 0
        for n in range(1, len(sizes) + 1):
            assert sum(held(sizes[:n], lanes[:n])) <= eng.INFLIGHT_BUDGET
        # lanes are opened in order
        assert sorted(set(lanes)) == list(range(max(lanes) + 1))


def test_budget_is_two_full_launches():
    eng = TorchPOAEngine(device="cpu")
    assert eng.INFLIGHT_BUDGET == 2 * S == 48 * GIB
    # two full launches run at once, a third waits for one of them
    assert eng._plan_lanes([S, S, S]) == [0, 1, 0]
    # the default -l 4000 at 90 haplotypes: 17 blocks at (8704, 8704) and
    # 4 at (VW_MAX, 8704), LS 4640, 90 deep: each its own lane
    long, deep = (eng.tiers.index(t) for t in ((8704, 8704, 8704),
                                               (VW_MAX, 8704, 8704)))
    sizes = [17 * eng._block_bytes(long, False, 4619, 90),
             4 * eng._block_bytes(deep, False, 4619, 90)]
    assert eng._plan_lanes(sizes) == [0, 1]
    # -l 700,900,1100's small launches share the card too
    small = [eng._block_bytes(0, False, 1100, 16) * 40] * 6
    assert eng._plan_lanes(small) == list(range(6))


def _bubble_block(rng):
    """Three sequences: A X B, then A B twice (X 200 bases): the second
    round aligns A B against a graph whose rows past X have ranks 200
    apart (the rank band's spread) and whose longest rank is 200 past its
    length, so the kernel's band is ~2 w + 401 columns while the route's
    window rule (2 bw + spread + 1) counts ~2 bw + 201."""
    a, x, b = (rng.integers(0, 4, n) for n in (150, 200, 150))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[np.concatenate(s)] for s in ((a, x, b), (a, b), (a, b))]


BANDED = POAParams(local=False, wb=10, wf_milli=0)
NARROW = (1024, 640, 280)   # windowed: the route's window fits, the band not
FULL = (1024, 640, 640)


def _native(sq):
    return JaxNative().poa_block_batch(
        [(sq, [1] * len(sq), JaxParams(local=False, wb=10, wf_milli=0))])[0]


def _same(got, want):
    assert got.base == want.base
    assert got.seq_paths == want.seq_paths
    assert got._topo == want._topo


def test_band_overflow_is_redone_at_the_next_full_width_tier():
    """The block routes to the narrow windowed tier, its launch there sets
    the overflow flag (the band passes 280 columns), and it runs again at
    the full-width tier after it, on the kernel's plain version: counted as
    a device redo, never on the native engine; its graph is native's."""
    sq = _bubble_block(np.random.default_rng(7))
    eng = TorchPOAEngine(device="cpu", tiers=(NARROW, FULL))
    assert eng._route(sq, BANDED) == 0
    seen = []
    launch = eng._launch

    def spy(blocks, chunk, ti, local, banded, lane=None):
        seen.append((ti, banded))
        return launch(blocks, chunk, ti, local, banded, lane)

    eng._launch = spy
    out = list(eng.poa_block_batch_iter([(sq, [1] * 3, BANDED)]))
    assert [kind for _, kind, _ in out] == ["raw"]
    assert seen == [(0, True), (1, True)]
    st_ = eng.stats()
    assert (st_["device_redo"], st_["redo"], st_["fallbacks"]) == (1, 0, 0)
    assert st_["device_blocks"] == 1
    assert st_["tier_blocks"] == {"V1024xL640xW280": 1, "V1024xL640": 1}
    eng2 = TorchPOAEngine(device="cpu", tiers=(NARROW, FULL))
    _same(eng2.poa_block_batch([(sq, [1] * 3, BANDED)])[0], _native(sq))


def test_overflow_no_tier_holds_goes_native():
    """With no full-width tier after the windowed one, the overflowed
    block is redone on the native engine, counted as `redo`."""
    sq = _bubble_block(np.random.default_rng(7))
    eng = TorchPOAEngine(device="cpu", tiers=(NARROW,))
    g = eng.poa_block_batch([(sq, [1] * 3, BANDED)])[0]
    _same(g, _native(sq))
    st_ = eng.stats()
    assert (st_["device_redo"], st_["redo"], st_["device_blocks"]) == \
        (0, 1, 0)


@pytest.mark.parametrize("seed", [1, 2])
def test_chunks_start_longest_block_first_across_tiers(seed):
    """A call's chunks launch in the order of their longest block's DP
    rows, whatever their tier; each block comes back once, on the
    kernel."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    p = POAParams(local=True)

    def block(n, L):
        s = acgt[rng.integers(0, 4, L)]
        return [s.copy() for _ in range(n)]

    # (sequences, length): small tier, then larger ones, mixed
    shapes = [(2, 40), (4, 150), (3, 40), (2, 150), (5, 30)]
    blocks = [(block(n, L), [1] * n, p) for n, L in shapes]
    eng = TorchPOAEngine(device="cpu", max_batch=2,
                         tiers=((64, 64, 64), (256, 256, 256)))
    order = []
    launch = eng._launch

    def spy(blks, chunk, ti, local, banded, lane=None):
        order.append(max(len(blks[i][0][0]) * (len(blks[i][0]) - 1)
                         for i in chunk))
        return launch(blks, chunk, ti, local, banded, lane)

    eng._launch = spy
    got = sorted(i for i, kind, _ in eng.poa_block_batch_iter(blocks))
    assert got == list(range(len(blocks)))
    assert order == sorted(order, reverse=True)
    assert eng.stats()["device_blocks"] == len(blocks)
