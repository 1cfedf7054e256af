"""ROADMAP C4, the JAX package's int16 score floor.  Its windowed kernel
(smoothxg_tpu/ops/poa_pallas_win.py:_win_core) packs DP scores into int16
halves with the floor NEG16 = -16000 (:51), and poa_pallas_fused.py:58-62
says to revisit that before LW passes ~6k, yet its banded tier aligns
globally at LW 10240.  The port's kernels keep int32 scores.

The block: the most divergent global pair there is, two sequences of n bases
over disjoint alphabets (codes {0, 1} and {2, 3}: no column can match), at a
banded tier that holds it whole (2 n nodes, the band inside the window).
poa_host's fill gives the second sequence the traced score -(2 n + 400),
which first falls below the floor at n = 7801. Through test_torch_poa_win's
`_run`, the Pallas kernel runs in interpret mode and the port's kernel on
its plain version, and both are held to the oracle (FusedPOA, which threads
poa_host's alignments). Finding: at n = 7801 the Pallas kernel still gives
the oracle's graph; at n = 8088 (score -16576) it flags the block (meta
overflow), which FusedPallasEngine redoes on the native engine, so the floor
does not change an output silently here. The port gives the oracle's graph
at both. ~45 s on one worker."""
import numpy as np
import pytest

from smoothxg_tpu.ops import poa_host
from smoothxg_tpu.ops.poa_graph import POAGraph

from test_torch_poa_win import _oracle, _run, _unpack

NEG16 = -16000
RW = 8


def _block(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 2, n).astype(np.int8),
            rng.integers(2, 4, n).astype(np.int8)]


def _traced_score(sq, p):
    """poa_host's score of the second sequence's global alignment to the
    first's graph (the cell align() traces back from)."""
    g = POAGraph()
    g.add_sequence(sq[0].astype(np.uint8), 1)
    seq = sq[1].astype(np.uint8)
    H, _, _, _, row_of, _ = poa_host.fill(g, seq, p)
    sinks = [row_of[v] for v in g.topo_order() if not g.succs[v]]
    return max(int(H[r, len(seq)]) for r in sinks)


def _tier(n, p):
    """(VW, LW, W) in 128-lane units: 2 n nodes, n + 1 columns, and the
    band's 2 w + 1 columns with a window's alignment slack."""
    up = lambda x: -(-x // 128) * 128             # noqa: E731
    return up(2 * n), up(n + 1), up(2 * p.band_w(n) + 128)


def test_smallest_block_below_the_floor():
    p = poa_host.POAParams(1, 4, 6, 2, 26, 1, local=False, wb=311)
    assert _traced_score(_block(7800), p) == NEG16
    assert _traced_score(_block(7801), p) == -16002 < NEG16


@pytest.mark.parametrize("n,pallas_flags", [(7801, False), (8088, True)])
def test_block_below_the_floor_against_the_oracle(n, pallas_flags):
    p = poa_host.POAParams(1, 4, 6, 2, 26, 1, local=False, wb=311)
    sq = _block(n)
    assert _traced_score(sq, p) == -(2 * n + 400) < NEG16
    VW, LW, W = _tier(n, p)
    pal, port = _run([sq], [p], 1, VW, LW, W, RW, False, True)
    want = _oracle(sq, p)
    assert want[0] == [2 * n, 0, 2, 0]
    assert _unpack(port, 0, sq, VW, LW, RW) == want
    got = _unpack(pal, 0, sq, VW, LW, RW)
    if pallas_flags:
        assert got[0][1] == 1                     # redone on the host
    else:
        assert got == want
