"""The POA fill's int32 operations, and the least time the card could take
for them: the yardstick of `poa_win_roofline` and `window_mfu`.

`OPS_CELL`, `OPS_PRED` and `fill_ops` are frozen copies of
`chip_smoke.py`'s arithmetic (as of the port's first benchmark).  The
operations a DP cell needs, by the fill recurrence (the function's count,
not a kernel's instruction count):
  substitution (compare, select, add)                    3
  E1 and E2 (open, extend, max, floor at NEG)            4 + 4
  Hq = max(M, E1, E2)                                    2
  F1 and F2: F(j) = max(F(j-1) - ext, Hq(j-1) - open)    3 + 3
  H = max(Hq, F1, F2)                                    2
  local only: Hq floored at 0, the row maximum           1 + 1
= 23 local, 21 global; plus 3 per cell for each predecessor row past the
first.  The graph work around the fill (topological walk, traceback) is
O(V + L) an alignment and not counted, so the bound is a lower one.

`block_work` counts what `chip_smoke.py:win_dp_work` counts from the
engine's paths, but from what a job's MAF shows of a block: round r aligns
unique row r, padded, against the graph of rows 0..r-1.  The MAF
leaves the padding out, so the padding's nodes are counted as the first
row's 2 x pad and no more, and the count stays a lower bound.  A banded
block (smoothxg's -A semantics, src/smooth.cpp:258-290: wb 311, wf 0.03)
counts only the cells of each row's band, a node's rank taken as its
column past the left padding.
"""
from __future__ import annotations

import numpy as np

OPS_CELL = {True: 23, False: 21}     # by local
OPS_PRED = 3
SM_LANES = 128                       # lanes an SM runs a clock, assumed
GAP = ord("-")


def fill_ops(cells: int, pcells: int, local: bool) -> int:
    """int32 operations of a fill of `cells` DP cells with `pcells` cells
    of predecessor rows past the first."""
    return OPS_CELL[local] * cells + OPS_PRED * pcells


def band_w(L: int) -> int:
    return 311 + (30 * L) // 1000


def block_work(uniq: list, pad: int, banded: bool) -> tuple:
    """(cells, pred cells) of one block from its unique MSA rows (uint8
    arrays of one width, in the POA's order)."""
    U = len(uniq)
    if U < 2:
        return 0, 0
    A = np.stack(uniq)
    C = A.shape[1]
    occ = A != GAP
    key = np.arange(C)[None, :] * 256 + A
    rr, cc = np.nonzero(occ)                       # row-major: rows ascend
    keys, first = np.unique(key[rr, cc], return_index=True)
    node_row = rr[first]                           # first row holding it
    ids = np.searchsorted(keys, key[rr, cc])
    same = rr[1:] == rr[:-1]
    e_src, e_dst, e_row = ids[:-1][same], ids[1:][same], rr[1:][same]
    ekey = e_dst * len(keys) + e_src
    ek, efirst = np.unique(ekey, return_index=True)
    edge_row = e_row[efirst]
    in_first = np.full(len(keys), U, np.int64)     # first row of an in-edge
    np.minimum.at(in_first, ek // len(keys), edge_row)
    rounds = np.arange(1, U)
    n_nodes = np.searchsorted(np.sort(node_row), rounds)   # rows < r
    n_edges = np.searchsorted(np.sort(edge_row), rounds)
    n_fed = np.searchsorted(np.sort(in_first), rounds)
    L = np.array([int(occ[r].sum()) + 2 * pad for r in rounds])
    if not banded:
        cells = (n_nodes + 2 * pad) * (L + 1)
    else:
        rank = keys // 256 + pad + 1
        flank = np.concatenate([np.arange(1, pad + 1),
                                np.arange(pad + C + 1, 2 * pad + C + 1)])
        cells = np.zeros(len(rounds), np.int64)
        cols = np.zeros(len(rounds))              # a row's mean band
        for k, r in enumerate(rounds):
            w = band_w(int(L[k]))
            rk = np.concatenate([rank[node_row < r], flank])
            width = np.clip(np.minimum(L[k], rk + w)
                            - np.maximum(0, rk - w) + 1, 0, None)
            cells[k] = int(width.sum())
            cols[k] = width.mean()
        pcells = ((n_edges - n_fed) * cols).astype(np.int64)
        return int(cells.sum()), int(pcells.sum())
    pcells = (n_edges - n_fed) * (L + 1)
    return int(cells.sum()), int(pcells.sum())


def bound_s(ops: int, sms: int, clock_mhz: float) -> float:
    """Least seconds for `ops` int32 operations: `sms` SMs x SM_LANES
    lanes a clock at the SM clock (nvidia-smi clocks.max.sm).  The
    kernel's inputs and outputs are a few MB, far below this in time at
    3.35 TB/s, so the bound is by operations."""
    return ops / (sms * SM_LANES * clock_mhz * 1e6)
