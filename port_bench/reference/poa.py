"""Plain local partial order alignment of a sequence to a graph, in PyTorch
operations, batched over independent problems.

A graph here is what a multiple sequence alignment shows: a node is a base
in a column, and an edge joins two consecutive bases of a row.  The columns
are a topological order, and the nodes of one column are never joined to
each other, so a column's nodes are filled in one step.

Scoring is smoothxg's (src/main.cpp:322-327; spoa's convex gaps): match
`m`, mismatch `-n`, and a gap of k bases `-min(g + (k-1) e, q + (k-1) c)`.
The recurrence, for node v and sequence position j (rows are nodes):

  M[v,j]  = max_p H[p,j-1] + (m if base matches else -n)
  E*[v,j] = max_p max(H[p,j] - open*, E*[p,j] - ext*)    (v deleted)
  Hq[v,j] = max(M, E1, E2, 0)
  F*[v,j] = max_{k<j} Hq[v,k] - open* - (j-1-k) ext*      (bases inserted)
  H[v,j]  = max(Hq, F1, F2)

and the local score is the largest H.  A node without predecessors takes
the source row (H = 0).  With `anchor` the alignment is held to the one a
multiple alignment shows: base j may only match or mismatch a node of
column anchor[j], and only a base with anchor -1 may be inserted.  Its
score is then the best of every alignment consistent with that one (the
deleted nodes between two aligned bases are free to choose).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SCORES = (1, 4, 6, 2, 26, 1)       # m, n, g, e, q, c
_INT_NEG = -(1 << 28)
_BIG = 1 << 40                     # a segment's weight in the masked scan


@dataclass
class Problem:
    col: np.ndarray                # [N] column of each node, nondecreasing
    base: np.ndarray               # [N] uint8
    preds: list                    # [N] lists of node ids
    seq: np.ndarray                # [L] uint8
    anchor: np.ndarray | None = None   # [L] column, or -1: inserted


def _neg(dtype: torch.dtype):
    return float("-inf") if dtype.is_floating_point else _INT_NEG


class _Layout:
    """The problems' nodes as steps of at most K nodes (one column each)
    with at most P predecessors; store rows: 0 the source (H = 0), 1 the
    sink of empty slots, 2 a row that stays at -inf, node v at 3 + v."""

    def __init__(self, problems: list[Problem]):
        B = len(problems)
        ncols, kmax, pmax, nmax = [], 1, 1, 0
        for p in problems:
            _, counts = np.unique(p.col, return_counts=True)
            ncols.append(len(counts))
            if len(counts):
                kmax = max(kmax, int(counts.max()))
            pmax = max([pmax] + [len(x) for x in p.preds])
            nmax = max(nmax, len(p.col))
        S = max(ncols) if ncols else 0
        self.rows = np.ones((B, S, kmax), np.int64)
        self.base = np.full((B, S, kmax), 255, np.uint8)
        self.col = np.full((B, S), -2, np.int64)
        self.preds = np.full((B, S, kmax, pmax), 2, np.int64)
        for b, p in enumerate(problems):
            if not len(p.col):
                continue
            cols, starts = np.unique(p.col, return_index=True)
            step = np.searchsorted(cols, p.col)
            slot = np.arange(len(p.col)) - starts[step]
            self.rows[b, step, slot] = 3 + np.arange(len(p.col))
            self.base[b, step, slot] = p.base
            self.col[b, :len(cols)] = cols
            for v, ps in enumerate(p.preds):
                pr = [3 + u for u in ps] or [0]
                self.preds[b, step[v], slot[v], :len(pr)] = pr
        self.S, self.R = S, 3 + nmax
        L = max([len(p.seq) for p in problems] + [0])
        self.L = L
        self.seq = np.full((B, L), 254, np.uint8)
        self.valid = np.zeros((B, L + 1), bool)
        self.anchor = np.full((B, L + 1), -3, np.int64)
        for b, p in enumerate(problems):
            self.seq[b, :len(p.seq)] = p.seq
            self.valid[b, :len(p.seq) + 1] = True
            if p.anchor is not None:
                self.anchor[b, 1:len(p.seq) + 1] = p.anchor


def fill(problems: list[Problem], device, dtype=torch.int32,
         scores=SCORES, keep: bool = False):
    """Local scores of `problems` (a list, one per problem), computed in
    `dtype`.  Anchored problems need an integer dtype.  With `keep`, also
    the store (H, Hq, E1, E2 on the host, rows as in _Layout) and the
    layout, for a traceback."""
    m, n, g, e, q, c = scores
    lay = _Layout(problems)
    B, S, R, L = len(problems), lay.S, lay.R, lay.L
    dev = torch.device(device)
    neg = _neg(dtype)
    anchored = any(p.anchor is not None for p in problems)
    if anchored and dtype.is_floating_point:
        raise ValueError("anchored scores are exact: give an integer dtype")
    t = lambda a: torch.as_tensor(a, device=dev)      # noqa: E731
    rows, base, colv, preds = (t(lay.rows), t(lay.base), t(lay.col),
                               t(lay.preds))
    seq, valid = t(lay.seq), t(lay.valid)
    j = torch.arange(L + 1, device=dev)
    H_st, E1_st, E2_st = (torch.full((B, R, L + 1), neg, dtype=dtype,
                                     device=dev) for _ in range(3))
    H_st[:, 0] = 0
    Hq_st = torch.full_like(H_st, neg) if keep else None
    if anchored:
        anc = t(lay.anchor)
        has_anchor = torch.tensor([p.anchor is not None for p in problems],
                                  device=dev)
        ins_ok = (anc == -1) | ~has_anchor[:, None]
        ins_ok[:, 0] = False
        cnt = torch.cumsum((~ins_ok).long(), 1)
        cnt[:, 0] = 0
    bi = torch.arange(B, device=dev)
    bk = bi[:, None]
    bkp = bi[:, None, None]
    ej, cj = (j * e).to(dtype), (j * c).to(dtype)
    best = torch.zeros(B, dtype=dtype, device=dev)
    sub_t = torch.tensor([m, -n], dtype=dtype, device=dev)
    for s in range(S):
        r, pr = rows[:, s], preds[:, s]
        Hpm = H_st[bkp, pr].amax(2)
        E1pm = E1_st[bkp, pr].amax(2)
        E2pm = E2_st[bkp, pr].amax(2)
        eq = seq[:, None, :] == base[:, s, :, None]
        M = torch.full_like(Hpm, neg)
        M[..., 1:] = Hpm[..., :-1] + torch.where(eq, sub_t[0], sub_t[1])
        if anchored:
            hold = has_anchor[:, None, None] & (
                anc[:, None, :] != colv[:, s, None, None])
            M = M.masked_fill(hold, neg)
        e1 = torch.maximum(Hpm - g, E1pm - e)
        e2 = torch.maximum(Hpm - q, E2pm - c)
        if not dtype.is_floating_point:
            e1.clamp_(min=neg)
            e2.clamp_(min=neg)
        hq = torch.maximum(torch.maximum(M, e1), e2).clamp_(min=0)
        if anchored:
            F1 = _masked_gap(hq, cnt, ins_ok, j, g, e, neg, dtype)
            F2 = _masked_gap(hq, cnt, ins_ok, j, q, c, neg, dtype)
        else:
            F1 = torch.full_like(hq, neg)
            F2 = torch.full_like(hq, neg)
            F1[..., 1:] = torch.cummax(hq + ej, -1).values[..., :-1] \
                - g - ej[:-1]
            F2[..., 1:] = torch.cummax(hq + cj, -1).values[..., :-1] \
                - q - cj[:-1]
        H = torch.maximum(torch.maximum(hq, F1), F2)
        H = H.masked_fill(~valid[:, None, :], neg)
        H_st[bk, r] = H
        E1_st[bk, r] = e1
        E2_st[bk, r] = e2
        if keep:
            Hq_st[bk, r] = hq
        best = torch.maximum(best, H.amax((1, 2)))
    out = best.tolist()
    if keep:
        return out, tuple(x.float().cpu().numpy() for x in
                          (H_st, Hq_st, E1_st, E2_st)), lay
    return out


def _masked_gap(hq, cnt, ins_ok, j, op, ex, neg, dtype):
    """F of one gap channel where only positions with ins_ok may be
    inserted: the prefix maximum restarts after each position that may
    not (a segmented scan, the segment weighted by _BIG)."""
    key = cnt[:, None, :] * _BIG + (hq.long() + ex * j)
    G = torch.cummax(key, -1).values
    F = torch.full_like(hq, neg)
    F[..., 1:] = (G[..., :-1] - cnt[:, None, :-1] * _BIG - op
                  - ex * (j[1:] - 1)).clamp(min=neg).to(dtype)
    return F.masked_fill(~ins_ok[:, None, :], neg)


def traceback(problem: Problem, store, lay, b: int = 0,
              scores=SCORES) -> np.ndarray:
    """The alignment a fill put first, as anchors: for each base of the
    sequence the column of the node it was aligned to, or -1.  Each move
    takes the candidate nearest the cell's value, so a fill in a lower
    precision traces back through its own rounding."""
    m, n, g, e, q, c = scores
    H, Hq, E1, E2 = (np.asarray(x[b], np.float64) for x in store)
    L = len(problem.seq)
    seq = problem.seq
    row_col = np.full(lay.R, -1, np.int64)
    row_base = np.zeros(lay.R, np.int64)
    row_preds: dict[int, list[int]] = {}
    for s in range(lay.S):
        for k in range(lay.rows.shape[2]):
            r = int(lay.rows[b, s, k])
            if r >= 3:
                row_col[r] = lay.col[b, s]
                row_base[r] = lay.base[b, s, k]
                row_preds[r] = [int(x) for x in lay.preds[b, s, k]
                                if x != 2]
    Hv = np.where(np.isfinite(H[:, :L + 1]), H[:, :L + 1], -np.inf)
    Hv[:3] = -np.inf
    i, jj = np.unravel_index(int(np.argmax(Hv)), Hv.shape)
    i, jj = int(i), int(jj)
    anchor = np.full(L, -1, np.int64)
    chan, val = "H", H[i, jj]
    guard = 4 * (lay.R + L) + 16
    while guard:
        guard -= 1
        if i == 0 or (chan in ("H", "Hq") and val <= 0):
            break
        prs = row_preds[i]
        if chan in ("H", "Hq"):
            cands = []
            if jj > 0:
                sub = m if seq[jj - 1] == row_base[i] else -n
                for pr in prs:
                    cands.append((abs(H[pr, jj - 1] + sub - val), "M", pr))
            cands.append((abs(E1[i, jj] - val), "E1", None))
            cands.append((abs(E2[i, jj] - val), "E2", None))
            if chan == "H" and jj > 0:
                k = np.arange(jj)
                for name, op, ex in (("F1", g, e), ("F2", q, c)):
                    d = np.abs(Hq[i, :jj] - op - (jj - 1 - k) * ex - val)
                    kk = int(np.argmin(d))
                    cands.append((d[kk], name, kk))
            _, how, arg = min(cands, key=lambda x: x[0])
            if how == "M":
                anchor[jj - 1] = row_col[i]
                i, jj, chan, val = arg, jj - 1, "H", H[arg, jj - 1]
            elif how in ("E1", "E2"):
                chan, val = how, (E1 if how == "E1" else E2)[i, jj]
            else:
                jj, chan, val = arg, "Hq", Hq[i, arg]
        else:
            op, ex, Em = (g, e, E1) if chan == "E1" else (q, c, E2)
            cands = [(abs(H[pr, jj] - op - val), "H", pr) for pr in prs]
            cands += [(abs(Em[pr, jj] - ex - val), chan, pr) for pr in prs]
            _, how, pr = min(cands, key=lambda x: x[0])
            i, chan = pr, how
            val = (H if how == "H" else Em)[pr, jj]
    return anchor
