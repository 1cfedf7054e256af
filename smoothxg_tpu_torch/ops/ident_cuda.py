"""Batched banded affine identity on the GPU (the split stage's
`--device-split-wfa` route).

Port of smoothxg_tpu/ops/ident_jax.py: the split stage's second distance
estimator (besides MinHash) is the gap-compressed identity matches /
(matches + mismatches + gap_openings) of a bounded affine alignment
(reference: wfa_gap_compressed_identity, src/breaks.cpp:72-102, penalties
{match 0, mismatch 7, gap_open 11, gap_ext 1}).  The device route is a
banded affine DP along the longer sequence that carries the count triple
of the optimal path through the forward pass, with a fixed tie-break order
(diagonal > in-row gap > cross-row gap; earlier opening first), so every
route gives the same integers:
  * `ident_counts` launches csrc/ident.cu (one warp a pair up to a band
    of 256 columns, one thread block a pair and a thread a column above)
    for CUDA tensors and runs its plain PyTorch version,
    `ident_counts_reference`, for CPU tensors;
  * `host_banded_identity` is the numpy mirror, the parity oracle.
The identity itself is computed on the host in float64 from the integer
counts.  The window's first column, i * lb / la - band / 2, is computed in
int64 on every route (the JAX function's int32 product wraps past ~46,340
bp, ROADMAP C3; its numpy mirror does not).
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.int32(1 << 28)
_INF = int(INF)
_KEY = 1 << 32          # packed prefix keys: value * _KEY + column


def _prep_pair(a: bytes | str, b: bytes | str):
    ab = a.encode() if isinstance(a, str) else bytes(a)
    bb = b.encode() if isinstance(b, str) else bytes(b)
    if len(bb) > len(ab):
        ab, bb = bb, ab            # identity is symmetric in (a, b)
    return np.frombuffer(ab, np.uint8), np.frombuffer(bb, np.uint8)


def identity_from_counts(matches: int, mism: int, gapruns: int) -> float:
    denom = matches + mism + gapruns
    return matches / denom if denom else 0.0


def pack_pairs(pairs: list[tuple[np.ndarray, np.ndarray]]) -> dict:
    """The kernel's inputs for `_prep_pair`ed pairs (a the longer): each
    side's bytes concatenated (uint8), with int64 offsets and int32
    lengths."""
    out = {}
    for side in (0, 1):
        seqs = [p[side] for p in pairs]
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        off = np.zeros(len(seqs), dtype=np.int64)
        if len(seqs):
            off[1:] = np.cumsum(lens)[:-1]
        cat = np.concatenate(seqs) if len(seqs) else np.zeros(0, np.uint8)
        name = "ab"[side]
        out[name] = torch.from_numpy(np.concatenate([cat, np.zeros(1, np.uint8)]))
        out[f"{name}off"] = torch.from_numpy(off)
        out[f"l{name}"] = torch.from_numpy(lens.astype(np.int32))
    return out


def ident_counts_reference(a, aoff, la, b, boff, lb, band: int = 128,
                           mismatch: int = 7, gap_open: int = 11,
                           gap_ext: int = 1) -> torch.Tensor:
    """Plain PyTorch version of csrc/ident.cu, on any device: every pair's
    DP row by row, vectorized over the pairs and the band (the recurrences
    of smoothxg_tpu/ops/ident_jax.py:101-197).  (P, 4) int32: score,
    matches, mismatches, gap openings at the final cell."""
    dev = a.device
    P, BW = la.numel(), band
    X, O, E = mismatch, gap_open, gap_ext
    out = torch.zeros((P, 4), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    la64, lb64 = la.long(), lb.long()
    maxa, maxb = int(la64.max()), int(lb64.max())
    col = torch.arange(BW, device=dev)[None, :]
    # a's bytes by row, b's bytes by column (-2 past lb), both padded
    ai = aoff[:, None] + torch.arange(max(maxa, 1), device=dev)[None, :]
    A = torch.where(ai < (aoff + la64)[:, None],
                    a[ai.clamp_max(a.numel() - 1)].long(),
                    torch.full_like(ai, -1))
    bi = boff[:, None] + torch.arange(maxb + BW + 1, device=dev)[None, :]
    Bp = torch.where(bi < (boff + lb64)[:, None],
                     b[bi.clamp_max(b.numel() - 1)].long(),
                     torch.full_like(bi, -2))
    cmax = (lb64 - BW + 1).clamp_min(0)

    def center(i: int) -> torch.Tensor:
        ci = torch.where(la64 > 0, i * lb64 // la64.clamp_min(1),
                         torch.zeros_like(la64))
        return torch.minimum((ci - BW // 2).clamp_min(0), cmax)

    # the state as (score, matches, mismatches, gap openings) planes
    c = center(0)
    j0 = c[:, None] + col
    Hs = torch.stack([
        torch.where(j0 == 0, 0, torch.where(j0 <= lb64[:, None], O + E * j0,
                                            _INF)),
        torch.zeros_like(j0), torch.zeros_like(j0), (j0 > 0).long()])
    Is = torch.zeros_like(Hs)
    Is[0] = _INF
    # fills of a shifted-in column and the channels' increments
    fill = torch.zeros((4, P, 1), dtype=torch.int64, device=dev)
    fill[0] = _INF

    def inc(*v):
        return torch.tensor(v, dtype=torch.int64, device=dev)[:, None, None]

    open_h, ext_i = inc(O + E, 0, 0, 1), inc(E, 0, 0, 0)
    nomatch = inc(X, 0, 1, 0)
    match = inc(0, 1, 0, 0)

    def rsh(Y, f):
        return torch.cat([f, Y[..., :-1]], dim=-1)

    for i in range(1, maxa + 1):
        ci = center(i)
        d1 = (ci - c == 1)[:, None]
        live = (i <= la64)[:, None]
        # the previous row in this row's frame, and its diagonal
        Hp = torch.where(d1, torch.cat([Hs[..., 1:], fill], dim=-1), Hs)
        Ip = torch.where(d1, torch.cat([Is[..., 1:], fill], dim=-1), Is)
        Hd = rsh(Hp, fill)
        bprev = rsh(Bp.gather(1, ci[:, None] + col), fill[1] - 3)
        ism = (bprev >= 0) & (A[:, i - 1:i] == bprev)
        # I: gap along a, H first on ties
        fromH, fromI = Hp + open_h, Ip + ext_i
        In = torch.where(fromH[0] <= fromI[0], fromH, fromI)
        # M: diagonal (INF stays INF); Hq = min(M, I), M first on ties
        M = Hd + torch.where(ism, match, nomatch)
        M[0] = torch.where(Hd[0] >= _INF, _INF, M[0])
        Hq = torch.where(M[0] <= In[0], M, In)
        # D: exclusive prefix minimum of the packed keys (value, column)
        w = torch.where(Hq[0] >= _INF, _INF, Hq[0] - E * col)
        pk = rsh(torch.cummin(w * _KEY + col, dim=1).values, fill[0] * _KEY)
        q = pk & (_KEY - 1)
        D = torch.where(col == 0, 0, Hq.gather(2, q.expand(4, P, BW)))
        pv = (pk - q) // _KEY
        D[0] = torch.where(pv >= _INF, _INF, pv + O + E * col)
        D[3] += 1
        Hn = torch.where(Hq[0] <= D[0], Hq, D)
        bad = (ci[:, None] + col) > lb64[:, None]
        Hn[0] = torch.where(bad, _INF, Hn[0])
        In[0] = torch.where(bad, _INF, In[0])
        Hs = torch.where(live, Hn, Hs)
        Is = torch.where(live, In, Is)
        c = torch.where(live[:, 0], ci, c)
    pf = (lb64 - c).clamp(0, BW - 1)[None, :, None]
    out[:] = Hs.gather(2, pf.expand(4, P, 1))[:, :, 0].T.to(torch.int32)
    return out


def ident_counts(a, aoff, la, b, boff, lb, band: int = 128,
                 mismatch: int = 7, gap_open: int = 11,
                 gap_ext: int = 1) -> torch.Tensor:
    """Score and counts of each pair (`pack_pairs`' layout).  CUDA tensors
    launch csrc/ident.cu (and raise on a launch error); CPU tensors run
    `ident_counts_reference`.  (P, 4) int32."""
    want = ((a, torch.uint8), (aoff, torch.int64), (la, torch.int32),
            (b, torch.uint8), (boff, torch.int64), (lb, torch.int32))
    if any(t.dtype != dt or t.dim() != 1 or not t.is_contiguous()
           or t.device != a.device for t, dt in want) \
            or len({la.numel(), lb.numel(), aoff.numel(),
                    boff.numel()}) != 1:
        raise ValueError("ident_counts wants pack_pairs' tensors on one "
                         "device")
    if band % 2:
        raise ValueError(f"the band must be even: {band}")
    if a.device.type == "cpu":
        return ident_counts_reference(a, aoff, la, b, boff, lb, band,
                                      mismatch, gap_open, gap_ext)
    if a.device.type != "cuda":
        raise ValueError(f"ident_counts: unsupported device {a.device}")
    if band % 32 or not 32 <= band <= 1024:
        raise ValueError(f"the CUDA kernel takes a band of 32-1024 columns "
                         f"in steps of 32 (whole warps): {band}")
    P = la.numel()
    out = torch.empty((P, 4), dtype=torch.int32, device=a.device)
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = lib.ident_launch(a.data_ptr(), aoff.data_ptr(), la.data_ptr(),
                              b.data_ptr(), boff.data_ptr(), lb.data_ptr(),
                              out.data_ptr(), P, band, mismatch, gap_open,
                              gap_ext, stream)
    if rc != 0:
        raise RuntimeError(f"ident kernel launch failed: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")
    ident_counts.launches += 1
    return out


ident_counts.launches = 0     # kernel launches made by this wrapper


class DeviceBandedIdentity:
    """Gap-compressed identities for a batch of sequence pairs on `device`
    ("cuda": the kernel; "cpu": its plain version), bit-identical to
    host_banded_identity."""

    def __init__(self, band: int = 128, mismatch: int = 7,
                 gap_open: int = 11, gap_ext: int = 1,
                 device: str | torch.device = "cuda"):
        from ..device import resolve
        assert band % 2 == 0
        self.B = band
        self.x, self.o, self.e = mismatch, gap_open, gap_ext
        self.device = resolve(
            device, what="--device-split-wfa runs its banded identity "
            "kernel (csrc/ident.cu) on an NVIDIA GPU",
            instead="leave the flag off for the host route")

    def identities(self, pairs: list[tuple[bytes | str, bytes | str]],
                   max_score: int | list[int] | None = None) -> list[float]:
        """One float per pair; pairs whose banded score reaches max_score
        (scalar or per-pair) report identity 0.0 (the host route's
        bail)."""
        if not pairs:
            return []
        ms = (list(max_score)
              if isinstance(max_score, (list, tuple, np.ndarray))
              else [max_score] * len(pairs))
        packed = pack_pairs([_prep_pair(a, b) for a, b in pairs])
        res = ident_counts(*(packed[n].to(self.device) for n in
                             ("a", "aoff", "la", "b", "boff", "lb")),
                           self.B, self.x, self.o, self.e).cpu().numpy()
        out: list[float] = []
        for i, (sc, m, xx, g) in enumerate(res.tolist()):
            if sc >= INF or (ms[i] is not None and sc >= ms[i]):
                out.append(0.0)
            else:
                out.append(identity_from_counts(m, xx, g))
        return out


def host_banded_identity(a: bytes | str, b: bytes | str, *, band: int = 128,
                         mismatch: int = 7, gap_open: int = 11,
                         gap_ext: int = 1,
                         max_score: int | None = None,
                         return_counts: bool = False):
    """Numpy mirror of the device kernel (same band, recurrences and
    tie-breaks) — the parity oracle."""
    av, bv = _prep_pair(a, b)
    la, lb = len(av), len(bv)
    B2 = band
    x, o, e = mismatch, gap_open, gap_ext
    cmax = max(lb - B2 + 1, 0)

    def center(i):
        ci = (i * lb) // max(la, 1) if la > 0 else 0
        return min(max(ci - B2 // 2, 0), cmax)

    ap = np.full(la + 1, -1, np.int64)
    ap[:la] = av
    bp = np.full(lb + B2 + 1, -2, np.int64)
    bp[:lb] = bv
    c = center(0)
    j0 = c + np.arange(B2)
    H = np.where(j0 == 0, 0, np.where(j0 <= lb, o + e * j0, INF)).astype(np.int64)
    Hm = np.zeros(B2, np.int64)
    Hx = np.zeros(B2, np.int64)
    Hg = np.where(j0 > 0, 1, 0).astype(np.int64)
    Iv = np.full(B2, INF, np.int64)
    Im = np.zeros(B2, np.int64)
    Ix = np.zeros(B2, np.int64)
    Ig = np.zeros(B2, np.int64)

    for i in range(1, la + 1):
        ci = center(i)
        d = ci - c
        c = ci

        def sh(X, fill):
            if d == 1:
                return np.concatenate([X[1:], [fill]])
            return X

        H, Hm, Hx, Hg = sh(H, INF), sh(Hm, 0), sh(Hx, 0), sh(Hg, 0)
        Iv, Im, Ix, Ig = sh(Iv, INF), sh(Im, 0), sh(Ix, 0), sh(Ig, 0)
        jcol = ci + np.arange(B2)
        bwin = bp[jcol]
        achar = ap[i - 1]

        fromH = H + (o + e)
        fromI = Iv + e
        useH = fromH <= fromI
        Iv2 = np.minimum(fromH, fromI)
        Im2 = np.where(useH, Hm, Im)
        Ix2 = np.where(useH, Hx, Ix)
        Ig2 = np.where(useH, Hg + 1, Ig)

        def rsh(X, fill):
            return np.concatenate([[fill], X[:-1]])

        Hd, Hdm, Hdx, Hdg = rsh(H, INF), rsh(Hm, 0), rsh(Hx, 0), rsh(Hg, 0)
        bprev = rsh(bwin, -3)
        ismatch = (achar == bprev) & (achar >= 0) & (bprev >= 0)
        Mv = np.where(Hd >= INF, INF, Hd + np.where(ismatch, 0, x))
        Mm = Hdm + np.where(ismatch, 1, 0)
        Mx_ = Hdx + np.where(ismatch, 0, 1)
        Mg = Hdg

        useM = Mv <= Iv2
        Hq = np.minimum(Mv, Iv2)
        Hqm = np.where(useM, Mm, Im2)
        Hqx = np.where(useM, Mx_, Ix2)
        Hqg = np.where(useM, Mg, Ig2)

        # exclusive min-plus prefix with payload, left preferred on ties:
        # find, for every p, the earliest q <= p achieving the running
        # minimum of w (strict improvement => earlier index wins ties)
        w = np.where(Hq < INF, Hq - e * np.arange(B2), INF)
        run_incl = np.minimum.accumulate(w)
        prev_best = np.concatenate([[np.int64(INF) + 1], run_incl[:-1]])
        new_best = w < prev_best
        best_at = np.maximum.accumulate(
            np.where(new_best, np.arange(B2), -1))
        safe = np.maximum(best_at, 0)
        pv_i = np.where(best_at >= 0, run_incl, INF)
        pm_i = np.where(best_at >= 0, Hqm[safe], 0)
        px_i = np.where(best_at >= 0, Hqx[safe], 0)
        pg_i = np.where(best_at >= 0, Hqg[safe], 0)

        def excl(X, fill):
            return np.concatenate([[fill], X[:-1]])

        pv = excl(pv_i, INF)
        pm = excl(pm_i, 0)
        px = excl(px_i, 0)
        pg = excl(pg_i, 0)
        Dv = np.where(pv >= INF, INF, pv + o + e * np.arange(B2))
        Dg = pg + 1

        useQ = Hq <= Dv
        H = np.minimum(Hq, Dv)
        Hm = np.where(useQ, Hqm, pm)
        Hx = np.where(useQ, Hqx, px)
        Hg = np.where(useQ, Hqg, Dg)
        bad = (jcol > lb) | (jcol < 0)
        H = np.where(bad, INF, H)
        Iv, Im, Ix, Ig = Iv2, Im2, Ix2, Ig2
        Iv = np.where(bad, INF, Iv)

    p = min(max(lb - c, 0), B2 - 1)
    sc, m, xx, g = int(H[p]), int(Hm[p]), int(Hx[p]), int(Hg[p])
    if return_counts:
        return sc, m, xx, g
    if sc >= INF or (max_score is not None and sc >= max_score):
        return 0.0
    return identity_from_counts(m, xx, g)
