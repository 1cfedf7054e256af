"""Whole-block partial order alignment with a code-chase traceback.

`poa_code` runs the same function as ops/poa_win.poa_win — for each block
of a batch the whole POA loop of FusedPOA (seed, fill, traceback, guarded
ring threading), with its I/O contract and layouts — but it is the port of
the unwindowed Pallas kernel smoothxg_tpu/ops/poa_pallas_fused.py:
_pallas_core (wrappers `_fused_fn`, `_compiled_fused`), and like that
kernel it traces back by chasing provenance codes instead of re-deriving
values:
  * rows are full width (W = LW); a banded block keeps full rows and masks
    every cell outside its rank band to the floor before the F scan;
  * the fill records, per cell, one int32 code word with the fields of
    poa_pallas_fused.py:403-409 (`CodeLayout`): the predecessor slot that
    holds the maximum for M, E1 and E2, whether E1 / E2 open or extend,
    which of M / E1 / E2 gives Hq, whether Hq / F1 / F2 equal H, whether
    the cell renews the F1 / F2 prefix maximum, and Hq == 0 (local);
  * the traceback reads one code word per step.  Chasing the codes
    reproduces the oracle's tie order: M before E1 before E2, the first
    predecessor slot that holds the maximum, an E step opens before it
    extends, F origins nearest first with channel 1 before channel 2;
  * 8 predecessor slots per node (`PCAP`); a 9th overflows.
The kernel's DP planes are (VW + 1) x LS per block, LS = `row_stride` of
the launch (its longest sequence + 1, rounded up to 32), so scratch
follows the batch and not the caps; its graph tables keep node ids and
rows in int16, so VW is at most `VW_MAX`.
For CUDA tensors `poa_code` launches csrc/poa_code.cu; for CPU tensors it
runs `poa_code_reference`, the plain PyTorch version, which is written
against the kernel's arithmetic.  Scores are int32 with the oracle's floor
NEG = -2^30 (the Pallas kernel's int16 clamp at -16000 is not carried
over).  Overflow — a sequence that does not fit, node VW + 1, predecessor
pcap + 1, or a chase that leaves the table (cannot happen with a correct
fill) — sets meta[1]; the block's outputs are then canonical (meta =
[0, 1, nseq, 0], -1 everywhere else) and the engine redoes it natively.

`from_fused_layout` / `to_fused_layout` convert from and to the Pallas
kernel's arrays so the tests compare like with like.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .poa_win import (NEG, VW_MAX, _check_inputs, _Overflow, _RefBlock,
                      check_nodes, launch, row_stride, table_bytes,
                      to_win_layout)

PCAP = 8
FOLD = 8


@dataclass(frozen=True)
class CodeCaps:
    """Capacities and variant of one launch; rows are full width."""
    VW: int              # node capacity
    LW: int              # sequence capacity: L <= LW - 1
    local: bool
    banded: bool
    pcap: int = PCAP     # predecessor slots per node

    @property
    def W(self) -> int:
        return self.LW

    def scratch_words(self, LS: int) -> int:
        """int32 words of per-block scratch at row stride LS (ops/poa_win.
        row_stride): the graph tables, then the four DP planes H, E1, E2,
        CODE at 16 B a cell (csrc/poa_code.cu:block_bytes)."""
        return (table_bytes(self.VW, self.pcap, LS, self.banded)
                + 16 * (self.VW + 1) * LS) // 4


class CodeLayout:
    """Bit positions of the provenance code word for slot fields of `sb`
    bits: sb = 7 is poa_pallas_fused.py:403-409, sb = 2 the CODE16 of
    poa_pallas_stacked.py:433-442."""

    def __init__(self, sb: int):
        self.sb = sb
        self.SLOT = (1 << sb) - 1
        self.E1S, self.E1O = sb, 2 * sb
        self.E2S, self.E2O = 2 * sb + 1, 3 * sb + 1
        self.SEL = 3 * sb + 2
        self.HQEQ, self.F1H, self.F2H = 3 * sb + 4, 3 * sb + 5, 3 * sb + 6
        self.F1N, self.F2N, self.HQZ = 3 * sb + 7, 3 * sb + 8, 3 * sb + 9


CODE32 = CodeLayout(7)


# `stage`: _pallas_core's profiling knob (poa_pallas_fused.py:86-93), for
# timing only — a nonzero stage gives invalid graphs by design.  0 the full
# loop; 1 fill + end cell (no code chase, no threading); 2 fill + code
# chase (no threading); 3 threading without the ring scan past the target;
# 4 threading without node creation or edge bookkeeping; 5 / 6 / 7 the fill
# without the F prefix scan (H = Hq) / the code word / the predecessor-slot
# loop, each also without chase and threading.
STAGES = range(8)


def check_stage(stage: int, stages) -> None:
    if stage not in stages:
        raise ValueError(f"stage {stage} is not one of {list(stages)}")


def poa_code(seqs: torch.Tensor, slen: torch.Tensor, nseq: torch.Tensor,
             params: torch.Tensor, caps: CodeCaps, stage: int = 0):
    """Run the whole POA loop of every block (or a profiling `stage` of
    it).  CUDA tensors launch the kernel (and raise on any launch error);
    CPU tensors run the plain version.  Returns (meta, exp, paths) on the
    inputs' device."""
    _check_inputs(seqs, slen, nseq, params, caps)
    check_stage(stage, STAGES)
    check_nodes(caps)
    if seqs.device.type == "cpu":
        return poa_code_reference(seqs, slen, nseq, params, caps, stage)
    LS = row_stride(slen, caps.LW)
    out = launch("poa_code", seqs, slen, nseq, params, caps,
                 caps.scratch_words(LS), caps.pcap, stage, LS)
    poa_code.launches += 1
    return out


poa_code.launches = 0     # kernel launches made by this wrapper


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def poa_code_reference(seqs: torch.Tensor, slen: torch.Tensor,
                       nseq: torch.Tensor, params: torch.Tensor,
                       caps: CodeCaps, stage: int = 0):
    """The same function in plain PyTorch on the CPU: each DP row is
    vectorized over its columns and records its code words; the walk,
    the code chase and the threading are scalar.  Stages 5-7 change only
    the fill's arithmetic, whose values no stage from 5 up exports, so
    their plain version is stage 1's."""
    check_stage(stage, STAGES)
    return code_reference(seqs, slen, nseq, params, caps, CODE32, stage)


def code_reference(seqs, slen, nseq, params, caps, layout: CodeLayout,
                   stage: int = 0):
    """The plain version for a code layout (poa_stacked's uses 2-bit
    slots) at a profiling stage."""
    _check_inputs(seqs, slen, nseq, params, caps)
    B, RW, LW = seqs.shape
    meta = torch.empty((B, 4), dtype=torch.int32)
    exp = torch.full((B, 3, caps.VW), -1, dtype=torch.int32)
    paths = torch.full((B, RW, LW), -1, dtype=torch.int32)
    sq = seqs.cpu()
    sl = slen.cpu().tolist()
    ns = nseq.cpu().tolist()
    pr = params.cpu().tolist()
    for b in range(B):
        if ns[b] > RW:
            raise ValueError("nseq exceeds the RW sequence slots")
        res = _CodeBlock(sq[b], sl[b][:max(ns[b], 0)], pr[b], caps,
                         layout, 1 if stage >= 5 else stage).run()
        if res is None:
            meta[b] = torch.tensor([0, 1, ns[b], 0], dtype=torch.int32)
            continue
        V, gs, base, ring, order, bpaths = res
        meta[b] = torch.tensor([V, 0, ns[b], gs], dtype=torch.int32)
        exp[b, 0, :V] = torch.tensor(base, dtype=torch.int32)
        exp[b, 1, :V] = torch.tensor(ring, dtype=torch.int32)
        exp[b, 2, :V] = torch.tensor(order, dtype=torch.int32)
        for r, pth in enumerate(bpaths):
            if pth:
                paths[b, r, :len(pth)] = torch.tensor(pth, dtype=torch.int32)
    return (meta.to(seqs.device), exp.to(seqs.device),
            paths.to(seqs.device))


class _CodeBlock(_RefBlock):
    """One block's POA loop with full-width rows, code words in plane
    channel 3 (instead of Hq) and a code-chase traceback; the walk, band
    and threading are poa_win's."""

    def __init__(self, seqs_b, lens, par, caps, layout: CodeLayout,
                 stage: int = 0):
        super().__init__(seqs_b, lens, par, caps, stage)
        self.lay = layout

    def _stored_width(self, lens: list) -> int:
        return min(self.caps.LW, max(lens) + 1)

    def _offsets(self, blo: list) -> list:
        return [0] * len(blo)         # every row stores columns [0, L]

    def _fill_row(self, i, prs, blo, bhi, L, seqp, bv) -> int:
        """Row i over columns [0, L], cells outside [blo, bhi] at the
        floor; stores H, E1, E2 and the code words, returns the row max."""
        lay = self.lay
        n = L + 1
        j = self.ar[:n]
        P = self.P
        # predecessor maxima and the first slot that holds each
        for s, p in enumerate(prs):
            h, x1, x2 = P[p, 0, :n], P[p, 1, :n], P[p, 2, :n]
            if s == 0:
                hmax, e1mx, e2mx = h.clone(), x1.clone(), x2.clone()
                hs = torch.zeros(n, dtype=torch.int32)
                s1, s2 = hs.clone(), hs.clone()
                continue
            for mx, sl, x in ((hmax, hs, h), (e1mx, s1, x1), (e2mx, s2, x2)):
                sl.masked_fill_(x > mx, s)
                torch.maximum(mx, x, out=mx)
        sub = torch.where(seqp[:n] == bv, self.m, -self.n).to(torch.int32)
        M = torch.full((n,), NEG, dtype=torch.int32)
        M[1:] = hmax[:-1] + sub[1:]
        ms = torch.zeros(n, dtype=torch.int32)
        ms[1:] = hs[:-1]
        code = ms
        chans = []
        for op, ex, xm, xs, so, oo in ((self.g, self.e, e1mx, s1, lay.E1S,
                                        lay.E1O),
                                       (self.q, self.c, e2mx, s2, lay.E2S,
                                        lay.E2O)):
            opn = hmax - op
            ext = xm - ex
            isopen = opn >= ext
            chans.append(torch.maximum(opn, ext).clamp_(NEG))
            code = code | (torch.where(isopen, hs, xs) << so) | \
                (isopen.to(torch.int32) << oo)
        e1, e2 = chans
        hq = torch.maximum(M, torch.maximum(e1, e2))
        if self.caps.local:
            hq.clamp_(0)
            code = code | ((hq == 0).to(torch.int32) << lay.HQZ)
        sel = torch.where(M == hq, 0, torch.where(e1 == hq, 1, 2))
        code = code | (sel.to(torch.int32) << lay.SEL)
        out = None
        if blo > 0 or bhi < L:
            out = (j < blo) | (j > bhi)
            for x in (hq, e1, e2):
                x.masked_fill_(out, NEG)
        H = hq
        fs = []
        for op, ex, nb in ((self.g, self.e, lay.F1N),
                           (self.q, self.c, lay.F2N)):
            t = hq + ex * j
            excl = torch.full((n,), NEG, dtype=torch.int32)
            excl[1:] = torch.cummax(t, dim=0).values[:-1].clamp(NEG)
            F = excl - op - ex * (j - 1)
            F[0] = NEG
            code = code | ((t >= excl).to(torch.int32) << nb)
            fs.append(F)
            H = torch.maximum(H, F)
        if out is not None:
            H.masked_fill_(out, NEG)
        code = code | ((hq == H).to(torch.int32) << lay.HQEQ) | \
            ((fs[0] == H).to(torch.int32) << lay.F1H) | \
            ((fs[1] == H).to(torch.int32) << lay.F2H)
        P[i, 0, :n] = H
        P[i, 1, :n] = e1
        P[i, 2, :n] = e2
        P[i, 3, :n] = code
        self.rown[i] = n
        return int(H.max())

    def _traceback(self, i, j, order, rp, seq, L) -> list:
        """Chase the code words from the end cell (i, j)."""
        lay = self.lay
        C = self.P[:, 3].numpy()
        local = self.caps.local
        target = [-2] * L
        chan = 0                  # 0 = H, 1 = Hq, 2 = E1, 3 = E2
        while True:
            if i == 0:
                if chan >= 2:
                    raise _Overflow          # E chain off the table
                if local or j == 0:
                    break
                target[j - 1] = -1           # leading insertion via row 0
                j -= 1
                chan = 0
                continue
            cw = int(C[i, j])
            if chan <= 1:
                if chan == 0 and not cw >> lay.HQEQ & 1:
                    f1 = cw >> lay.F1H & 1
                    f2 = cw >> lay.F2H & 1
                    k = j - 1
                    while k >= 0:
                        ck = int(C[i, k])
                        if f1 & ck >> lay.F1N or f2 & ck >> lay.F2N & 1:
                            break
                        k -= 1
                    if k < 0:
                        raise _Overflow      # no F origin: cannot happen
                    target[k:j] = [-1] * (j - k)      # insertions
                    j, chan = k, 1
                    continue
                if local and cw >> lay.HQZ & 1:
                    break
                sel = cw >> lay.SEL & 3
                if sel == 0:
                    if j == 0:
                        raise _Overflow      # M at column 0: cannot happen
                    target[j - 1] = order[i - 1]
                    i, j, chan = rp[i][cw & lay.SLOT], j - 1, 0
                    continue
                chan = 1 + sel
            so, oo = (lay.E1S, lay.E1O) if chan == 2 else (lay.E2S, lay.E2O)
            i = rp[i][cw >> so & lay.SLOT]
            if cw >> oo & 1:
                chan = 0
        return target


# ---------------------------------------------------------------------------
# conversion from / to the Pallas kernel's arrays
# ---------------------------------------------------------------------------

def from_fused_layout(nseq, par, slen, seqs, LW: int, RW: int):
    """The Pallas kernel's input arrays (numpy, as FusedPallasEngine._launch
    packs them for `_compiled_fused`: nseq (N,1,1), par (N,1,8), slen
    (N,1,128) int16, seqs (N, RW*8, LW/8) int8 folded, char j of sequence r
    at flat position j+1 of its LW columns) -> the port's (seqs, slen,
    nseq, params) CPU tensors."""
    s = np.asarray(seqs)
    N = s.shape[0]
    if s.shape[1:] != (RW * FOLD, LW // FOLD):
        raise ValueError(f"seqs shape {s.shape} does not match RW={RW} "
                         f"LW={LW}")
    flat = s.reshape(N, RW, LW)
    out = np.full((N, RW, LW), -1, np.int8)
    out[:, :, :LW - 1] = flat[:, :, 1:]
    sl = np.asarray(slen).reshape(N, 128)[:, :RW].astype(np.int32)
    return (torch.from_numpy(out),
            torch.from_numpy(np.ascontiguousarray(sl)),
            torch.from_numpy(np.asarray(nseq).reshape(N).astype(np.int32)),
            torch.from_numpy(np.asarray(par).reshape(N, 8)
                             .astype(np.int32)))


def to_fused_layout(meta, exp, paths, VW: int, LW: int, RW: int):
    """The port's outputs -> `_fused_fn`'s (meta (N,4) int32, exp
    (N, 3*VW/128, 128) int16, paths (N, RW*LW/128, 128) int16)."""
    return to_win_layout(meta, exp, paths, VW, LW, RW)
