"""Batched per-round partial order alignment on the GPU, and the engine of
`--engine jax` built on it.

`poa_batch` aligns, for each task of a batch, one sequence against one POA
graph: the DP fill in topological row order, backpointer tables and a
lockstep traceback.  It is the port of the jitted XLA function
smoothxg_tpu/ops/poa_jax.py:_make_fn (`fill_and_trace`, reached through
`_compiled`), with the same inputs, outputs and tie rules; for CUDA tensors
it launches the hand-written kernel csrc/poa_batch.cu, for CPU tensors it
runs `poa_batch_reference`, the plain PyTorch version of the same function.
The two agree bit for bit, and both equal the XLA function wherever it is
exact: it computes local buckets of up to 8,199 columns in int16, and
there its G = hq + e * j wraps once (m + e) * j passes 32,767, which no
parameter set of the pipeline reaches (ROADMAP C9); the port computes in
int32 throughout.

Layout (the XLA function's; Vp and Lp the packed node count and sequence
width, P the predecessor slots, at most 16):
  base   (Vp, B)     int32  base of DP row v + 1 (topological rows)
  pred   (Vp, B, P)  int32  predecessor rows of row v + 1 (0 = the virtual
                            source); unused slots repeat slot 0
  seq    (B, Lp)     int32  sequence codes, -1 past slen
  slen   (B,)        int32  L
  nvalid (B,)        int32  V
  sink   (B, Vp + 1) bool   rows whose node has no successor (row 0 and
                            rows past nvalid: False)
  par    (B, 6)      int32  m, n, g, e, q, c
returns
  out    (B, S, 2)   int32  S = Vp + Lp + 5: the moves (row or -1, sequence
                            position or -1) from the end cell back to the
                            start, -9 past them
  outpos (B,)        int32  the move count
  bv     (B,)        int32  the best score (local: the best cell; global:
                            the best sink row at column slen)
Rows past nvalid and columns past slen never reach an output, so a task
may be packed into any larger (Vp, Lp).

`TorchBatchPOAEngine` is the port of poa_jax.JaxPOAEngine: the same
constructor arguments and host fallbacks, tasks packed by the launch's
real V and L instead of the XLA shape ladder.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve
from . import poa_host

NEG = -(1 << 30)
MAX_P = 16                 # 4-bit predecessor slot codes
MAX_L = 30000              # longer sequences go to the host (poa_jax :417)
MAX_LP = 65535             # csrc/poa_batch.cu keeps an F origin in 16 bits
NT = 256                   # csrc/poa_batch.cu: threads a block
BCPT = 4                   # columns a thread a tile


def task_words(Vp: int, Lp: int) -> int:
    """int32 words of one task's device scratch (csrc/poa_batch.cu:
    poa_batch_task_words): (Vp + 1) rows of Lp + 1 columns rounded up to
    4, 20 bytes a cell (H, E1, E2 and the packed backpointers; the two F
    origins)."""
    return 5 * (Vp + 1) * ((Lp + 4) & ~3)


def geometry(B: int, Vp: int, Lp: int) -> dict:
    """The launch geometry of a batch: a thread block a task, its rows in
    tiles of NT * BCPT columns, its scratch in device memory."""
    return {"grid": B, "threads": NT, "tile": NT * BCPT,
            "tiles": -(-(Lp + 1) // (NT * BCPT)),
            "scratch_bytes": 4 * B * task_words(Vp, Lp), "smem": "static"}


def _check_inputs(base, pred, seq, slen, nvalid, sink, par) -> None:
    if base.dim() != 2 or base.dtype != torch.int32:
        raise ValueError("base must be (Vp, B) int32")
    Vp, B = base.shape
    if pred.dim() != 3 or tuple(pred.shape[:2]) != (Vp, B) \
            or pred.dtype != torch.int32:
        raise ValueError("pred must be (Vp, B, P) int32")
    if not 1 <= pred.shape[2] <= MAX_P:
        raise ValueError(f"pred must have 1 to {MAX_P} slots")
    if seq.dim() != 2 or seq.shape[0] != B or seq.dtype != torch.int32:
        raise ValueError("seq must be (B, Lp) int32")
    if seq.shape[1] > MAX_LP:
        raise ValueError(f"seq must have at most {MAX_LP} columns (an F "
                         f"origin is a 16-bit column)")
    for name, t, shape, dt in (("slen", slen, (B,), torch.int32),
                               ("nvalid", nvalid, (B,), torch.int32),
                               ("sink", sink, (B, Vp + 1), torch.bool),
                               ("par", par, (B, 6), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}")
    ts = (base, pred, seq, slen, nvalid, sink, par)
    if len({t.device for t in ts}) != 1:
        raise ValueError("inputs on several devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")


def poa_batch(base, pred, seq, slen, nvalid, sink, par, local: bool):
    """Align every task's sequence to its graph.  CUDA tensors launch the
    kernel (and raise on any launch error); CPU tensors run the plain
    version.  Returns (out, outpos, bv) on the inputs' device."""
    dev = base.device
    if dev.type == "cpu":
        return poa_batch_reference(base, pred, seq, slen, nvalid, sink, par,
                                   local)
    _check_inputs(base, pred, seq, slen, nvalid, sink, par)
    if dev.type != "cuda":
        raise ValueError(f"poa_batch: unsupported device {dev}")
    from . import _build
    lib = _build.load()
    Vp, B = base.shape
    Lp, P = seq.shape[1], pred.shape[2]
    out = torch.empty((B, Vp + Lp + 5, 2), dtype=torch.int32, device=dev)
    outpos = torch.empty(B, dtype=torch.int32, device=dev)
    bv = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, outpos, bv
    scratch = torch.empty(B * task_words(Vp, Lp), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.poa_batch_launch(
            base.data_ptr(), pred.data_ptr(), seq.data_ptr(),
            slen.data_ptr(), nvalid.data_ptr(), sink.data_ptr(),
            par.data_ptr(), out.data_ptr(), outpos.data_ptr(), bv.data_ptr(),
            scratch.data_ptr(), B, Vp, Lp, P, int(local), stream)
    if rc != 0:
        msg = lib.poa_win_error_string(rc).decode()
        raise RuntimeError(f"poa_batch kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    poa_batch.launches += 1
    return out, outpos, bv


poa_batch.launches = 0     # kernel launches made by this wrapper


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def poa_batch_reference(base, pred, seq, slen, nvalid, sink, par,
                        local: bool):
    """The same function in plain PyTorch on the CPU: the fill vectorized
    over the batch and the columns, a row at a time, as the XLA function's
    scan is (the F prefix max as torch.cummax of int64 keys value * 2^32 +
    column, whose max takes the later column on ties); the traceback the
    same state machine, a task at a time.  The first-slot argmax over
    the predecessor rows is one max of keys value * 16 + (15 - slot)."""
    _check_inputs(base, pred, seq, slen, nvalid, sink, par)
    Vp, B = base.shape
    Lp = seq.shape[1]
    dev = base.device
    base, pred, seq, slen, nvalid, sink, par = (
        t.cpu().long() if t.dtype != torch.bool else t.cpu()
        for t in (base, pred, seq, slen, nvalid, sink, par))
    Lp1, S = Lp + 1, Vp + Lp + 5
    m, n, g, e, q, c = (par[:, k][:, None] for k in range(6))
    jx = torch.arange(Lp1)
    bidx = torch.arange(B)[:, None]
    # H, E1 and E2 of every row, side by side so a predecessor read is one
    # gather
    HE = torch.full((B, Vp + 1, 3, Lp1), NEG, dtype=torch.int64)
    if local:
        HE[:, 0, 0] = 0
    else:
        HE[:, 0, 0, 1:] = torch.maximum(-(g + (jx[1:] - 1) * e),
                                        -(q + (jx[1:] - 1) * c))
        HE[:, 0, 0, 0] = 0
    colmask = jx[None, :] <= slen[:, None]
    tabs = np.zeros((6, max(Vp, 1), B, Lp1), np.int32)
    bv = torch.full((B,), NEG, dtype=torch.int64)
    bi = torch.zeros(B, dtype=torch.int64)
    bj = torch.zeros(B, dtype=torch.int64)
    two32 = 1 << 32
    # max over the slots, ties to the first: keys value * 16 + (15 - slot)
    P = pred.shape[2]
    rank = (MAX_P - 1 - torch.arange(P))[None, :, None, None]
    for v in range(1, Vp + 1):
        km = (HE[bidx, pred[v - 1]] * MAX_P + rank).amax(1)   # [B, 3, Lp1]
        vals = torch.div(km, MAX_P, rounding_mode="floor")
        slot = MAX_P - 1 - (km - vals * MAX_P)
        Hpmax, pmH = vals[:, 0], slot[:, 0]
        M = torch.full((B, Lp1), NEG, dtype=torch.int64)
        M[:, 1:] = Hpmax[:, :-1] + torch.where(
            seq == base[v - 1][:, None], m, -n)
        mp = torch.zeros((B, Lp1), dtype=torch.int64)
        mp[:, 1:] = pmH[:, :-1]
        chans = []
        for k, op, ex in ((1, g, e), (2, q, c)):
            o, x = Hpmax - op, vals[:, k] - ex
            chans.append((torch.clamp(torch.maximum(o, x), min=NEG),
                          torch.where(o >= x, 16 | pmH, slot[:, k])))
        (e1, e1bp), (e2, e2bp) = chans
        hq = torch.maximum(M, torch.maximum(e1, e2))
        if local:
            hq = hq.clamp(min=0)
            kind = torch.where(hq == 0, 3, torch.where(
                M == hq, 0, torch.where(e1 == hq, 1, 2)))
        else:
            kind = torch.where(M == hq, 0, torch.where(e1 == hq, 1, 2))
        kp = torch.where(kind == 0, mp,
                         torch.where(kind == 1, e1bp & 15, e2bp & 15))
        Fs, fos = [], []
        for op, ex in ((g, e), (q, c)):
            keys = torch.cummax((hq + ex * jx) * two32 + jx, dim=1).values
            F = torch.full((B, Lp1), NEG, dtype=torch.int64)
            fo = torch.zeros((B, Lp1), dtype=torch.int64)
            F[:, 1:] = torch.div(keys[:, :-1], two32, rounding_mode="floor") \
                - op - ex * (jx[1:] - 1)
            fo[:, 1:] = keys[:, :-1] % two32
            Fs.append(F)
            fos.append(fo)
        Hrow = torch.maximum(hq, torch.maximum(*Fs))
        hsel = torch.where(Hrow == hq, 0, torch.where(Hrow == Fs[0], 1, 2))
        HE[:, v] = torch.stack((Hrow, e1, e2), 1)
        tabs[:, v - 1] = torch.stack(((kind << 4) | kp, hsel, e1bp, e2bp,
                                      *fos)).numpy()
        if local:
            vals = torch.where(colmask & (v <= nvalid)[:, None], Hrow, NEG)
            rmax, rarg = vals.amax(1), vals.argmax(1)
            better = rmax > bv
            bv = torch.where(better, rmax, bv)
            bi = torch.where(better, v, bi)
            bj = torch.where(better, rarg, bj)
    if not local:
        hcol = HE[torch.arange(B), :, 0, slen]            # [B, Vp + 1]
        hcol = torch.where(sink, hcol, NEG)
        bi, bv, bj = hcol.argmax(1), hcol.amax(1), slen
    out = np.full((B, S, 2), -9, np.int32)
    outpos = np.zeros(B, np.int32)
    pr = pred.numpy()
    for b in range(B):
        outpos[b] = _traceback(tabs[:, :, b], pr[:, b], int(bi[b]),
                               int(bj[b]), local and int(bv[b]) <= 0,
                               local, out[b])
    return (torch.from_numpy(out).to(dev),
            torch.from_numpy(outpos).to(dev), bv.to(torch.int32).to(dev))


def _traceback(tabs, pred, i: int, j: int, done: bool, local: bool,
               out) -> int:
    """One task's traceback (the XLA function's while_loop, a task at a
    time): tabs (6, Vp, Lp1) are hqbp, hsel, e1bp, e2bp, fo1, fo2 by row
    index - 1, pred (Vp, P); writes the moves into out (S, 2) and returns
    the move count."""
    hqbp, hsels, e1bp, e2bp, fo1s, fo2s = tabs
    S = out.shape[0]
    chan = ftgt = op = 0
    for _ in range(2 * S):
        if done:
            break
        ii = max(i - 1, 0)
        hsel, hqc = int(hsels[ii, j]), int(hqbp[ii, j])
        e1c, e2c = int(e1bp[ii, j]), int(e2bp[ii, j])
        kind = hqc >> 4
        i0 = i == 0
        in_H, in_HQ = chan == 0 and not i0, chan == 1 and not i0
        in_E1, in_E2, in_F = chan == 2, chan == 3, chan == 4
        at_src = chan <= 1 and i0
        emit_match = in_HQ and kind == 0
        emit_egap = in_E1 or in_E2
        f_step = in_F and j > ftgt
        src_ins = not local and at_src and j > 0
        src_done = at_src if local else at_src and j == 0
        zero_done = local and in_HQ and kind == 3
        emit_ins = f_step or src_ins
        if emit_match or emit_egap or emit_ins:
            if op < S:
                out[op] = (i if emit_match or emit_egap else -1,
                           j - 1 if emit_match or emit_ins else -1)
            op += 1
        nchan = chan
        if in_H:
            nchan = 1 if hsel == 0 else 4
            if hsel == 1:
                ftgt = int(fo1s[ii, j])
            elif hsel == 2:
                ftgt = int(fo2s[ii, j])
        if emit_match:
            nchan = 0
        if in_HQ and kind in (1, 2):
            nchan = kind + 1
        if in_E1:
            nchan = 0 if (e1c >> 4) & 1 else 2
        if in_E2:
            nchan = 0 if (e2c >> 4) & 1 else 3
        if in_F and not f_step:
            nchan = 1
        if src_ins:
            nchan = 0
        ni = i
        if emit_match:
            ni = int(pred[ii, hqc & 15])
        if in_E1:
            ni = int(pred[ii, e1c & 15])
        if in_E2:
            ni = int(pred[ii, e2c & 15])
        if emit_match or emit_ins:
            j -= 1
        i, chan = ni, nchan
        done = src_done or zero_done
    return op


# ---------------------------------------------------------------------------
# packing and decoding
# ---------------------------------------------------------------------------

def slots_for(maxp: int) -> int:
    """The XLA engine's predecessor slot buckets: 4, 8 or 16."""
    return 4 if maxp <= 4 else (8 if maxp <= 8 else MAX_P)


def pack_tasks(tasks, P: int | None = None, orders: list | None = None):
    """(graph, seq, params) tasks -> the (base, pred, seq, slen, nvalid,
    sink, par) CPU tensors of the XLA function's layout at the batch's
    real V and L (JaxPOAEngine._run_chunk's packing), and each task's
    topological order (`orders`, when the caller has them, else computed
    here).  P defaults to the slot bucket of the largest in-degree; a
    node keeps its first P predecessors."""
    B = len(tasks)
    if orders is None:
        orders = [g.topo_order() for g, _, _ in tasks]
    Vp = max([1] + [len(o) for o in orders])
    Lp = max([1] + [len(s) for _, s, _ in tasks])
    if P is None:
        P = slots_for(max([1] + [len(ps) for g, _, _ in tasks
                                 for ps in g.preds]))
    base = np.zeros((Vp, B), np.int32)
    pred = np.zeros((Vp, B, P), np.int32)
    seq = np.full((B, Lp), -1, np.int32)
    slen = np.zeros(B, np.int32)
    nvalid = np.zeros(B, np.int32)
    sink = np.zeros((B, Vp + 1), bool)
    par = np.zeros((B, 6), np.int32)
    for b, ((graph, sq, p), order) in enumerate(zip(tasks, orders)):
        V, L = len(order), len(sq)
        seq[b, :L] = sq
        slen[b], nvalid[b] = L, V
        par[b] = [p.m, p.n, p.g, p.e, p.q, p.c]
        if V == 0:
            continue
        order_a = np.asarray(order, np.int64)
        row_of = np.zeros(graph.n_nodes() + 1, np.int64)
        row_of[order_a] = np.arange(1, V + 1)
        base[:V, b] = np.asarray(graph.base, np.int32)[order_a]
        kept = np.fromiter((min(len(graph.preds[v]), P) for v in order),
                           np.int64, count=V)
        flat = np.fromiter((u for v in order for u in graph.preds[v][:P]),
                           np.int64, count=int(kept.sum()))
        rows = np.repeat(np.arange(V), kept)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(kept) - kept, kept)
        pm = np.zeros((V, P), np.int64)
        pm[rows, cols] = row_of[flat]
        # unused slots repeat the first predecessor (0: the source)
        pm = np.where(np.arange(P) < np.maximum(kept, 1)[:, None], pm,
                      pm[:, :1])
        pred[:V, b] = pm
        sink[b, 1:V + 1] = [not graph.succs[v] for v in order]
    tensors = tuple(torch.from_numpy(x) for x in
                    (base, pred, seq, slen, nvalid, sink, par))
    return tensors, orders


def decode_moves(out_row, k: int, order: list) -> list:
    """The first k moves of one task -> its alignment as (node | None,
    seq_pos | None) pairs in sequence order (JaxPOAEngine's decoding)."""
    return [(order[r - 1] if r >= 1 else None, int(sp) if sp >= 0 else None)
            for r, sp in np.asarray(out_row[:k])[::-1].tolist()]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class TorchBatchPOAEngine:
    """Round-level POA engine of `--engine jax` on the GPU: the port of
    smoothxg_tpu/ops/poa_jax.JaxPOAEngine, with its constructor arguments
    and `align_batch`.

    Tasks go to the host oracle (poa_host.align), counted in `fallbacks`
    and by reason, where JaxPOAEngine sends them there: an in-degree above
    `max_pred` (without `uniform_shape`), L > 30,000, or with
    `uniform_shape=(V, L)` a task past that shape ("max_pred", "long",
    "shape"); and where it would not equal the oracle (ROADMAP C7): banded
    params ("band"; the XLA function has no band) and, with
    `uniform_shape`, an in-degree above 16, which it truncates
    ("truncated").  Every other task runs on the kernel.  Tasks are sorted
    by size and packed by each launch's real V and L (the XLA shape ladder
    only limited recompiles), at most `max_batch` a launch and
    `cell_budget` DP cells (20 bytes each of device scratch)."""

    MAX_BATCH = 264            # two blocks an SM of a 132-SM card
    CELL_BUDGET = 256_000_000  # 5.1 GB of scratch a launch

    def __init__(self, max_pred: int = MAX_P,
                 cell_budget: int = CELL_BUDGET, max_batch: int = MAX_BATCH,
                 uniform_shape: tuple | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.max_pred = max_pred
        self.cell_budget = cell_budget
        self.max_batch = max_batch
        self.uniform_shape = uniform_shape
        self.fallbacks = 0
        self.fallback_reasons = {"max_pred": 0, "long": 0, "shape": 0,
                                 "band": 0, "truncated": 0}
        self.device_tasks = 0
        self.calls = 0
        self.kernel_launches = 0
        self.device_s = 0.0

    def stats(self) -> dict:
        return {"device_tasks": self.device_tasks,
                "fallbacks": self.fallbacks,
                "fallback_reasons": dict(self.fallback_reasons),
                "calls": self.calls,
                "kernel_launches": self.kernel_launches,
                "device_wait_s": round(self.device_s, 3)}

    def _route(self, graph, order, seq, p) -> str | None:
        """The reason a task goes to the host, or None for the kernel."""
        maxp = max((len(graph.preds[v]) for v in order), default=1)
        if (maxp > self.max_pred and self.uniform_shape is None) \
                or len(seq) > MAX_L:
            return "long" if len(seq) > MAX_L else "max_pred"
        if self.uniform_shape is not None:
            VB, LB = self.uniform_shape
            if len(order) > VB or len(seq) > LB:
                return "shape"
        return poa_host.c7_reason(p, maxp, MAX_P)

    def align_batch(self, tasks):
        results: list = [None] * len(tasks)
        orders: list = [None] * len(tasks)
        dev: dict[bool, list[int]] = {True: [], False: []}
        for t, (graph, seq, p) in enumerate(tasks):
            order = orders[t] = graph.topo_order()
            if not order or len(seq) == 0:
                results[t] = []
                continue
            why = self._route(graph, order, seq, p)
            if why is not None:
                results[t] = poa_host.align(graph, seq, p)
                self.fallbacks += 1
                self.fallback_reasons[why] += 1
                continue
            dev[bool(p.local)].append(t)
        for local, idxs in dev.items():
            for chunk in self._chunks(tasks, idxs):
                self._run_chunk(tasks, chunk, local, results, orders)
        return results

    def _chunks(self, tasks, idxs):
        """Launch-sized chunks of `idxs`, largest tasks first."""
        def dims(t):
            return tasks[t][0].n_nodes(), len(tasks[t][1])
        idxs = sorted(idxs, key=lambda t: dims(t)[0] * (dims(t)[1] + 1),
                      reverse=True)
        chunk: list[int] = []
        mv = ml = 0
        for t in idxs:
            V, L = dims(t)
            nv, nl = max(mv, V), max(ml, L)
            if chunk and (len(chunk) >= self.max_batch or
                          (len(chunk) + 1) * nv * (nl + 1)
                          > self.cell_budget):
                yield chunk
                chunk, nv, nl = [], V, L
            chunk.append(t)
            mv, ml = nv, nl
        if chunk:
            yield chunk

    def _run_chunk(self, tasks, chunk, local: bool, results,
                   orders) -> None:
        ins, orders = pack_tasks([tasks[t] for t in chunk],
                                 orders=[orders[t] for t in chunk])
        out, outpos, _ = poa_batch(*(x.to(self.device) for x in ins), local)
        if self.device.type == "cuda":
            self.kernel_launches += 1
        self.calls += 1
        t0 = time.perf_counter()
        out, outpos = out.cpu().numpy(), outpos.cpu().numpy()
        self.device_s += time.perf_counter() - t0
        self.device_tasks += len(chunk)
        for b, t in enumerate(chunk):
            results[t] = decode_moves(out[b], int(outpos[b]), orders[b])
