"""One round of partial order alignment on the GPU, and the engine of
`--engine pallas` built on it.

`poa_round` aligns, for each task of a batch, one sequence against one POA
graph: the sequence-vs-DAG DP fill, the end cell and a traceback that
emits packed move codes.  It is the port of the Pallas kernel
smoothxg_tpu/ops/poa_pallas.py:_pallas_fn; for CUDA tensors it launches the
hand-written kernel csrc/poa_round.cu, for CPU tensors it runs
`poa_round_reference`, the plain PyTorch version of the same function.  The
two agree bit for bit.  The semantics are those of the scalar oracle
ops/poa_host.py:align (int32 scores with the floor NEG = -2^30, where the
Pallas kernel clamps at -16000; the tie order is spelled out in
csrc/poa_round.cu).

Layout (the port's; B tasks, VW the batch's largest node count, LS its
longest sequence, P its largest in-degree):
  nv    (B,)        int32  V, the task's node count (0: an empty slot)
  slen  (B,)        int32  L, its sequence length
  par   (B, 6)      int32  m, n, g, e, q, c
  base  (B, VW)     uint8  base of DP row i at [b, i-1] (topological rows)
  sink  (B, VW)     uint8  1 where the row's node has no successor
  preds (B, VW, P)  int32  predecessor rows (0 = the virtual source row),
                           slots past the in-degree repeat the first
  seq   (B, LS)     uint8
returns
  codes (B, VW+LS+1) int64  ((i+2) << 32) | (j+2) per move, end to start,
                            0 past the task's move count (the Pallas
                            kernel's codes, widened so that no V or L
                            overflows them)
  meta  (B, 4)       int32  n_moves, best score, flag (1 stuck, 2 iteration
                            limit), 0
`from_pallas_layout` / `to_pallas_layout` convert from and to the Pallas
kernel's arrays so the tests feed both kernels the same inputs;
`to_pallas_inputs` packs the port's inputs into the Pallas kernel's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve
from . import poa_host

NEG = -(1 << 30)
SHIFT = 32
MASK = (1 << SHIFT) - 1
PALLAS_SHIFT = 15            # the Pallas kernel's int32 move-code packing
_INT_MIN = -(1 << 31)


def pack_tasks(tasks):
    """(graph, seq, params) tasks -> the port's (nv, slen, par, base, sink,
    preds, seq) CPU tensors and each task's topological order.  Predecessor
    slots are padded with the first predecessor, as
    PallasPOAEngine._pack pads them; P is the batch's largest in-degree."""
    B = len(tasks)
    orders = [g.topo_order() for g, _, _ in tasks]
    VW = max([1] + [len(o) for o in orders])
    LS = max([1] + [len(s) for _, s, _ in tasks])
    P = max([1] + [len(ps) for g, _, _ in tasks for ps in g.preds])
    nv = np.zeros(B, np.int32)
    slen = np.zeros(B, np.int32)
    par = np.zeros((B, 6), np.int32)
    base = np.zeros((B, VW), np.uint8)
    sink = np.zeros((B, VW), np.uint8)
    preds = np.zeros((B, VW, P), np.int32)
    seq = np.zeros((B, LS), np.uint8)
    for b, ((graph, sq, p), order) in enumerate(zip(tasks, orders)):
        V, L = len(order), len(sq)
        nv[b], slen[b] = V, L
        par[b] = [p.m, p.n, p.g, p.e, p.q, p.c]
        seq[b, :L] = sq
        if V == 0:
            continue
        order_a = np.asarray(order, np.int64)
        row_of = np.zeros(graph.n_nodes(), np.int64)
        row_of[order_a] = np.arange(1, V + 1)
        plens = np.fromiter((len(graph.preds[v]) for v in order), np.int64,
                            count=V)
        flat = np.fromiter((u for v in order for u in graph.preds[v]),
                           np.int64, count=int(plens.sum()))
        rows = np.repeat(np.arange(V), plens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(plens) - plens,
                                                plens)
        pm = preds[b, :V]
        pm[rows, cols] = row_of[flat]
        pm[:, :] = np.where(np.arange(P) < np.maximum(plens, 1)[:, None],
                            pm, pm[:, :1])
        base[b, :V] = np.asarray(graph.base, np.uint8)[order_a]
        sink[b, :V] = [0 if graph.succs[v] else 1 for v in order]
    tensors = tuple(torch.from_numpy(x)
                    for x in (nv, slen, par, base, sink, preds, seq))
    return tensors, orders


def _check_inputs(nv, slen, par, base, sink, preds, seq) -> None:
    if base.dim() != 2 or base.dtype != torch.uint8:
        raise ValueError("base must be (B, VW) uint8")
    B, VW = base.shape
    if seq.dim() != 2 or seq.shape[0] != B or seq.dtype != torch.uint8:
        raise ValueError("seq must be (B, LS) uint8")
    LS = seq.shape[1]
    if preds.dim() != 3 or tuple(preds.shape[:2]) != (B, VW) \
            or preds.dtype != torch.int32:
        raise ValueError("preds must be (B, VW, P) int32")
    for name, t, shape, dt in (("nv", nv, (B,), torch.int32),
                               ("slen", slen, (B,), torch.int32),
                               ("par", par, (B, 6), torch.int32),
                               ("sink", sink, (B, VW), torch.uint8)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}")
    ts = (nv, slen, par, base, sink, preds, seq)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    if VW < 1 or LS < 1 or preds.shape[2] < 1:
        raise ValueError("empty dimensions: VW, LS and P must be >= 1")


def poa_round(nv: torch.Tensor, slen: torch.Tensor, par: torch.Tensor,
              base: torch.Tensor, sink: torch.Tensor, preds: torch.Tensor,
              seq: torch.Tensor, local: bool):
    """Align every task's sequence to its graph.  CUDA tensors launch the
    kernel (and raise on any launch error); CPU tensors run the plain
    version.  Returns (codes, meta) on the inputs' device."""
    dev = base.device
    if dev.type == "cpu":
        return poa_round_reference(nv, slen, par, base, sink, preds, seq,
                                   local)
    _check_inputs(nv, slen, par, base, sink, preds, seq)
    if dev.type != "cuda":
        raise ValueError(f"poa_round: unsupported device {dev}")
    from . import _build
    lib = _build.load()
    B, VW = base.shape
    LS, P = seq.shape[1], preds.shape[2]
    codes = torch.zeros((B, VW + LS + 1), dtype=torch.int64, device=dev)
    meta = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B == 0:
        return codes, meta
    scratch = torch.empty(B * scratch_words(VW, LS), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.poa_round_launch(
            nv.data_ptr(), slen.data_ptr(), par.data_ptr(), base.data_ptr(),
            sink.data_ptr(), preds.data_ptr(), seq.data_ptr(),
            codes.data_ptr(), meta.data_ptr(), scratch.data_ptr(),
            B, VW, LS, P, int(local), stream)
    if rc != 0:
        msg = lib.poa_win_error_string(rc).decode()
        raise RuntimeError(f"poa_round kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    poa_round.launches += 1
    return codes, meta


poa_round.launches = 0     # kernel launches made by this wrapper


def scratch_words(VW: int, LS: int) -> int:
    """int32 words of one task's device scratch: the planes H, Hq, E1, E2 at
    (VW + 1) rows of LS + 1 columns rounded up to 4 (one int4 a thread),
    then a predecessor count per row (csrc/poa_round.cu:task_words)."""
    return 4 * (VW + 1) * ((LS + 4) & ~3) + ((VW + 3) & ~3)


def geometry(VW: int, LS: int, P: int) -> dict:
    """The launch geometry lib.poa_round_geometry gives tasks of these
    sizes on the current CUDA device: threads a block, whether rows are
    one tile with the ring of recent rows in shared memory, whether the
    sequence and the row tables sit in shared memory, dynamic shared bytes
    and blocks an SM."""
    import ctypes
    from . import _build
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    rc = lib.poa_round_geometry(VW, LS, P, out)
    if rc != 0:
        raise RuntimeError(f"poa_round geometry: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")
    return {"threads": out[0], "ring": bool(out[1]),
            "seq": "shared" if out[2] else "device",
            "tables": "shared" if out[3] else "device", "smem": out[4],
            "per_sm": out[5], "LS": LS}


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def poa_round_reference(nv, slen, par, base, sink, preds, seq, local: bool):
    """The same function in plain PyTorch on the CPU: each DP row is
    vectorized over its columns (torch.cummax for the F channels), as the
    numpy oracle fills it; the end cell and the traceback are scalar."""
    _check_inputs(nv, slen, par, base, sink, preds, seq)
    B, VW = base.shape
    LS = seq.shape[1]
    CW = VW + LS + 1
    codes = torch.zeros((B, CW), dtype=torch.int64)
    meta = torch.empty((B, 4), dtype=torch.int32)
    nvl, sll, prl = nv.tolist(), slen.tolist(), par.tolist()
    for b in range(B):
        V, L = nvl[b], sll[b]
        if V <= 0 or L <= 0:
            meta[b] = torch.tensor([0, NEG, 0, 0], dtype=torch.int32)
            continue
        moves, best, flag = _RefTask(
            V, L, prl[b], base[b, :V].cpu(), sink[b, :V].cpu(),
            preds[b, :V].cpu(), seq[b, :L].cpu(), local, CW).run()
        codes[b, :len(moves)] = torch.tensor(moves, dtype=torch.int64)
        meta[b] = torch.tensor([len(moves), best, flag, 0],
                               dtype=torch.int32)
    return codes.to(base.device), meta.to(base.device)


def _code(i: int, j: int) -> int:
    return ((i + 2) << SHIFT) | (j + 2)


class _RefTask:
    """One task of the plain version."""

    def __init__(self, V, L, par, base, sink, preds, seq, local, CW):
        self.V, self.L, self.local, self.CW = V, L, local, CW
        self.m, self.n, self.g, self.e, self.q, self.c = par
        self.base = base.to(torch.int32)
        self.sink = sink.tolist()
        self.seq = seq.to(torch.int32)
        # real predecessor rows: slots past the in-degree repeat slot 0
        self.rp = []
        for row in preds.tolist():
            k = 1
            while k < len(row) and row[k] != row[0]:
                k += 1
            self.rp.append(row[:k])

    def run(self):
        best, ei, ej = self._fill()
        if self.local and best <= 0:
            return [], best, 0
        moves, flag = self._traceback(ei, ej)
        return moves, best, flag

    def _fill(self):
        V, L = self.V, self.L
        m, n, g, e, q, c = self.m, self.n, self.g, self.e, self.q, self.c
        j = torch.arange(L + 1, dtype=torch.int32)
        # channels of PL: 0 = H, 1 = E1, 2 = E2, 3 = Hq, so a predecessor
        # read is one slice
        PL = torch.empty((V + 1, 4, L + 1), dtype=torch.int32)
        PL[0, 1:3] = NEG
        if self.local:
            PL[0, 0] = 0
            PL[0, 3] = 0
        else:
            PL[0, 0] = torch.maximum(-(g + (j - 1) * e), -(q + (j - 1) * c))
            PL[0, 0, 0] = 0
            PL[0, 3] = NEG
            PL[0, 3, 0] = 0
        best, brow = _INT_MIN, 0
        for i in range(1, V + 1):
            prs = self.rp[i - 1]
            X = PL[prs[0], :3] if len(prs) == 1 else PL[prs, :3].amax(0)
            hp, x1, x2 = X[0], X[1], X[2]
            M = torch.full((L + 1,), NEG, dtype=torch.int32)
            M[1:] = hp[:-1] + torch.where(self.seq == self.base[i - 1], m,
                                          -n).to(torch.int32)
            e1 = torch.maximum(hp - g, x1 - e).clamp_(min=NEG)
            e2 = torch.maximum(hp - q, x2 - c).clamp_(min=NEG)
            hq = torch.maximum(M, torch.maximum(e1, e2))
            if self.local:
                hq.clamp_(min=0)
            Hrow = hq.clone()
            for op, ex in ((g, e), (q, c)):
                G = torch.cummax(hq + ex * j, dim=0).values
                Hrow[1:] = torch.maximum(Hrow[1:],
                                         G[:-1] - op - ex * (j[1:] - 1))
            PL[i, 0], PL[i, 1], PL[i, 2], PL[i, 3] = Hrow, e1, e2, hq
            if self.local:
                rmax = int(Hrow.max())
                if rmax > best:
                    best, brow = rmax, i
        self.H = PL[:, 0].numpy()
        self.E1 = PL[:, 1].numpy()
        self.E2 = PL[:, 2].numpy()
        self.Hq = PL[:, 3].numpy()
        if self.local:
            return best, brow, int(np.flatnonzero(self.H[brow] == best)[0])
        hb, hr = _INT_MIN, 0
        for i in range(1, V + 1):
            if self.sink[i - 1] and int(self.H[i, L]) > hb:
                hb, hr = int(self.H[i, L]), i
        return hb, hr, L

    def _traceback(self, i, j):
        H, Hq, E1, E2 = self.H, self.Hq, self.E1, self.E2
        m, n, g, e, q, c = self.m, self.n, self.g, self.e, self.q, self.c
        seq = self.seq.tolist()
        base = self.base.tolist()
        CW, local = self.CW, self.local
        lim = 2 * CW + 16
        out = []
        chan = 0                  # 0 = H, 1 = Hq, 2 = E1, 3 = E2
        val = int(H[i, j])
        it = 0
        while True:
            if it >= lim or len(out) >= CW:
                return out, 2
            it += 1
            if chan <= 1:
                if local and val == 0:
                    return out, 0
                if i == 0:
                    if j == 0:
                        return out, 0
                    out.append(_code(-1, j - 1))    # leading insertion
                    j -= 1
                    val = int(H[0, j])
                    chan = 0
                    continue
                prs = self.rp[i - 1]
                if j > 0:
                    subv = m if seq[j - 1] == base[i - 1] else -n
                    pr = next((p for p in prs
                               if int(H[p, j - 1]) + subv == val), None)
                    if pr is not None:
                        out.append(_code(i, j - 1))
                        i, j, chan = pr, j - 1, 0
                        val = int(H[i, j])
                        continue
                if int(E1[i, j]) == val:
                    chan = 2
                    continue
                if int(E2[i, j]) == val:
                    chan = 3
                    continue
                if chan == 0:
                    k = next((k for k in range(j - 1, -1, -1)
                              if int(Hq[i, k]) - g - (j - 1 - k) * e == val
                              or int(Hq[i, k]) - q - (j - 1 - k) * c == val),
                             None)
                    if k is not None:
                        if len(out) + (j - k) > CW:
                            return out, 2
                        out.extend(_code(-1, t)
                                   for t in range(j - 1, k - 1, -1))
                        j, chan = k, 1
                        val = int(Hq[i, j])
                        continue
                return out, 1                       # stuck: cannot happen
            op, ex, Em = (g, e, E1) if chan == 2 else (q, c, E2)
            prs = self.rp[i - 1]
            out.append(_code(i, -1))
            pr = next((p for p in prs if int(H[p, j]) - op == val), None)
            if pr is not None:
                i, chan = pr, 0
                val = int(H[i, j])
                continue
            pr = next((p for p in prs if int(Em[p, j]) - ex == val), None)
            if pr is None:
                return out, 1                       # broken E chain
            i = pr
            val = int(Em[i, j])


def decode_moves(codes_row, n: int, order: list) -> list:
    """The first n codes of one task -> its alignment as (node | None,
    seq_pos | None) pairs in sequence order (PallasPOAEngine._decode)."""
    arr = np.asarray(codes_row[:n])[::-1]
    rs = ((arr >> SHIFT) - 2).tolist()
    sps = ((arr & MASK) - 2).tolist()
    return [(order[r - 1] if r >= 1 else None, sp if sp >= 0 else None)
            for r, sp in zip(rs, sps)]


# ---------------------------------------------------------------------------
# conversion from / to the Pallas kernel's arrays
# ---------------------------------------------------------------------------

def from_pallas_layout(slen, nv, par, ninfo, seq, P: int):
    """The Pallas kernel's inputs (numpy, as PallasPOAEngine._pack packs
    them: slen, nv (B,1,1) int32; par (B,1,6) int32; ninfo (B, (2+P)*VW/128,
    128) int16 holding base, sink and P predecessor-row planes; seq
    (B,1,LW) int8 with char j at lane j+1) -> the port's (nv, slen, par,
    base, sink, preds, seq) CPU tensors with the same VW and LS = LW - 1."""
    B = int(np.asarray(nv).shape[0])
    planes = np.asarray(ninfo).reshape(B, 2 + P, -1).astype(np.int32)
    s = np.asarray(seq).reshape(B, -1)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        np.asarray(nv).reshape(B).astype(np.int32),
        np.asarray(slen).reshape(B).astype(np.int32),
        np.asarray(par).reshape(B, 6).astype(np.int32),
        planes[:, 0].astype(np.uint8), planes[:, 1].astype(np.uint8),
        planes[:, 2:].transpose(0, 2, 1),
        s[:, 1:].view(np.uint8)))


def to_pallas_inputs(nv, slen, par, base, sink, preds, seq):
    """The port's round inputs -> the Pallas kernel's (slen, nv, par,
    ninfo, seq) numpy arrays (from_pallas_layout's inverse), VW rounded up
    to 128 lanes, LW = LS + 1; for callers that take the Pallas layout
    (parallel/mesh.sharded_pallas_round) fed from pack_tasks."""
    B, VW = base.shape
    P = preds.shape[2]
    VWp = -(-VW // 128) * 128
    planes = np.zeros((B, 2 + P, VWp), np.int16)
    planes[:, 0, :VW] = base.numpy()
    planes[:, 1, :VW] = sink.numpy()
    planes[:, 2:, :VW] = preds.numpy().transpose(0, 2, 1)
    s = np.full((B, 1, seq.shape[1] + 1), -1, np.int8)
    s[:, 0, 1:] = seq.numpy().view(np.int8)
    return (slen.numpy().reshape(B, 1, 1).astype(np.int32),
            nv.numpy().reshape(B, 1, 1).astype(np.int32),
            par.numpy().reshape(B, 1, 6).astype(np.int32),
            planes.reshape(B, -1, 128), s)


def to_pallas_layout(codes, meta, S: int):
    """The port's outputs -> `_pallas_fn`'s (codes (B, S) int32 packed
    ((i+2) << 15) | (j+2), meta (B, 4) int32); codes past each task's move
    count are 0.  Raises where a move does not fit that packing."""
    codes, meta = codes.cpu().numpy(), meta.cpu().numpy()
    rows, cols = codes >> SHIFT, codes & MASK
    out = np.zeros((codes.shape[0], S), np.int32)
    for b, k in enumerate(meta[:, 0].tolist()):
        if k and (rows[b, :k].max() >= 1 << 16
                  or cols[b, :k].max() >= 1 << PALLAS_SHIFT):
            raise ValueError(f"task {b}: a move does not fit the Pallas "
                             f"kernel's 15/16-bit code packing")
        out[b, :k] = (rows[b, :k] << PALLAS_SHIFT) | cols[b, :k]
    return out, meta.astype(np.int32)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class TorchRoundPOAEngine:
    """Round-level POA engine on the GPU: the port of
    smoothxg_tpu/ops/poa_pallas.PallasPOAEngine, with the interface
    smooth_blocks probes for (align_batch_async, finish, align_batch,
    max_batch, warmup, stats).

    Every task of a round goes to the kernel, whatever its V, L and
    in-degree, except two kinds, which go to the host oracle
    (poa_host.align) and are counted: tasks with banded params (wb >= 0;
    the kernel, like _pallas_fn, has no band) in fallback_reasons["band"],
    and tasks the kernel flags (stuck traceback, iteration limit) in
    stuck_fallbacks.  Launches are asynchronous: `finish` copies back and decodes.  A launch holds at
    most `max_batch` tasks (132: one wave on a 132-SM card, where the
    kernel's ring of recent rows leaves room for 1-3 tasks an SM at the
    main path's rows of ~1 kb, and more than a round of the main path
    holds, at most 128) and what SCRATCH_BUDGET
    bytes of DP planes hold at 16 B per cell, its tasks padded to the
    launch's largest V and L (tasks are sorted by size first)."""

    MAX_BATCH = 132
    SCRATCH_BUDGET = 16 << 30

    def __init__(self, device: str | torch.device = "cuda",
                 max_batch: int = MAX_BATCH):
        self.device = resolve(device)
        self.max_batch = max_batch
        self.fallbacks = 0
        self.fallback_reasons = {"band": 0}
        self.stuck_fallbacks = 0
        self.device_tasks = 0
        self.calls = 0
        self.kernel_launches = 0
        self.device_s = 0.0          # blocking time waiting on device results
        self.bucket_tasks = {"local": 0, "global": 0}

    def warmup(self, locals_=(True,)):
        """Build the kernel library and launch each requested variant once
        on a one-task batch."""
        if self.device.type != "cuda":
            return
        one = [torch.ones(1, dtype=torch.int32),
               torch.ones(1, dtype=torch.int32),
               torch.tensor([[1, 4, 6, 2, 26, 1]], dtype=torch.int32),
               torch.zeros((1, 1), dtype=torch.uint8),
               torch.ones((1, 1), dtype=torch.uint8),
               torch.zeros((1, 1, 1), dtype=torch.int32),
               torch.zeros((1, 1), dtype=torch.uint8)]
        one = [x.to(self.device) for x in one]
        for local in locals_:
            poa_round(*one, local)
            self.kernel_launches += 1
        torch.cuda.synchronize(self.device)

    def stats(self) -> dict:
        return {
            "device_tasks": self.device_tasks,
            "fallbacks": self.fallbacks,
            "fallback_reasons": dict(self.fallback_reasons),
            "stuck_fallbacks": self.stuck_fallbacks,
            "calls": self.calls,
            "device_wait_s": round(self.device_s, 3),
            "bucket_tasks": dict(self.bucket_tasks),
            "kernel_launches": self.kernel_launches,
        }

    def align_batch_async(self, tasks):
        """Launch all device work for `tasks` and return a handle; host
        fallbacks are computed eagerly.  Launches do not wait for the
        device, so the caller can do host work before finish(handle)."""
        results: list = [None] * len(tasks)
        dev: dict[bool, list[int]] = {True: [], False: []}
        for t, (graph, seq, p) in enumerate(tasks):
            if graph.n_nodes() == 0 or len(seq) == 0:
                results[t] = []
                continue
            why = poa_host.c7_reason(p)
            if why is not None:
                results[t] = poa_host.align(graph, seq, p)
                self.fallbacks += 1
                self.fallback_reasons[why] += 1
                continue
            dev[bool(p.local)].append(t)
        inflight = []
        for local, idxs in dev.items():
            for chunk in self._chunks(tasks, idxs):
                inflight.append(self._launch(tasks, chunk, local))
        return results, inflight

    def finish(self, handle):
        """Block on and decode a handle from align_batch_async."""
        results, inflight = handle
        for h in inflight:
            self._decode(h, results)
        return results

    def align_batch(self, tasks):
        return self.finish(self.align_batch_async(tasks))

    def _chunks(self, tasks, idxs):
        """Launch-sized chunks of `idxs`, largest tasks first."""
        def dims(t):
            return tasks[t][0].n_nodes(), len(tasks[t][1])
        idxs = sorted(idxs, key=lambda t: (dims(t)[0] + 1) * (dims(t)[1] + 1),
                      reverse=True)
        chunk: list[int] = []
        mv = ml = 0
        for t in idxs:
            V, L = dims(t)
            nv_, nl_ = max(mv, V), max(ml, L)
            if chunk and (len(chunk) >= self.max_batch or
                          16 * (len(chunk) + 1) * (nv_ + 1) * (nl_ + 1)
                          > self.SCRATCH_BUDGET):
                yield chunk
                chunk, nv_, nl_ = [], V, L
            chunk.append(t)
            mv, ml = nv_, nl_
        if chunk:
            yield chunk

    def _launch(self, tasks, chunk, local):
        ins, orders = pack_tasks([tasks[t] for t in chunk])
        codes, meta = poa_round(*(x.to(self.device) for x in ins), local)
        if self.device.type == "cuda":
            self.kernel_launches += 1
        self.calls += 1
        self.bucket_tasks["local" if local else "global"] += len(chunk)
        return tasks, chunk, orders, codes, meta

    def _decode(self, handle, results):
        tasks, chunk, orders, codes, meta = handle
        t0 = time.perf_counter()
        meta = meta.cpu().numpy()
        codes = codes.cpu().numpy()
        self.device_s += time.perf_counter() - t0
        self.device_tasks += len(chunk)
        for b, t in enumerate(chunk):
            if meta[b, 2] != 0:
                # a flagged traceback would thread a truncated alignment
                # into the graph: recompute on the host oracle (counted)
                graph, sq, p = tasks[t]
                results[t] = poa_host.align(graph, sq, p)
                self.stuck_fallbacks += 1
                continue
            results[t] = decode_moves(codes[b], int(meta[b, 0]), orders[b])
