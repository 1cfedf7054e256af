"""Whole-block partial order alignment on the GPU.

`poa_win` runs, for each block of a batch, the whole fused POA loop of
smoothxg_tpu/ops/poa_fused.FusedPOA: seed a chain from sequence 0, then for
every later sequence fill the sequence-vs-DAG DP in topological order, trace
it back and thread the sequence into the graph.  It is the port of the
windowed Pallas kernel smoothxg_tpu/ops/poa_pallas_win.py:_win_core (wrapper
`_win_fn`); for CUDA tensors it launches the hand-written kernel
csrc/poa_win.cu, for CPU tensors it runs `poa_win_reference`, the plain
PyTorch version of the same function.  The two agree bit for bit, the
overflow flag included.

Semantics (the oracle is FusedPOA + ops/poa_host; native/cpoa.cpp is its
C++ twin):
  * int32 scores with the floor NEG = -2^30 — no int16 clamp;
  * F channels in closed form: F(j) = max_{k<j}(hq(k) + ext*k) - open -
    ext*(j-1), a prefix max over the row;
  * traceback by value re-derivation (first predecessor slot that
    reproduces the value; M before E1 before E2 before F; F origins
    nearest-first, channel 1 before channel 2);
  * guarded aligned-ring threading with RING_CAP candidates and deferred
    ring splices.

Storage: each DP row stores W columns from a per-row offset.  Unbanded rows
use offset 0 and need W >= L + 1; banded rows (abPOA adaptive band) start
their window at the band floor, which is exact because every cell outside
the band is the floor.  (The kernel stores an unbanded row at the launch's
row stride LS, `row_stride`: the batch's longest sequence + 1, rounded up
to 32, so its scratch follows the batch; its graph tables hold node ids in
int16, so VW is at most `VW_MAX` there.)  Capacities are arguments
(`WinCaps`) and are the same for the kernel and the plain version.  A
block overflows — meta[1] = 1,
and the caller redoes it on the native engine — when:
  * a sequence does not fit (L0 > VW, L > LW - 1, or L + 1 > W unbanded);
  * threading would create node VW + 1;
  * a node would get predecessor pcap + 1;
  * a banded row's band is wider than W;
  * the traceback gets stuck (cannot happen with a correct fill).
An overflowed block's outputs are canonical: meta = [0, 1, nseq, 0] and -1
everywhere in exp and paths.

Layout (the port's, not the TPU's):
  seqs   (B, RW, LW) int8   char j of sequence r at [b, r, j]
  slen   (B, RW)     int32
  nseq   (B,)        int32
  params (B, 8)      int32  m, n, g, e, q, c, wb, wf_milli
returns
  meta   (B, 4)      int32  V, ovf, rounds (= nseq), guard_splits
  exp    (B, 3, VW)  int32  base / ring / topo order per node, -1 past V
  paths  (B, RW, LW) int32  node id per sequence position, -1 elsewhere
`from_win_layout` / `to_win_layout` convert from and to the Pallas
kernel's packed planes so the tests compare like with like.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG = -(1 << 30)
RING_CAP = 8
# predecessor slots per node: the kernel's limit (csrc/poa_win.cu
# PCAP_MAX), not the TPU's 4; blocks at pggb's depth (-r = the haplotype
# count) have more alleles a site: at 4 slots 2 of 4 blocks of 64-96
# sequences overflowed to the native engine, at 8 none (chip smoke phase 24)
PCAP = 8
VW_MAX = 32766     # node ids and rows are int16 in the kernels' tables
# columns of a DP row one thread block fills at a time (csrc/poa_common.cuh:
# 256 threads x 8 columns); poa_win fills a stored row past one tile on a
# cluster of thread blocks, one a tile, up to CLUSTER_MAX (the card's
# non-portable limit: rows to 32,768 columns)
TILE = 2048
CLUSTER_MAX = 16


def table_bytes(VW: int, pcap: int, LS: int, banded: bool) -> int:
    """Bytes of one block's graph tables at row stride LS: int16 node,
    row and target tables, int8 bases and counts, padded to 16
    (csrc/poa_graph.cuh:table_bytes)."""
    v1 = VW + 1
    w16 = (4 + 2 * pcap + (4 if banded else 0)) * v1 + 3 * LS
    return (2 * w16 + 5 * v1 + 15) & ~15


def check_nodes(caps) -> None:
    if caps.VW > VW_MAX:
        raise ValueError(f"the whole-block kernels hold node ids in int16: "
                         f"VW {caps.VW} > {VW_MAX}")


@dataclass(frozen=True)
class WinCaps:
    """Capacities and variant of one launch (shared by kernel and plain
    version, so both overflow on exactly the same blocks)."""
    VW: int              # node capacity
    LW: int              # sequence capacity: columns 0..LW-1, L <= LW - 1
    W: int               # stored DP columns per row (W = LW: full width)
    local: bool
    banded: bool
    pcap: int = PCAP     # predecessor slots per node

    def stored(self, LS: int) -> int:
        """Stored columns of a DP row at row stride LS: LS at full
        width, else the window W rounded up to 8 (csrc/poa_win.cu:
        row_stride)."""
        return (self.W + 7) & ~7 if self.banded else LS

    def scratch_words(self, LS: int) -> int:
        """int32 words of per-block scratch at row stride LS: the graph
        tables, then the four DP planes H, Hq, E1, E2 at 16 B a cell
        (csrc/poa_win.cu:block_bytes).  The cluster route needs none
        more: its hand-offs go through shared memory."""
        return (table_bytes(self.VW, self.pcap, LS, self.banded)
                + 16 * (self.VW + 1) * self.stored(LS)) // 4

    def cluster(self, LS: int, tile: int = TILE) -> int:
        """Thread blocks a POA block runs on at row stride LS: 1 (one
        thread block, tile after tile) for stored rows of one tile, else
        one a tile (the cluster route; csrc/poa_win.cu:cluster_size)."""
        s = self.stored(LS)
        return -(-s // tile) if s > tile else 1


def pack_blocks(blocks, LW: int):
    """(sequences, POAParams) per block -> the port's (seqs, slen, nseq,
    params) CPU tensors; RW is the largest sequence count of the batch."""
    B = len(blocks)
    RW = max(len(sq) for sq, _ in blocks)
    seqs = np.full((B, RW, LW), -1, np.int8)
    slen = np.zeros((B, RW), np.int32)
    nseq = np.zeros(B, np.int32)
    par = np.zeros((B, 8), np.int32)
    for b, (sq, p) in enumerate(blocks):
        nseq[b] = len(sq)
        par[b] = [p.m, p.n, p.g, p.e, p.q, p.c, max(p.wb, 0), p.wf_milli]
        for r, s in enumerate(sq):
            slen[b, r] = len(s)
            seqs[b, r, :len(s)] = np.asarray(s, np.uint8).view(np.int8)
    return tuple(torch.from_numpy(x) for x in (seqs, slen, nseq, par))


def _check_inputs(seqs, slen, nseq, params, caps: WinCaps) -> None:
    if seqs.dim() != 3 or seqs.dtype != torch.int8:
        raise ValueError("seqs must be (B, RW, LW) int8")
    B, RW, LW = seqs.shape
    if LW != caps.LW:
        raise ValueError(f"seqs width {LW} != caps.LW {caps.LW}")
    if tuple(slen.shape) != (B, RW) or slen.dtype != torch.int32:
        raise ValueError("slen must be (B, RW) int32")
    if tuple(nseq.shape) != (B,) or nseq.dtype != torch.int32:
        raise ValueError("nseq must be (B,) int32")
    if tuple(params.shape) != (B, 8) or params.dtype != torch.int32:
        raise ValueError("params must be (B, 8) int32")
    devs = {t.device for t in (seqs, slen, nseq, params)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if not all(t.is_contiguous() for t in (seqs, slen, nseq, params)):
        raise ValueError("inputs must be contiguous")
    if not (1 <= caps.pcap <= 8 and caps.VW >= 1 and caps.W >= 1
            and caps.LW >= 2 and caps.VW < (1 << 30)):
        raise ValueError(f"bad capacities {caps}")
    if caps.banded and caps.W > caps.LW:
        raise ValueError("banded window wider than the sequence capacity")


def poa_win(seqs: torch.Tensor, slen: torch.Tensor, nseq: torch.Tensor,
            params: torch.Tensor, caps: WinCaps):
    """Run the whole POA loop of every block.  CUDA tensors launch the
    kernel (and raise on any launch error); CPU tensors run the plain
    version.  Returns (meta, exp, paths) on the inputs' device."""
    _check_inputs(seqs, slen, nseq, params, caps)
    if seqs.device.type == "cpu":
        return poa_win_reference(seqs, slen, nseq, params, caps)
    check_nodes(caps)
    LS = row_stride(slen, caps.LW)
    if caps.cluster(LS) > CLUSTER_MAX:
        raise ValueError(f"poa_win stores rows of at most {CLUSTER_MAX} "
                         f"tiles ({CLUSTER_MAX * TILE} columns): "
                         f"{caps.stored(LS)}")
    out = launch("poa_win", seqs, slen, nseq, params, caps,
                 caps.scratch_words(LS), caps.W, caps.pcap, LS)
    poa_win.launches += 1
    return out


poa_win.launches = 0     # kernel launches made by this wrapper


def stride_for(maxl: int, LW: int) -> int:
    """Row stride of the whole-block kernels' full-width DP planes for a
    launch whose longest sequence is `maxl`: maxl (capped at LW - 1, the
    longest that fits) + 1, rounded up to 32 columns."""
    return -(-(min(max(maxl, 0), LW - 1) + 1) // 32) * 32


def row_stride(slen: torch.Tensor, LW: int) -> int:
    """`stride_for` the longest length in any slot of `slen` (read on the
    host)."""
    return stride_for(int(slen.max()) if slen.numel() else 0, LW)


def geometry(name: str, B: int, caps, LS: int) -> dict:
    """The launch geometry lib.<name>_geometry gives a whole-block kernel's
    launch of B blocks at `caps` and row stride LS on the current CUDA
    device: POA blocks per thread block, grid, dynamic shared bytes, where
    the graph tables sit ("shared" or "device"), thread blocks a POA block
    (`cluster`: poa_win's cluster route past one tile, else 1) and where
    the cluster route keeps its row metadata."""
    import ctypes
    from . import _build
    lib = _build.load()
    out = (ctypes.c_int * 6)(0, 0, 0, 0, 1, 0)
    shape = (caps.VW, caps.W) if name == "poa_win" else (caps.VW,)
    rc = getattr(lib, f"{name}_geometry")(B, *shape, caps.pcap, LS,
                                          int(caps.banded), out)
    if rc != 0:
        raise RuntimeError(f"{name} geometry: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")
    return {"per_block": out[0], "grid": out[1], "smem": out[2],
            "tables": "shared" if out[3] else "device", "LS": LS,
            "cluster": out[4], "meta": "shared" if out[5] else "device"}


def launch(name: str, seqs, slen, nseq, params, caps, words: int, *extra):
    """Allocate the outputs and `words` int32 of scratch per block, launch
    lib.<name>_launch(inputs, outputs, scratch, B, RW, LW, VW, *extra,
    local, banded, stream) on the current stream and raise on a launch
    error (the whole-block kernels' shared C interface; the extras end with
    the launch's row stride, `row_stride`)."""
    dev = seqs.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    from . import _build
    lib = _build.load()
    B, RW, LW = seqs.shape
    if B > 0 and int(nseq.max()) > RW:
        raise ValueError("nseq exceeds the RW sequence slots")
    meta = torch.empty((B, 4), dtype=torch.int32, device=dev)
    exp = torch.empty((B, 3, caps.VW), dtype=torch.int32, device=dev)
    paths = torch.empty((B, RW, LW), dtype=torch.int32, device=dev)
    if B == 0:
        return meta, exp, paths
    scratch = torch.empty(B * words, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, f"{name}_launch")(
            seqs.data_ptr(), slen.data_ptr(), nseq.data_ptr(),
            params.data_ptr(), meta.data_ptr(), exp.data_ptr(),
            paths.data_ptr(), scratch.data_ptr(),
            B, RW, LW, caps.VW, *extra, int(caps.local), int(caps.banded),
            stream)
    if rc != 0:
        msg = lib.poa_win_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    return meta, exp, paths


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def poa_win_reference(seqs: torch.Tensor, slen: torch.Tensor,
                      nseq: torch.Tensor, params: torch.Tensor,
                      caps: WinCaps):
    """The same function in plain PyTorch on the CPU: each DP row is
    vectorized over its columns (torch.cummax for the F channels); the
    topological walk, traceback and threading are scalar."""
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
        res = _RefBlock(sq[b], sl[b][:max(ns[b], 0)], pr[b], caps).run()
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


class _Overflow(Exception):
    """Capacity overflow: the block's result is discarded (meta[1] = 1)."""


class _RefBlock:
    """One block's POA loop in the plain version.  `stage` is the
    code-chase kernels' profiling knob (ops/poa_code.py; poa_win has
    none): 1 stops each round at the end cell, 2 after the traceback, 3
    threads without the ring scan past the target, 4 without node
    creation or edge bookkeeping."""

    def __init__(self, seqs_b: torch.Tensor, lens: list, par: list,
                 caps: WinCaps, stage: int = 0):
        self.seqs = seqs_b
        self.lens = lens
        self.m, self.n, self.g, self.e, self.q, self.c, self.wb, \
            self.wfm = par
        self.caps = caps
        self.stage = stage

    def run(self):
        try:
            return self._run()
        except _Overflow:
            return None

    def _run(self):
        caps, lens = self.caps, self.lens
        VW, LW, W = caps.VW, caps.LW, caps.W
        if not lens or lens[0] < 1 or lens[0] > VW or max(lens) > LW - 1:
            raise _Overflow
        if not caps.banded and max(lens) + 1 > W:
            raise _Overflow
        # planes sized to what this block can touch: V <= sum of lengths,
        # and unbanded rows never reach past column max(L).  Channels of
        # P: 0 = H, 1 = E1, 2 = E2, 3 = Hq, so a predecessor read is one
        # slice.
        rows = min(VW, sum(lens)) + 1
        self.Wa = self._stored_width(lens)
        self.P = torch.empty((rows, 4, self.Wa), dtype=torch.int32)
        self.H, self.E1, self.E2, self.Hq = (self.P[:, t] for t in range(4))
        self.ar = torch.arange(max(LW, W) + 1, dtype=torch.int32)
        j = self.ar[:self.Wa]
        self.P[0, 1:] = NEG
        if caps.local:
            self.H[0] = 0
            self.Hq[0] = 0
        else:
            self.H[0] = torch.maximum(-(self.g + (j - 1) * self.e),
                                      -(self.q + (j - 1) * self.c))
            self.H[0, 0] = 0
            self.Hq[0, 0] = 0
        # seed: sequence 0 becomes a chain
        L0 = lens[0]
        s0 = self.seqs[0, :L0].tolist()
        self.base = s0 + [0] * (VW - L0)
        self.pos = list(range(L0)) + [-1] * (VW - L0)
        self.ring = list(range(VW))
        self.nxt = [v + 1 for v in range(L0 - 1)] + [-1] * (VW - L0 + 1)
        self.preds = [[v - 1] if v >= 1 else [] for v in range(L0)] + \
            [[] for _ in range(VW - L0)]
        self.nsucc = [1] * (L0 - 1) + [0] * (VW - L0 + 1)
        self.head = 0
        self.Vc = L0
        self.gs = 0
        out_paths = [list(range(L0))]
        for r in range(1, len(lens)):
            L = lens[r]
            if L == 0:
                out_paths.append([])
                continue
            seq = self.seqs[r, :L]
            target = self._align(seq, L)
            if self.stage in (1, 2):
                out_paths.append([])      # no threading: the graph stays
                continue
            out_paths.append(self._thread(target, seq.tolist(), L))
        order = self._walk()
        V = self.Vc
        return (V, self.gs, self.base[:V], self.ring[:V], order,
                out_paths)

    def _stored_width(self, lens: list) -> int:
        """Columns of the planes: the window, or (unbanded) what the
        longest sequence can touch."""
        W = self.caps.W
        return W if self.caps.banded else min(W, max(lens) + 1)

    def _offsets(self, blo: list) -> list:
        """First stored column of each row: the band floor (row 0 stores
        [0, W))."""
        off = list(blo)
        off[0] = 0
        return off

    def _walk(self) -> list:
        order = []
        v = self.head
        while v >= 0:
            self.pos[v] = len(order)
            order.append(v)
            v = self.nxt[v]
        return order

    # ---- DP fill + end cell + traceback ----
    def _align(self, seq: torch.Tensor, L: int) -> list:
        caps = self.caps
        order = self._walk()
        V = len(order)
        pos = self.pos
        # per-row predecessor rows (row 0 = virtual source)
        rp = [[0]] + [[pos[u] + 1 for u in self.preds[v]] or [0]
                      for v in order]
        blo, bhi = self._band(order, rp, L)
        off = self._offsets(blo)
        self.off = off
        # seqp[j] = char j-1 (the M term's character at column j)
        seqp = torch.cat([torch.tensor([-1 << 20], dtype=torch.int32),
                          seq.to(torch.int32)])
        self.rown = [0] * (V + 1)     # computed columns per row
        best, brow = NEG, 0
        for i in range(1, V + 1):
            rmax = self._fill_row(i, rp[i], blo[i], bhi[i], L, seqp,
                                  self.base[order[i - 1]])
            if caps.local and rmax > best:
                best, brow = rmax, i
        if self.stage == 1:
            return None                   # fill + end cell only
        H = self.H.numpy()
        if caps.local:
            if best <= 0:
                return [-2] * L
            ei = brow
            ej = off[ei] + int(np.flatnonzero(
                H[ei, :self.rown[ei]] == best)[0])
        else:
            ei, hbest = 0, NEG - 1
            for i in range(1, V + 1):
                if self.nsucc[order[i - 1]] == 0:
                    h = self._rd(H, i, L)
                    if h > hbest:
                        hbest, ei = h, i
            ej = L
        return self._traceback(ei, ej, order, rp, seq.tolist(), L)

    def _band(self, order: list, rp: list, L: int) -> tuple:
        """(blo, bhi) per row: the abPOA adaptive band (min/max
        topological rank of the node, widened by w), else [0, L]."""
        caps = self.caps
        V = len(order)
        blo = [0] * (V + 1)
        bhi = [L] * (V + 1)
        if caps.banded:
            w = self.wb + (self.wfm * L) // 1000
            mr = [0] * (V + 1)
            Mr = [0] * (V + 1)
            D = 0
            for i in range(1, V + 1):
                if self.preds[order[i - 1]]:
                    mr[i] = 1 + min(mr[p] for p in rp[i])
                    Mr[i] = 1 + max(Mr[p] for p in rp[i])
                else:
                    mr[i] = Mr[i] = 1
                D = max(D, Mr[i])
            adj_l = max(0, D - L)
            adj_r = max(0, L - D)
            for i in range(1, V + 1):
                blo[i] = max(0, mr[i] - w - adj_l)
                bhi[i] = min(L, Mr[i] + w + adj_r)
                if bhi[i] - blo[i] + 1 > caps.W:
                    raise _Overflow
        return blo, bhi

    def _fill_row(self, i, prs, blo, bhi, L, seqp, bv) -> int:
        """Row i over columns [c0, c1] of its window (c0 = off[i] = blo is
        the band floor); returns the row's max over its band."""
        W = self.caps.W
        off = self.off
        c0 = off[i]
        c1 = min(c0 + W - 1, L)
        n = c1 - c0 + 1
        # predecessors' H / E1 / E2 at columns c0-1 .. c1, the floor
        # outside each predecessor's stored window
        hx = None
        for p in prs:
            a = max(c0 - 1, off[p])
            b = min(c1, off[p] + W - 1)
            if a == c0 - 1 and b == c1:
                seg = self.P[p, :3, a - off[p]:b - off[p] + 1]
            else:
                seg = torch.full((3, n + 1), NEG, dtype=torch.int32)
                if a <= b:
                    seg[:, a - c0 + 1:b - c0 + 2] = \
                        self.P[p, :3, a - off[p]:b - off[p] + 1]
            hx = seg if hx is None else torch.maximum(hx, seg)
        j = self.ar[c0:c1 + 1]
        hp = hx[0]
        M = hp[:-1] + torch.where(seqp[c0:c1 + 1] == bv, self.m,
                                  -self.n).to(torch.int32)
        if c0 == 0:
            M[0] = NEG
        e1 = torch.maximum(hp[1:] - self.g, hx[1, 1:] - self.e).clamp_(NEG)
        e2 = torch.maximum(hp[1:] - self.q, hx[2, 1:] - self.c).clamp_(NEG)
        hq = torch.maximum(M, torch.maximum(e1, e2))
        if self.caps.local:
            hq.clamp_(0)
        nb = min(bhi, c1) - c0 + 1      # in-band prefix of the row
        if nb < n:
            for x in (hq, e1, e2):
                x[max(nb, 0):] = NEG
        Hrow = hq
        for op, ex in ((self.g, self.e), (self.q, self.c)):
            G = torch.cummax(hq + ex * j, dim=0).values
            carry = NEG + ex * max(c0 - 1, 0)
            excl = torch.empty(n, dtype=torch.int32)
            excl[0] = carry
            excl[1:] = G[:-1]
            F = excl.clamp_(carry) - op - ex * (j - 1)
            if c0 == 0:
                F[0] = NEG
            Hrow = torch.maximum(Hrow, F)
        if nb < n:
            Hrow[max(nb, 0):] = NEG
        self.rown[i] = n
        self.P[i, :, :n] = torch.stack([Hrow, e1, e2, hq])
        return int(Hrow[:nb].max()) if nb > 0 else NEG

    def _rd(self, plane: np.ndarray, row: int, j: int) -> int:
        jl = j - self.off[row]
        if 0 <= jl < self.caps.W:
            return int(plane[row, jl])
        return NEG

    def _traceback(self, i, j, order, rp, seq, L) -> list:
        H, Hq = self.H.numpy(), self.Hq.numpy()
        E1, E2 = self.E1.numpy(), self.E2.numpy()
        rd = self._rd
        m, n, g, e, q, c = self.m, self.n, self.g, self.e, self.q, self.c
        local = self.caps.local
        target = [-2] * L
        chan = 0                  # 0 = H, 1 = Hq, 2 = E1, 3 = E2
        val = rd(H, i, j)
        while True:
            if chan <= 1:
                if local and val == 0:
                    break
                if i == 0:
                    if j == 0:
                        break
                    target[j - 1] = -1      # leading insertion via row 0
                    j -= 1
                    val = rd(H, 0, j)
                    chan = 0
                    continue
                v = order[i - 1]
                if j > 0:
                    subv = m if seq[j - 1] == self.base[v] else -n
                    pr = next((p for p in rp[i]
                               if rd(H, p, j - 1) + subv == val), None)
                    if pr is not None:
                        target[j - 1] = v
                        i, j, chan = pr, j - 1, 0
                        val = rd(H, i, j)
                        continue
                if rd(E1, i, j) == val:
                    chan = 2
                    continue
                if rd(E2, i, j) == val:
                    chan = 3
                    continue
                if chan == 0:
                    k = self._f_origin(Hq, i, j, val)
                    if k is not None:
                        for t in range(k, j):
                            target[t] = -1  # insertions
                        j, chan = k, 1
                        val = rd(Hq, i, j)
                        continue
                raise _Overflow          # stuck: cannot happen
            op, ex, Em = (g, e, E1) if chan == 2 else (q, c, E2)
            pr = next((p for p in rp[i] if rd(H, p, j) - op == val), None)
            if pr is not None:
                i, chan, val = pr, 0, rd(H, pr, j)
                continue
            pr = next((p for p in rp[i] if rd(Em, p, j) - ex == val), None)
            if pr is None:
                raise _Overflow          # broken E chain: cannot happen
            i, val = pr, rd(Em, pr, j)
        return target

    def _f_origin(self, Hq, i, j, val):
        """Nearest k < j whose Hq opens the F gap ending at j (channel 1
        before channel 2 at each k)."""
        for k in range(j - 1, -1, -1):
            h = self._rd(Hq, i, k)
            if h - self.g - (j - 1 - k) * self.e == val or \
                    h - self.q - (j - 1 - k) * self.c == val:
                return k
        return None

    # ---- threading ----
    def _thread(self, target: list, seq: list, L: int) -> list:
        base, pos, ring, nxt = self.base, self.pos, self.ring, self.nxt
        preds, nsucc = self.preds, self.nsucc
        VW, pcap = self.caps.VW, self.caps.pcap
        path = []
        splices = []
        prev = -1
        guard = -1
        scan = 1 if self.stage == 3 else RING_CAP
        for j in range(L):
            b = seq[j]
            t = target[j]
            v = -1
            saw = False
            if t >= 0:
                cand = t
                for _ in range(scan):
                    if base[cand] == b:
                        saw = True
                        if pos[cand] > guard:
                            v = cand
                            break
                    cand = ring[cand]
                    if cand == t:
                        break
            if v < 0 and self.stage == 4:
                v = 0                     # no node creation
            elif v < 0:
                if saw:
                    self.gs += 1
                if self.Vc >= VW:
                    raise _Overflow
                v = self.Vc
                self.Vc += 1
                base[v] = b
                preds[v] = []
                nsucc[v] = 0
                ring[v] = v
                if t >= 0:
                    splices.append((t, v))
                if prev < 0:
                    nxt[v] = self.head
                    self.head = v
                    pos[v] = -1
                else:
                    nxt[v] = nxt[prev]
                    nxt[prev] = v
                    pos[v] = pos[prev]
            else:
                guard = pos[v]
            if self.stage != 4 and prev >= 0 and prev not in preds[v]:
                if len(preds[v]) >= pcap:
                    raise _Overflow
                preds[v].append(prev)
                nsucc[prev] += 1
            path.append(v)
            prev = v
        for t, v in splices:
            ring[v] = ring[t]
            ring[t] = v
        return path


# ---------------------------------------------------------------------------
# conversion from / to the Pallas kernel's packed planes
# ---------------------------------------------------------------------------

def from_win_layout(nseq, par, slen, seqs, K: int, LW: int, W: int,
                    RW: int):
    """The Pallas kernel's input planes (numpy, as FusedPallasEngine._launch
    packs them: nseq (N,1,1), par (N,1,8), slen (N,1,128) int16, seqs
    (N, RW*LW/128 + W/128, 128) int8 with char j at flat position j+1;
    N = grid steps x K) -> the port's (seqs, slen, nseq, params) CPU
    tensors."""
    N = int(np.asarray(nseq).shape[0])
    if N % K:
        raise ValueError(f"{N} blocks is not a multiple of K={K}")
    s = np.asarray(seqs)
    if s.shape[1:] != (RW * LW // 128 + W // 128, 128):
        raise ValueError(f"seqs plane shape {s.shape} does not match "
                         f"RW={RW} LW={LW} W={W}")
    flat = s.reshape(N, -1)[:, :RW * LW].reshape(N, RW, LW)
    out = np.full((N, RW, LW), -1, np.int8)
    out[:, :, :LW - 1] = flat[:, :, 1:]
    sl = np.asarray(slen).reshape(N, 128)[:, :RW].astype(np.int32)
    return (torch.from_numpy(out),
            torch.from_numpy(np.ascontiguousarray(sl)),
            torch.from_numpy(np.asarray(nseq).reshape(N).astype(np.int32)),
            torch.from_numpy(np.asarray(par).reshape(N, 8)
                             .astype(np.int32)))


def to_win_layout(meta, exp, paths, VW: int, LW: int, RW: int):
    """The port's outputs -> `_win_fn`'s (meta (N,4) int32, exp
    (N, 3*VW/128, 128) int16, paths (N, RW*LW/128, 128) int16)."""
    meta, exp, paths = (x.cpu().numpy() for x in (meta, exp, paths))
    N = meta.shape[0]
    return (meta.astype(np.int32),
            exp.astype(np.int16).reshape(N, 3 * VW // 128, 128),
            paths.astype(np.int16).reshape(N, RW * LW // 128, 128))
