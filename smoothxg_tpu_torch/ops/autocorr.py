"""Symbol autocorrelation VNTR period detection.

Equivalent capability to the reference's sautocorr dependency
(reference: src/breaks.cpp:218-264 calls sautocorr::repeat with
min/max copy length, a z-score threshold, and a lag stride).

For each candidate lag L (sampled every `stride` between min and max lag),
the autocorrelation is the fraction of matching symbols between seq[:-L] and
seq[L:].  A lag is reported as a repeat period when its z-score against the
distribution over all sampled lags is >= min_z; we return the best such lag.
Vectorized with numpy on the host: the screen runs once per oversized block
inside the (already pooled) break stage, where sequences are short and the
host cost is noise next to the POA fill.

`repeat_batch` is the batched route (the JAX package's `repeat_batch` on its
jitted `_counts_fn`): the exact integer match counts of every (sequence,
lag) come from `autocorr_counts`, which launches csrc/autocorr.cu for CUDA
tensors and runs its plain PyTorch version, `autocorr_counts_reference`,
for CPU tensors; the statistics (corr = count / window, mu, sd and z in
float64) run on the host as in `repeat`, so every route gives the same
bits.  Like the JAX package's, the pipeline never calls it
(pipeline/breaks.py calls `repeat`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve


@dataclass
class Repeat:
    length: float
    z_score: float


def repeat(seq: np.ndarray | bytes | str,
           min_lag: int,
           max_lag: int,
           min_z: float = 5.0,
           stride: int = 50) -> Repeat:
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    n = len(seq)
    hi = min(max_lag, n // 2)
    if hi <= min_lag:
        return Repeat(0.0, 0.0)
    lags = np.arange(min_lag, hi + 1, max(stride, 1))
    if len(lags) < 3:
        return Repeat(0.0, 0.0)
    corrs = np.empty(len(lags), dtype=np.float64)
    for i, lag in enumerate(lags):
        corrs[i] = float(np.mean(seq[:-lag] == seq[lag:]))
    mu = corrs.mean()
    sd = corrs.std()
    if sd <= 0:
        return Repeat(0.0, 0.0)
    z = (corrs - mu) / sd
    best = int(np.argmax(z))
    if z[best] >= min_z:
        return Repeat(float(lags[best]), float(z[best]))
    return Repeat(0.0, float(z[best]))


# ---------------------------------------------------------------------------
# Batched device route: (B, G) int32 match counts on the run's device, the
# statistics on the host in float64.
# ---------------------------------------------------------------------------

_CHUNK_ELEMS = 1 << 24      # compares a chunk of the plain version holds


def autocorr_counts_reference(rows: torch.Tensor, lens: torch.Tensor,
                              lags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/autocorr.cu, on any device: for each
    row b and lag g, the positions p with p + lag < lens[b] and rows[b, p]
    == rows[b, p + lag] (the XLA function's roll, compare and mask),
    chunked over the lags so that no chunk holds more than _CHUNK_ELEMS
    compares.  Lengths are clipped to [0, Lpad] and a negative lag counts
    0, as in the kernel.  (B, G) int32."""
    B, Lpad = rows.shape
    G = lags.numel()
    out = torch.zeros((B, G), dtype=torch.int32, device=rows.device)
    if B == 0 or G == 0 or Lpad == 0:
        return out
    pos = torch.arange(Lpad, device=rows.device)
    n = lens.long().clamp(0, Lpad)[:, None, None]
    step = max(1, _CHUNK_ELEMS // (B * Lpad))
    for g0 in range(0, G, step):
        lg = lags[g0:g0 + step].long()
        idx = pos[None, :] + lg[:, None]                     # (c, Lpad)
        ok = (idx[None] < n) & (lg >= 0)[None, :, None]      # (B, c, Lpad)
        eq = rows[:, None, :] == rows[:, idx.clamp(0, Lpad - 1)]
        out[:, g0:g0 + step] = (eq & ok).sum(dim=2, dtype=torch.int32)
    return out


def autocorr_counts(rows: torch.Tensor, lens: torch.Tensor,
                    lags: torch.Tensor, stats: dict | None = None
                    ) -> torch.Tensor:
    """Match counts of rows (B, Lpad) uint8 with lens (B,) int32 at lags
    (G,) int32, on the rows' device.  CUDA tensors launch csrc/autocorr.cu
    on the current stream, its pack kernel and its count kernel (and raise
    on a launch error); CPU tensors run `autocorr_counts_reference`.  A
    `stats` dict on a CUDA call gets the plan the kernels made
    (`plan_stats`; this waits for the launch).  (B, G) int32."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 \
            or lens.dtype != torch.int32 or lens.shape != rows.shape[:1] \
            or lags.dtype != torch.int32 or lags.dim() != 1 \
            or lens.device != rows.device or lags.device != rows.device:
        raise ValueError("autocorr_counts wants rows (B, Lpad) uint8, lens "
                         "(B,) int32 and lags (G,) int32 on one device")
    if rows.device.type == "cpu":
        return autocorr_counts_reference(rows, lens, lags)
    if rows.device.type != "cuda":
        raise ValueError(f"autocorr_counts: unsupported device {rows.device}")
    B, Lpad = rows.shape
    G = lags.numel()
    out = torch.empty((B, G), dtype=torch.int32, device=rows.device)
    if B == 0 or G == 0:
        return out
    rows, lens, lags = word_rows(rows), lens.contiguous(), lags.contiguous()
    Lw = rows.shape[1]
    from . import _build
    lib = _build.load()
    scratch = torch.empty(lib.autocorr_scratch_bytes(B, Lw, G),
                          dtype=torch.uint8, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = lib.autocorr_launch(rows.data_ptr(), lens.data_ptr(),
                                 lags.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr(), B, Lw, G, stream)
    if rc != 0:
        raise RuntimeError(f"autocorr kernel launch failed: CUDA error {rc}")
    autocorr_counts.launches += 2
    if stats is not None:
        h = scratch[:4 * PLAN_HEADER].view(torch.int32).tolist()
        stats.update(plan_stats(scratch[:4 * (h[7] + 4 * h[0])]
                                .view(torch.int32).cpu()))
    return out


autocorr_counts.launches = 0    # kernel launches made by this wrapper (2 a
                                # call: the pack kernel, the count kernel)


PLAN_HEADER = 16                # int32 header of csrc/autocorr.cu's plan
ROUTES = ("acgt", "acgtn", "escape", "bytes")


def plan_stats(plan: torch.Tensor) -> dict:
    """The plan csrc/autocorr.cu's pack kernel made, from the scratch's
    first int32 (its header, the row counters, the unit list from int32
    header[7]): units, rows a route
    (`ROUTES`: A/C/G/T only, with N, with a few escapes, the bytes),
    units read from device memory, lags a unit, positions a stretch a
    route, and the list, (units, 4) int32: row, first word, first word of
    the lags' shifted windows, (lag group << 16) | (the windows' span of
    words << 3) | (device memory << 2) | route."""
    h = plan[:PLAN_HEADER].tolist()
    return {"units": h[0], "routes": dict(zip(ROUTES, h[1:5])),
            "device_units": h[5], "lags_per_unit": h[6],
            "stretch": dict(zip(ROUTES, h[8:12])),
            "list": plan[h[7]:h[7] + 4 * h[0]].reshape(-1, 4)}


def unit_positions(stats: dict, lens, lags) -> np.ndarray:
    """Position compares of each unit of a plan (`plan_stats`): for every
    lag of the unit that reaches its stretch, the positions of its window
    inside the stretch."""
    u = stats["list"].numpy().astype(np.int64)
    if not len(u):
        return np.zeros(0, np.int64)
    lens, lags = np.asarray(lens, np.int64), np.asarray(lags, np.int64)
    route = u[:, 3] & 3
    span = np.array([stats["stretch"][r] for r in ROUTES])[route]
    p0 = u[:, 1] * np.where(route == 3, 4, 32)
    n = lens[u[:, 0]]
    lg = stats["lags_per_unit"]
    g = (u[:, 3] >> 16)[:, None] * lg + np.arange(lg)[None, :]
    lag = lags[np.minimum(g, len(lags) - 1)]
    ok = (g < len(lags)) & (lag >= 0) & (lag < n[:, None])
    end = np.minimum(n[:, None] - lag, (p0 + span)[:, None])
    return np.where(ok, np.clip(end - p0[:, None], 0, None), 0).sum(1)


def word_rows(rows: torch.Tensor) -> torch.Tensor:
    """The rows as the kernel reads them: contiguous, 4-byte aligned, and
    padded with zero columns to a multiple of 4 (the padding lies past
    every length, so no count changes)."""
    B, Lpad = rows.shape
    if Lpad % 4 == 0 and rows.is_contiguous() and rows.data_ptr() % 4 == 0:
        return rows
    out = torch.zeros((B, -(-Lpad // 4) * 4), dtype=torch.uint8,
                      device=rows.device)
    out[:, :Lpad] = rows
    return out


GEOMETRY = ("grid", "threads", "smem", "blocks_per_sm", "unit_cap",
            "pack_blocks", "lags_per_unit", "buffer_words")


def geometry(B: int, Lpad: int, G: int) -> dict:
    """The kernels' launch geometry on the current card (`GEOMETRY`): the
    count kernel's persistent blocks, threads a block, shared bytes a
    block (two staging buffers) and blocks an SM, the unit list's
    capacity, the pack kernel's blocks (a chunk of 8,192 positions of a
    row each), lags a unit and the words of a staging buffer."""
    import ctypes
    from . import _build
    geo = (ctypes.c_int * 8)()
    _build.load().autocorr_geometry(B, -(-Lpad // 4) * 4, G, geo)
    return dict(zip(GEOMETRY, geo))


def _encode(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    if isinstance(s, (bytes, bytearray)):
        s = np.frombuffer(bytes(s), dtype=np.uint8)
    return np.asarray(s, dtype=np.uint8)


def repeat_batch(seqs: list, min_lag: int, max_lag: int,
                 min_z: float = 5.0, stride: int = 50,
                 device: str | torch.device = "cuda") -> list[Repeat]:
    """Batched `repeat` over many sequences: one `autocorr_counts` call on
    `device` ("cuda" launches the kernel and raises without a card; "cpu"
    runs the plain version), then the same per-sequence lag grid, windows
    and z statistics as `repeat`, bit-identical to it and to the JAX
    package's repeat_batch.  The rows are padded to a multiple of 4 bytes,
    not to the JAX package's power-of-two bucket: no count depends on the
    padding."""
    dev = resolve(device, what="repeat_batch's counts run on the GPU",
                  instead="pass device='cpu' for the plain version")
    if not seqs:
        return []
    enc = [_encode(s) for s in seqs]
    lens = np.array([len(s) for s in enc], dtype=np.int32)
    # shared lag grid: covers every sequence's range; per-sequence
    # validity masks off lags past its own hi = min(max_lag, n//2)
    hi_all = int(min(max_lag, int(lens.max()) // 2))
    if hi_all <= min_lag:
        return [Repeat(0.0, 0.0) for _ in enc]
    lags = np.arange(min_lag, hi_all + 1, max(stride, 1)).astype(np.int32)
    Lpad = max(4, -(-int(lens.max()) // 4) * 4)
    buf = np.zeros((len(enc), Lpad), dtype=np.uint8)
    for i, s in enumerate(enc):
        buf[i, :len(s)] = s
    cnt = autocorr_counts(torch.from_numpy(buf).to(dev),
                          torch.from_numpy(lens).to(dev),
                          torch.from_numpy(lags).to(dev)).cpu().numpy()
    out: list[Repeat] = []
    for b in range(len(enc)):
        n = int(lens[b])
        hi = min(max_lag, n // 2)
        if hi <= min_lag:
            out.append(Repeat(0.0, 0.0))
            continue
        sel = lags <= hi
        if int(sel.sum()) < 3:
            out.append(Repeat(0.0, 0.0))
            continue
        windows = (n - lags[sel]).astype(np.float64)
        corrs = cnt[b, sel].astype(np.float64) / windows
        mu = corrs.mean()
        sd = corrs.std()
        if sd <= 0:
            out.append(Repeat(0.0, 0.0))
            continue
        z = (corrs - mu) / sd
        best = int(np.argmax(z))
        if z[best] >= min_z:
            out.append(Repeat(float(lags[sel][best]), float(z[best])))
        else:
            out.append(Repeat(0.0, float(z[best])))
    return out
