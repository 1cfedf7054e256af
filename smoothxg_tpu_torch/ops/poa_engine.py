"""Block-level POA engine on the GPU: the port of FusedPallasEngine.

Same interface as smoothxg_tpu/ops/poa_pallas_fused.FusedPallasEngine
(windowed path): `poa_block_batch`, `poa_block_batch_iter`, `stats`,
`warmup`.  Each block routes to the smallest tier that holds it; a chunk of
same-variant blocks becomes one `poa_win` launch (one thread block per POA
block); blocks that fit no tier, and blocks whose launch sets the overflow
flag, run on the native C++ engine, which implements the same semantics —
both counted in stats().  There is no failover: a CUDA error raises.  The
host steal of FusedPallasEngine is not ported yet (it needs rates measured
on the card).

Tiers are (VW, LW, W): node capacity, sequence capacity, stored DP window.
On the H100 the DP planes live in device memory at 16 bytes per cell
(H, Hq, E1, E2 as int32), so a tier costs ~16 * VW * W bytes of scratch per
block and the batch per launch is what SCRATCH_BUDGET holds (capped at
MAX_BATCH, two blocks per SM of a 132-SM card).  They cover what the TPU
tiers took — full width to LW 4096, banded long blocks to LW 10240, VW to
8704 — without K-stacking:
  (4352, 2048, 2048)   the bulk of -l 700..1100 blocks, 143 MB/block
  (8704, 2048, 2048)   high-growth blocks of the same lengths, 285 MB
  (6144, 3072, 3072)   mid-length full-width blocks, 302 MB
  (8704, 4096, 4096)   full width to 4095 bp, 570 MB
  (8704, 10240, 3072)  banded (abPOA) long blocks, 428 MB
"""
from __future__ import annotations

import time

import numpy as np
import torch

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import (FusedPallasEngine,
                                               rehydrate_device_raw)

from ..device import resolve
from .poa_win import WinCaps, pack_blocks, poa_win

__all__ = ["POAParams", "TorchPOAEngine", "rehydrate_device_raw"]


class TorchPOAEngine:
    """Whole-block POA engine: one kernel launch per chunk of blocks."""

    TIERS = ((4352, 2048, 2048), (8704, 2048, 2048), (6144, 3072, 3072),
             (8704, 4096, 4096), (8704, 10240, 3072))
    GROWTH_CAL = FusedPallasEngine.GROWTH_CAL
    SCRATCH_BUDGET = 24 << 30     # bytes of DP scratch per launch
    MAX_BATCH = 264

    def __init__(self, device: str | torch.device = "cuda",
                 max_seqs: int = 48, tiers: tuple | None = None,
                 threads: int = 1):
        from smoothxg_tpu.ops import poa_native
        from smoothxg_tpu.ops.poa_fused import FusedHostEngine
        self.device = resolve(device)
        self.tiers = tuple(tuple(t) for t in (tiers or self.TIERS))
        self.RW = max_seqs
        if poa_native.available():
            self.fallback = poa_native.NativePOAEngine(threads=threads)
        else:                    # pragma: no cover - native always builds
            self.fallback = FusedHostEngine()
        self.calls = 0
        self.kernel_launches = 0
        self.device_blocks = 0
        self.guard_splits = 0
        self.tier_blocks: dict = {}
        self.fallbacks = 0
        self.redo = 0
        self.predicted_overflow = 0
        self.device_s = 0.0
        self.dev_rows = 0.0

    def stats(self) -> dict:
        rows_ps = self.dev_rows / self.device_s if self.device_s else None
        return {
            "calls": self.calls,
            "device_blocks": self.device_blocks,
            "tier_blocks": {
                f"V{VW}xL{LW}" + (f"xW{W}" if W < LW else ""):
                    self.tier_blocks.get(ti, 0)
                for ti, (VW, LW, W) in enumerate(self.tiers)},
            "fallbacks": self.fallbacks,
            "guard_splits": self.guard_splits,
            "redo": self.redo,
            "vcap_redo": 0,
            "stolen": 0,
            "predicted_overflow": self.predicted_overflow,
            "device_wait_s": round(self.device_s, 3),
            "dev_rows_per_s": rows_ps,
            "dev_block_rows_per_s": rows_ps,
            "host_cells_per_s": None,
            "device_lost": None,
            "kernel_launches": self.kernel_launches,
        }

    def warmup(self, locals_=(True,), banded=(False,), tiers=None):
        """Build the kernel library and launch each requested (local,
        banded) variant once on a one-block batch.  `tiers` is accepted
        for FusedPallasEngine's signature: one kernel serves every tier."""
        if self.device.type != "cuda":
            return
        ins = pack_blocks([([np.zeros(1, np.uint8)], POAParams())], 128)
        ins = [x.to(self.device) for x in ins]
        for local in locals_:
            for bd in banded:
                poa_win(*ins, WinCaps(8, 128, 128, local, bd))
                self.kernel_launches += 1
        torch.cuda.synchronize(self.device)

    def _tier_batch(self, ti: int) -> int:
        VW, LW, W = self.tiers[ti]
        per = 4 * WinCaps(VW, LW, W, True, W < LW).scratch_words()
        return max(1, min(self.MAX_BATCH, self.SCRATCH_BUDGET // per))

    def _route(self, seqs, params=None) -> int | None:
        """Smallest tier index this block fits, or None (native engine).
        The rules of FusedPallasEngine._route, less the TPU-only ones
        (15-symbol alphabet, 128-lane window quantum): every sequence fits
        LW, the seed fits VW, the predicted final node count (sum of
        lengths, else the calibrated mash growth estimate) fits VW, and the
        stored window covers the row: full width always, a banded tier only
        for banded params whose band plausibly fits.  A misroute is never
        wrong: the kernel's overflow flag redoes the block natively."""
        if not seqs or len(seqs) > self.RW:
            return None
        lens = [len(s) for s in seqs]
        if min(lens) == 0:
            return None
        maxlen, minlen, sumlen, L0 = max(lens), min(lens), sum(lens), lens[0]
        banded = params is not None and params.wb >= 0
        est = None
        fits_shape = False
        for ti, (VW, LW, W) in enumerate(self.tiers):
            if maxlen + 1 > LW or L0 > VW:
                continue
            if W < LW:
                if not banded or maxlen > VW:
                    continue
                bw = params.wb + (params.wf_milli * maxlen) // 1000
                if 2 * bw + (maxlen - minlen) + 1 > W:
                    continue
                return ti
            if maxlen + 1 > W:
                continue
            fits_shape = True
            if sumlen <= VW:
                return ti
            if est is None:
                raw = FusedPallasEngine._estimate_final_v(seqs)
                est = L0 + (raw - L0) * self.GROWTH_CAL
            if est <= VW:
                return ti
        if fits_shape:
            self.predicted_overflow += 1
        return None

    def poa_block_batch(self, blocks):
        results = [None] * len(blocks)
        for i, kind, payload in self.poa_block_batch_iter(blocks):
            if kind == "graph":
                results[i] = payload
            else:
                seqs, weights, _ = blocks[i]
                results[i] = rehydrate_device_raw(seqs, weights, payload)
        return results

    def poa_block_batch_iter(self, blocks):
        """Yields (index, kind, payload): kind "raw" = (base, ring, order,
        paths, guard_splits) from the kernel (rehydrate with
        rehydrate_device_raw), kind "graph" = a finished POAGraph from the
        native engine (no tier, or overflow redo).  Every chunk is launched
        before the first result is read, so host work done while consuming
        overlaps the remaining kernels."""
        dev: dict[tuple, list[int]] = {}
        fb: list[int] = []
        for i, (seqs, _, params) in enumerate(blocks):
            ti = self._route(seqs, params)
            if ti is None:
                self.fallbacks += 1
                fb.append(i)
            else:
                dev.setdefault((params.local, params.wb >= 0, ti),
                               []).append(i)
        handles = []
        for (local, banded, ti), idxs in dev.items():
            idxs.sort(key=lambda i: (len(blocks[i][0]),
                                     len(blocks[i][0][0])), reverse=True)
            cap = self._tier_batch(ti)
            for s in range(0, len(idxs), cap):
                handles.append(self._launch(blocks, idxs[s:s + cap], ti,
                                            local, banded))

        def _async(idxs):
            batch = [blocks[i] for i in idxs]
            if hasattr(self.fallback, "poa_block_batch_async"):
                return self.fallback.poa_block_batch_async(batch)
            return [lambda g=g: g for g in self.fallback.poa_block_batch(
                batch)]

        fb_futs = _async(fb) if fb else []
        redo: list[int] = []
        redo_futs: list = []
        for chunk, meta, exp, paths, maxl in handles:
            t0 = time.perf_counter()
            meta = meta.cpu().numpy()
            good = [b for b in range(len(chunk)) if meta[b, 1] == 0]
            vmax = int(meta[good, 0].max()) if good else 0
            exp = exp[:, :, :vmax].cpu().numpy()
            paths = paths[:, :, :maxl].cpu().numpy()
            self.device_s += time.perf_counter() - t0
            h_redo = [chunk[b] for b in range(len(chunk)) if meta[b, 1]]
            if h_redo:
                redo.extend(h_redo)
                redo_futs.extend(_async(h_redo))
            for b in good:
                i = chunk[b]
                seqs = blocks[i][0]
                V = int(meta[b, 0])
                base = (exp[b, 0, :V] & 0xFF).astype(np.int32)
                blk_paths = [paths[b, r, :len(s)] for r, s in enumerate(seqs)]
                self.device_blocks += 1
                self.dev_rows += len(seqs[0]) * max(len(seqs) - 1, 1)
                self.guard_splits += int(meta[b, 3])
                yield i, "raw", (base, exp[b, 1, :V], exp[b, 2, :V],
                                 blk_paths, int(meta[b, 3]))
        for i, f in zip(fb, fb_futs):
            g = f()
            self.guard_splits += getattr(g, "guard_splits", 0)
            yield i, "graph", g
        self.redo += len(redo)
        for i, f in zip(redo, redo_futs):
            g = f()
            self.guard_splits += getattr(g, "guard_splits", 0)
            yield i, "graph", g

    def _launch(self, blocks, chunk, ti: int, local: bool, banded: bool):
        VW, LW, W = self.tiers[ti]
        ins = pack_blocks([(blocks[i][0], blocks[i][2]) for i in chunk], LW)
        maxl = int(ins[1].max())
        dev = self.device
        meta, exp, paths = poa_win(*(x.to(dev) for x in ins),
                                   WinCaps(VW, LW, W, local, banded))
        if dev.type == "cuda":
            self.kernel_launches += 1
        self.calls += 1
        self.tier_blocks[ti] = self.tier_blocks.get(ti, 0) + len(chunk)
        return chunk, meta, exp, paths, maxl
