"""Block-level POA engine on the GPU: the port of FusedPallasEngine.

Same interface as smoothxg_tpu/ops/poa_pallas_fused.FusedPallasEngine
(windowed path): `poa_block_batch`, `poa_block_batch_iter`, `stats`,
`warmup`.  Each block routes to the smallest tier that holds it; a chunk of
same-variant blocks becomes one kernel launch (`poa_win` by default: one
thread block per POA block); blocks that fit no tier, and blocks whose
launch sets the overflow flag, run on the native C++ engine, which
implements the same semantics — both counted in stats().  There is no
failover: a CUDA error raises.  The host steal of FusedPallasEngine is not
ported yet (it needs rates measured on the card).

Tiers are (VW, LW, W): node capacity, sequence capacity, stored DP window.
On the H100 the DP planes live in device memory at 16 bytes per cell
(H, Hq, E1, E2 as int32 for poa_win), ~16 * VW * LS bytes of scratch per
block, LS the launch's row stride (ops/poa_win.row_stride; a windowed tier
stores W columns), so a tier's batch per launch is what SCRATCH_BUDGET
holds at the longest sequence of the blocks routed to it (capped at
MAX_BATCH, the blocks a 132-SM card holds at once).  The tiers cover what
the TPU tiers took — full width to LW 4096, banded long blocks to LW
10240, VW to 8704 — without K-stacking (sizes per block for poa_win at
LS = LW):
  (4352, 2048, 2048)   the bulk of -l 700..1100 blocks, 143 MB/block
  (8704, 2048, 2048)   high-growth blocks of the same lengths, 285 MB
  (6144, 3072, 3072)   mid-length full-width blocks, 302 MB
  (8704, 4096, 4096)   full width to 4095 bp, 570 MB
  (8704, 10240, 3072)  banded (abPOA) long blocks, 428 MB

Two options select the other whole-block kernels, as they select them in
FusedPallasEngine:
  * `shape=(VW, LW)` gives one full-width tier (VW, LW, LW) served by
    ops/poa_code.poa_code (csrc/poa_code.cu, the port of the unwindowed
    Pallas kernel _pallas_core: code-chase traceback, 8 predecessor slots);
  * `kernel="stacked"` serves full-width tiers by
    ops/poa_stacked.poa_stacked (csrc/poa_stacked.cu, the port of
    _stacked_core: one warp per block, 4 predecessor slots), by default
    the four full-width tiers above; a windowed tier raises ValueError.

`devices` shards each launch's blocks over several cards (the port of the
`_compiled_*_sharded` wrappers, FusedPallasEngine's `devices`): a chunk
holds the tier's batch times the shard count, cut into contiguous shards,
each launched on its own device and stream (parallel/mesh.py).  By default
an unindexed "cuda" takes every visible card, as FusedPallasEngine takes
every chip; an indexed device is that card alone, the CPU one shard.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve
from ..parallel.mesh import launch_shards, wait_shards
from . import poa_native
from .poa_code import CodeCaps, poa_code
from .poa_fused import FusedHostEngine
from .poa_host import POAParams
from .poa_rehydrate import GROWTH_CAL, estimate_final_v, rehydrate_device_raw
from .poa_stacked import poa_stacked, scratch_words, stacked_caps
from .poa_win import WinCaps, pack_blocks, poa_win, stride_for

__all__ = ["POAParams", "TorchPOAEngine", "rehydrate_device_raw"]


class TorchPOAEngine:
    """Whole-block POA engine: one kernel launch per chunk of blocks."""

    TIERS = ((4352, 2048, 2048), (8704, 2048, 2048), (6144, 3072, 3072),
             (8704, 4096, 4096), (8704, 10240, 3072))
    GROWTH_CAL = GROWTH_CAL
    SCRATCH_BUDGET = 24 << 30     # bytes of DP scratch per launch
    # the most POA blocks one launch puts on a 132-SM H100 at once, by
    # kernel: poa_win and poa_code run two 256-thread blocks an SM
    # (poa_code at <= 128 registers), poa_stacked up to 8 one-warp POA
    # blocks in a thread block (K = ceil(B / SMs), csrc/poa_stacked.cu)
    MAX_BATCH = {"win": 264, "code": 264, "stacked": 1056}

    def __init__(self, device: str | torch.device = "cuda",
                 max_seqs: int = 48, tiers: tuple | None = None,
                 threads: int = 1, shape: tuple | None = None,
                 kernel: str = "win", devices: list | None = None):
        if kernel not in ("win", "stacked"):
            raise ValueError(f"unknown kernel {kernel!r} (win or stacked)")
        if shape is not None and (tiers is not None or kernel != "win"):
            raise ValueError("shape selects the one-tier code-chase kernel: "
                             "give it without tiers or kernel")
        if shape is not None:
            self.kernel = "code"
            tiers = ((shape[0], shape[1], shape[1]),)
        elif kernel == "stacked":
            self.kernel = "stacked"
            tiers = tiers or tuple(t for t in self.TIERS if t[2] == t[1])
            if any(t[2] != t[1] for t in tiers):
                raise ValueError("kernel='stacked' is full width only: "
                                 f"windowed tier in {tiers}")
        else:
            self.kernel = "win"
        self.device = resolve(device)
        if devices is None:
            devices = ([torch.device("cuda", k)
                        for k in range(torch.cuda.device_count())]
                       if self.device.type == "cuda"
                       and self.device.index is None else [self.device])
        self.devices = [resolve(d) for d in devices]
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
        """Build the kernel library and launch the selected kernel once
        for each requested (local, banded) variant on a one-block batch.
        `tiers` is accepted for FusedPallasEngine's signature: one kernel
        serves every tier."""
        if self.device.type != "cuda":
            return
        ins = pack_blocks([([np.zeros(1, np.uint8)], POAParams())], 128)
        ins = [x.to(self.device) for x in ins]
        for local in locals_:
            for bd in banded:
                kern, caps, _ = self._kernel(8, 128, 128, local, bd)
                kern(*ins, caps)
                self.kernel_launches += 1
        torch.cuda.synchronize(self.device)

    def _kernel(self, VW: int, LW: int, W: int, local: bool, banded: bool):
        """The selected kernel's wrapper, its caps for a tier and variant,
        and its int32 scratch words per block as a function of the
        launch's row stride."""
        if self.kernel == "code":
            caps = CodeCaps(VW, LW, local, banded)
            return poa_code, caps, caps.scratch_words
        if self.kernel == "stacked":
            caps = stacked_caps(VW, LW, local, banded)
            return poa_stacked, caps, lambda LS: scratch_words(caps, LS)
        caps = WinCaps(VW, LW, W, local, banded)
        return poa_win, caps, caps.scratch_words

    def _tier_batch(self, ti: int, banded: bool, maxlen: int) -> int:
        """Blocks per launch of tier `ti` for blocks of at most `maxlen`
        bases: what SCRATCH_BUDGET holds at that row stride, capped at
        MAX_BATCH, on each shard's device."""
        VW, LW, W = self.tiers[ti]
        words = self._kernel(VW, LW, W, True, banded)[2](
            stride_for(maxlen, LW))
        return len(self.devices) * max(1, min(
            self.MAX_BATCH[self.kernel], self.SCRATCH_BUDGET // (4 * words)))

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
                raw = estimate_final_v(seqs)
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
            cap = self._tier_batch(ti, banded, max(
                len(s) for i in idxs for s in blocks[i][0]))
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
        for chunk, shards, maxl in handles:
            t0 = time.perf_counter()
            parts = wait_shards(shards)
            meta = torch.cat([p[0].cpu() for p in parts]).numpy()
            good = [b for b in range(len(chunk)) if meta[b, 1] == 0]
            vmax = int(meta[good, 0].max()) if good else 0
            exp = torch.cat([p[1][:, :, :vmax].cpu() for p in parts]).numpy()
            paths = torch.cat([p[2][:, :, :maxl].cpu()
                               for p in parts]).numpy()
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
        kern, caps, _ = self._kernel(VW, LW, W, local, banded)
        shards = launch_shards(self.devices, lambda *x: kern(*x, caps),
                               list(ins))
        self.kernel_launches += sum(d.type == "cuda" for d in self.devices
                                    [:len(shards)])
        self.calls += 1
        self.tier_blocks[ti] = self.tier_blocks.get(ti, 0) + len(chunk)
        return chunk, shards, maxl
