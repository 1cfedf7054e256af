#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (smoothxg_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure exits nonzero and prints no result:
  1. device: CUDA required; the card's name and power limit.
  2. build:  csrc/poa_win.cu compiled from the checkout with nvcc.
  3. kernel: >= 200 seeded blocks at every engine tier shape through the
     CUDA kernel and its plain PyTorch version (exact equality on meta,
     exp, paths), every block also held against the native C++ engine;
     kernel time against the plain version's on a main-path block.
  4. main path: the port CLI (`-r 16 -j 5k -e 5k -l 700,900,1100 -m out.maf
     -t 1`) on a seeded 16 x 80 kb synthetic pangenome; exit 0 implies the
     lace validation passed; the kernel must carry >= 90% of the blocks.
  5. identity: the JAX package's CLI with --engine native on the same input
     in a subprocess; GFA and MAF sha256 must match.
Then the kernels' JSON line, the nvidia-smi line and the result line.
"""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(HERE, "smoke_out")
SEED = 20261016
MAIN_FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700,900,1100",
              "-t", "1"]


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class Tee(io.StringIO):
    """Keeps a copy of what is written to a stream."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)


def smoothing_phases(log: str) -> list:
    """The pipeline's 'smoothing N blocks done in X s' lines."""
    return [ln.split("] ", 1)[1] for ln in log.splitlines()
            if "] smoothing" in ln and "done in" in ln]


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def kernel_phase(torch, dev):
    """Phase 3.  Returns the kernel's JSON entry fields."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_engine import (POAParams, TorchPOAEngine,
                                                   rehydrate_device_raw)
    from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                                poa_win, poa_win_reference)
    from smoothxg_tpu_torch.testing.synth import make_block
    rng = np.random.default_rng(SEED)
    native = TorchPOAEngine(device=dev).fallback
    tiers = TorchPOAEngine.TIERS
    # (tier, local, banded, blocks, (min L, max L), seqs per block, div)
    plan = [(0, True, False, 70, (150, 500), (3, 7), 0.02),
            (0, False, False, 70, (150, 500), (3, 7), 0.02),
            (1, True, False, 20, (300, 900), (3, 6), 0.03),
            (1, False, False, 10, (300, 900), (3, 6), 0.03),
            (2, True, False, 10, (1800, 2600), (3, 4), 0.01),
            (2, False, False, 6, (1800, 2600), (3, 4), 0.01),
            (3, True, False, 6, (3000, 3800), (2, 3), 0.01),
            (3, False, False, 4, (3000, 3800), (2, 3), 0.01),
            (4, False, True, 4, (3600, 4400), (5, 5), 0.01)]
    n_blocks = n_cmp = 0
    max_err = 0
    for ti, local, banded, nb, (lo, hi), (smin, smax), div in plan:
        VW, LW, W = tiers[ti]
        p = POAParams(local=local, wb=311 if banded else -1)
        blocks = [make_block(rng, int(rng.integers(lo, hi)),
                             int(rng.integers(smin, smax + 1)), div)
                  for _ in range(nb)]
        ins = pack_blocks([(sq, p) for sq in blocks], LW)
        caps = WinCaps(VW, LW, W, local, banded)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        got = poa_win(*(x.to(dev) for x in ins), caps)
        torch.cuda.synchronize()
        per_block = (torch.cuda.max_memory_allocated(dev) - before) / nb
        got = [x.cpu() for x in got]
        want = poa_win_reference(*ins, caps)
        for name, g, w in zip(("meta", "exp", "paths"), got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"kernel != plain version on {name} at tier {ti} "
                     f"local={local} banded={banded}")
        graphs = native.poa_block_batch([(sq, [1] * len(sq), p)
                                         for sq in blocks])
        meta, exp, paths = (x.numpy() for x in got)
        for b, (sq, g) in enumerate(zip(blocks, graphs)):
            if meta[b, 1]:
                continue                 # overflow: the engine redoes it
            V = int(meta[b, 0])
            mine = rehydrate_device_raw(
                sq, [1] * len(sq),
                ((exp[b, 0, :V] & 0xFF).astype(np.int32), exp[b, 1, :V],
                 exp[b, 2, :V], [paths[b, r, :len(s)]
                                 for r, s in enumerate(sq)]))
            if (mine.base != g.base or mine.seq_paths != g.seq_paths
                    or mine._topo != g._topo or mine.group != g.group):
                fail(f"kernel != native engine on block {b} of tier {ti}")
            n_cmp += 1
        n_blocks += nb
        say(f"kernel tier V{VW}xL{LW}xW{W} local={local} banded={banded}: "
            f"{nb} blocks equal to the plain version, "
            f"{int((meta[:, 1] == 0).sum())} equal to native; peak device "
            f"memory {per_block / 1e6:.1f} MB per block of the launch")
    if n_blocks < 200:
        fail(f"only {n_blocks} blocks compared")

    # timing on a main-path block shape: 16 sequences of ~1 kb (-l 1100)
    VW, LW, W = tiers[0]
    p = POAParams(local=True)
    blk = make_block(rng, 1000, 16, 0.01)
    one = [(blk, [1] * 16, p)]
    cpu_ins = pack_blocks([(blk, p)], LW)
    caps = WinCaps(VW, LW, W, True, False)
    t0 = time.perf_counter()
    want = poa_win_reference(*cpu_ins, caps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ins = [x.to(dev) for x in cpu_ins]
    poa_win(*ins, caps)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    ev0.record()
    for _ in range(reps):
        got = poa_win(*ins, caps)
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / reps
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail("kernel != plain version on the timing block")
    # a full batch: 132 copies (one per SM), per-block cost
    insB = [x.repeat((132,) + (1,) * (x.dim() - 1)).contiguous()
            for x in ins]
    poa_win(*insB, caps)
    ev0.record()
    poa_win(*insB, caps)
    ev1.record()
    torch.cuda.synchronize()
    batch_ms = ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    for _ in range(4):
        native.poa_block_batch(one)
    native_ms = (time.perf_counter() - t0) * 1e3 / 4
    say(f"kernel timing, one 16 x ~1 kb local block (V={int(want[0][0, 0])}):"
        f" kernel {ms:.3f} ms, plain version {plain_ms:.1f} ms, native C++ "
        f"single thread {native_ms:.1f} ms ({1e3 / native_ms:.2f} blocks/s);"
        f" 132-block launch {batch_ms:.1f} ms "
        f"({132e3 / batch_ms:.1f} blocks/s)")
    say(f"kernel vs plain version: {n_blocks} blocks equal (max abs err "
        f"{max_err}, tolerance 0: all outputs are integers), {n_cmp} equal "
        f"to the native engine")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "smoothxg_tpu_torch")):
        fail("smoothxg_tpu_torch not found: run from a checkout of the repo")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    say(f"device: {kind} ({smi}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}")

    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_win import poa_win
    t0 = time.perf_counter()
    _build.load()
    t_cuda = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log["ptxas"].splitlines()
            if "registers" in ln]
    # the host stages' C++ libraries build at first use too; build them
    # here so the main path's wall is not charged for them
    t0 = time.perf_counter()
    res = subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"native build failed: {res.stderr[-800:]}")
    say(f"build: CUDA kernel {t_cuda:.2f} s ({_build.lib_path()}; "
        f"{regs[0] if regs else 'ptxas: no report'}); native libraries "
        f"{time.perf_counter() - t0:.2f} s")

    kentry = kernel_phase(torch, dev)

    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    os.makedirs(SMOKE_DIR, exist_ok=True)
    gfa = write_pangenome(os.path.join(SMOKE_DIR, "pangenome.gfa"),
                          haplotypes=16, length=80_000, snv_rate=0.01,
                          indel_rate=0.001, sv_count=4, seed=SEED)
    out = os.path.join(SMOKE_DIR, "port.gfa")
    maf = os.path.join(SMOKE_DIR, "port.maf")
    log = Tee(sys.stderr)
    poa_win.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc, engine = cli.run(["-g", gfa, "-o", out, "-m", maf, *MAIN_FLAGS])
    wall = time.perf_counter() - t0
    launches = poa_win.launches
    if rc != 0:
        fail(f"port CLI exited {rc}")
    st = engine.stats()
    total = st["device_blocks"] + st["fallbacks"] + st["redo"]
    say(f"main path: {wall:.2f} s wall, {total} blocks, "
        f"{total / wall:.2f} blocks/s end to end "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); "
        f"stats {json.dumps(st)}; kernel_launches {launches}")
    if launches <= 0:
        fail("the main path launched no kernel")
    if st["device_blocks"] < 0.9 * total:
        fail(f"only {st['device_blocks']}/{total} blocks ran on the GPU")

    out2 = os.path.join(SMOKE_DIR, "native.gfa")
    maf2 = os.path.join(SMOKE_DIR, "native.maf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "smoothxg_tpu.cli", "-g", gfa, "-o", out2,
         "-m", maf2, *MAIN_FLAGS, "--engine", "native"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    nwall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"native reference run exited {res.returncode}: "
             f"{res.stderr[-800:]}")
    same = sha256(out) == sha256(out2) and sha256(maf) == sha256(maf2)
    say(f"identity: native engine run {nwall:.2f} s "
        f"({'; '.join(smoothing_phases(res.stderr))}); "
        f"GFA sha256 "
        f"{sha256(out)[:16]} vs {sha256(out2)[:16]}, MAF sha256 "
        f"{sha256(maf)[:16]} vs {sha256(maf2)[:16]}")
    if not same:
        fail("port output differs from the native engine's")
    if "jax" in sys.modules:
        fail("the port imported jax")

    print(json.dumps({"kernels": [{
        "name": "poa_win", "route": "cuda",
        "source": "smoothxg_tpu_torch/csrc/poa_win.cu",
        "replaces": "smoothxg_tpu/ops/poa_pallas_win.py:64",
        "launches": launches, **kentry}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
