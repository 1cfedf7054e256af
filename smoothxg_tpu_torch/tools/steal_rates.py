"""Measure the host steal's two rates (ops/poa_engine.py:TorchPOAEngine
NATIVE_CELLS_PS and DEV_ROWS_PS) on the card's machine.

    python -m smoothxg_tpu_torch.tools.steal_rates [-T N] [--reps R]

1. Runs the chip smoke's main path (its seeded 16 x 80 kb pangenome, `-r 16
   -j 5k -e 5k -l 700,900,1100 -t 1 -T N`) through run_smoothing on the card
   with a steal-off TorchPOAEngine(threads=N), keeping the blocks of each
   poa_block_batch_iter call.
2. The card: replays each call's blocks R times through a warm steal-off
   engine and times the interval its device watcher times (host clock,
   from the end of routing, before packing and the launches, to a CUDA
   event after the last launch; here waited on in line); the rate is the
   DP rows of the device-eligible blocks (len(seq0) x max(n - 1, 1) a
   block) over that time.
3. The pool: the same blocks through NativePOAEngine(threads=N), timed to
   the last graph; the rate is their cells (len(seq0) x the other
   sequences' lengths) over that time and over N - 1 workers, as the
   engine's host watcher counts them.
Prints each call's rates, the totals' rates (sum of work over sum of
time), the card's name and power limit and the host's CPU model, and ends
with one JSON line.  CUDA only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 20261016        # the chip smoke's pangenome
FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700,900,1100", "-t", "1"]


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _cpu() -> str:
    """The host CPU's model: lscpu's, else /proc/cpuinfo's."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if "Model name" in ln or "Vendor ID" in ln]
    try:
        with open("/proc/cpuinfo") as f:
            names += sorted({ln.split(":", 1)[1].strip() for ln in f
                             if ln.startswith("model name")})
    except OSError:
        pass
    return f"{' / '.join(names) or '?'}, {os.cpu_count()} logical CPUs"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-T", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("CUDA required: the rates are the card's", file=sys.stderr)
        return 1
    from .. import cli
    from ..ops.poa_engine import TorchPOAEngine
    from ..ops.poa_native import NativePOAEngine
    from ..pipeline.run import run_smoothing
    from ..testing.synth import write_pangenome
    work = tempfile.mkdtemp(prefix="steal_rates_")
    gfa = write_pangenome(os.path.join(work, "in.gfa"), haplotypes=16,
                          length=80_000, snv_rate=0.01, indel_rate=0.001,
                          sv_count=4, seed=SEED)
    parsed = cli.build_parser().parse_args(
        ["-g", gfa, "-o", os.path.join(work, "out.gfa"), "-m",
         os.path.join(work, "out.maf"), *FLAGS, "-T", str(args.T)])
    cfg = cli.config_from_args(parsed,
                               add_consensus=not parsed.vanish_consensus)
    calls = []
    it = TorchPOAEngine.poa_block_batch_iter

    def spy(self, blocks):
        calls.append(list(blocks))
        return it(self, blocks)

    TorchPOAEngine.poa_block_batch_iter = spy
    try:
        eng = TorchPOAEngine(threads=args.T, steal=False)
        eng.warmup()
        run_smoothing(cfg, engine=eng)
    finally:
        TorchPOAEngine.poa_block_batch_iter = it
    timed = []                  # (rows, seconds) of each replayed call

    def watch_inline(self, handles, rows, t0):
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        timed.append((rows, time.perf_counter() - t0))

    TorchPOAEngine._watch_device = watch_inline
    w_eff = max(1, args.T - 1)
    native = NativePOAEngine(threads=args.T)
    rows = secs = cells = hsecs = 0.0
    per_call = []
    for k, blocks in enumerate(calls):
        elig = [b for b in blocks if eng._route(b[0], b[2]) is not None]
        if not elig:
            continue
        r = sum(eng._steal_costs(b[0])[1] for b in elig)
        c = sum(eng._steal_costs(b[0])[0] for b in elig)
        dts, hts = [], []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            for _ in eng.poa_block_batch_iter(elig):
                pass
            dts.append(timed.pop()[1])
            t0 = time.perf_counter()
            for f in native.poa_block_batch_async(elig):
                f()
            hts.append(time.perf_counter() - t0)
        dt, ht = min(dts), min(hts)
        rows, secs, cells, hsecs = rows + r, secs + dt, cells + c, hsecs + ht
        per_call.append({"blocks": len(elig), "rows": r, "cells": c,
                         "dev_s": dt, "host_s": ht,
                         "dev_rows_per_s": r / dt,
                         "host_cells_per_s": c / ht / w_eff})
        print(f"call {k}: {len(elig)} device-eligible blocks, {r:.0f} rows "
              f"in {dt:.4f} s on the card ({r / dt:.0f} rows/s), {c:.0f} "
              f"cells in {ht:.3f} s on {args.T} native workers "
              f"({c / ht / w_eff:.0f} cells/s a worker of {w_eff})",
              flush=True)
    smi, cpu = _smi(), _cpu()
    print(f"card: {smi}; host CPU: {cpu}")
    print(json.dumps({"T": args.T, "dev_rows_per_s": rows / secs,
                      "host_cells_per_s": cells / hsecs / w_eff,
                      "calls": per_call, "card": smi, "cpu": cpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
