"""Where the time of one smoothing run goes on the GPU.

Runs the port's CLI on the chip smoke's seeded 16 x 80 kb pangenome (or
another size) once to warm up, then once more under cProfile with CUDA
events around every kernel launch of the engine, and prints: the wall, the
kernels' busy time and launches, the device's idle share (1 - busy / wall),
the per-iteration smoothing times, and the host functions with the most
cumulative time.  Needs CUDA; without it, it fails.

  python -m smoothxg_tpu_torch.testing.profile_path --engine pallas
  python -m smoothxg_tpu_torch.testing.profile_path --engine jax
  python -m smoothxg_tpu_torch.testing.profile_path --engine fused \\
      --haplotypes 16 --length 80000 --out smoke_out/profile

`--engine code` and `--engine stacked` run the same flags through the API
with TorchPOAEngine(shape=(8704, 4096)) (kernel poa_code) and
TorchPOAEngine(kernel="stacked") (kernel poa_stacked), as chip_smoke.py's
phases 9 and 11 do.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import sys
import time

FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700,900,1100", "-t", "1"]


class _Timed:
    """Wraps a kernel wrapper: a CUDA event pair around each call."""

    def __init__(self, fn, torch):
        self.fn, self.torch, self.pairs = fn, torch, []

    def __call__(self, *args, **kw):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*args, **kw)
        ev[1].record()
        self.pairs.append(ev)
        return out

    # the wrapper counts its launches on itself, under its module's name
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def busy_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine",
                    choices=["fused", "pallas", "jax", "code", "stacked"],
                    default="pallas")
    ap.add_argument("--haplotypes", type=int, default=16)
    ap.add_argument("--length", type=int, default=80_000)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--out", default=os.path.join("smoke_out", "profile"))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("CUDA required: this profile measures the GPU", file=sys.stderr)
        return 1
    from .. import cli
    from ..ops import poa_batch, poa_engine, poa_round
    from ..pipeline.run import run_smoothing
    from .synth import write_pangenome

    os.makedirs(args.out, exist_ok=True)
    gfa = write_pangenome(os.path.join(args.out, "pangenome.gfa"),
                          haplotypes=args.haplotypes, length=args.length,
                          snv_rate=0.01, indel_rate=0.001, sv_count=4,
                          seed=args.seed)
    argv_run = ["-g", gfa, "-o", os.path.join(args.out, "out.gfa"),
                "-m", os.path.join(args.out, "out.maf"), *FLAGS]
    if args.engine in ("fused", "pallas", "jax"):
        argv_run += ["--engine", args.engine]

        def run():
            return cli.run(argv_run)
    else:
        cargs = cli.build_parser().parse_args(argv_run)
        cfg = cli.config_from_args(cargs, not cargs.vanish_consensus)

        def run():
            eng = poa_engine.TorchPOAEngine(shape=(8704, 4096)) \
                if args.engine == "code" else \
                poa_engine.TorchPOAEngine(kernel="stacked")
            return 0, run_smoothing(cfg, engine=eng)[2]
    with contextlib.redirect_stderr(io.StringIO()):
        rc, _ = run()                              # warm-up
    if rc != 0:
        print(f"warm-up run exited {rc}", file=sys.stderr)
        return 1

    mod, name = {"fused": (poa_engine, "poa_win"),
                 "pallas": (poa_round, "poa_round"),
                 "jax": (poa_batch, "poa_batch"),
                 "code": (poa_engine, "poa_code"),
                 "stacked": (poa_engine, "poa_stacked")}[args.engine]
    timed = _Timed(getattr(mod, name), torch)
    setattr(mod, name, timed)
    log = io.StringIO()
    prof = cProfile.Profile()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            prof.enable()
            rc, engine = run()
            prof.disable()
        wall = time.perf_counter() - t0
    finally:
        setattr(mod, name, timed.fn)
    if rc != 0:
        print(f"profiled run exited {rc}", file=sys.stderr)
        return 1
    busy = timed.busy_ms() / 1e3
    smoothing = [ln.split("] ", 1)[1] for ln in log.getvalue().splitlines()
                 if "] smoothing" in ln and "done in" in ln]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "engine": args.engine,
        "input": f"{args.haplotypes} x {args.length} bp, seed {args.seed}",
        "wall_s": wall, "kernel_busy_s": busy, "launches": len(timed.pairs),
        "idle_share": 1 - busy / wall, "smoothing": smoothing,
        "stats": engine.stats()}))
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(
        args.top)
    print(text.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
