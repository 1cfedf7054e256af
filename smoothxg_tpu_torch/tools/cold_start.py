"""Cold-start wall of the main path: the port's CLI on a tree whose kernel
library and host libraries are not built yet, so nvcc and g++ run inside
the run.

    python -m smoothxg_tpu_torch.tools.cold_start [TREE ...] [--reps R]

Each TREE is the root of a checkout of the repo (by default this one); a
rep runs the trees in turns, forward then backward (a b b a).  A run copies
TREE's smoothxg_tpu_torch package without its _build/ into a fresh
directory under smoke_out/cold_start and runs `python -m
smoothxg_tpu_torch.cli` there with the chip smoke's main-path flags on its
seeded 16 x 80 kb pangenome, timing the whole process on the host clock.
Prints each run's wall, the pipeline's phase lines and the GFA and MAF
sha256, and ends with one JSON line.  CUDA only (the default engine).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

SEED = 20261016        # the chip smoke's pangenome
FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700,900,1100", "-t", "1"]
_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(_HERE))


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def run_cold(tree: str, work: str, gfa: str, tag: str) -> dict:
    """One cold run of `tree`'s package in a fresh directory `work`."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shutil.copytree(os.path.join(tree, "smoothxg_tpu_torch"),
                    os.path.join(work, "smoothxg_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out, maf = (os.path.join(work, f"out.{x}") for x in ("gfa", "maf"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "smoothxg_tpu_torch.cli",
                          "-g", gfa, "-o", out, "-m", maf, *FLAGS],
                         cwd=work, capture_output=True, text=True,
                         timeout=1800)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{tag}: exit {res.returncode}: "
                           f"{res.stderr[-800:]}")
    phases = [ln.split("] ", 1)[1] for ln in res.stderr.splitlines()
              if "] smoothing" in ln and "done in" in ln]
    return {"tree": tag, "wall_s": wall, "phases": phases,
            "gfa": _sha(out), "maf": _sha(maf)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    base = os.path.join(ROOT, "smoke_out", "cold_start")
    os.makedirs(base, exist_ok=True)
    gfa = write_pangenome(os.path.join(base, "pangenome.gfa"), haplotypes=16,
                          length=80_000, snv_rate=0.01, indel_rate=0.001,
                          sv_count=4, seed=SEED)
    order = [t for _ in range(args.reps)
             for t in args.trees + args.trees[::-1]]
    runs = []
    for k, tree in enumerate(order):
        tag = os.path.relpath(os.path.abspath(tree), ROOT)
        r = run_cold(tree, os.path.join(base, f"run{k}"), gfa, tag)
        runs.append(r)
        print(f"cold run {k} ({tag}): {r['wall_s']:.2f} s wall "
              f"({'; '.join(r['phases'])}); GFA {r['gfa']}, MAF {r['maf']}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(json.dumps({"runs": runs, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
