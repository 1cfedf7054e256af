"""Time the split stage's banded identity kernel (csrc/ident.cu through
ops/ident_cuda.py:ident_counts) on seeded pairs the size of the smoke's
timing launch: 64 pairs of a ~1.4 kb sequence and a 5%-mutated copy, each
repeated 32 times (2,048 pairs), at each band asked for.  Prints, per
band, the kernel's mean time by CUDA events over `reps` launches after a
warm one, its bound (38 int32 operations a cell at the card's max SM
clock, as chip_smoke.py counts them) and the sha256 of its outputs, then a
JSON line.  Needs CUDA.  The same script from two checkouts, in turns,
compares two versions of the kernel on one card: the digests must agree.

Usage: python -m smoothxg_tpu_torch.tools.time_ident [band ...] [--reps=R]
(bands 128 32 288 by default: the pipeline's band, the narrowest, and
one past 256)
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import numpy as np

SEED = 15
OPS_IDENT_CELL = 38          # chip_smoke.py:OPS_IDENT_CELL
INT32_LANES = 132 * 128      # SMs x int32 lanes an SM


def timing_pairs(n: int = 64, copies: int = 32, length: int = 1400,
                 rate: float = 0.05) -> list:
    """n seeded pairs (a ~length bp read of a base, a copy mutated at
    `rate`: substitutions and 1-3 bp indels), repeated `copies` times."""
    rng = np.random.default_rng(SEED)

    def seq(k):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, k))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            if r < 2 * rate / 3:
                out.append(seq(int(rng.integers(1, 4))))
            elif r < rate:
                ch = "ACGT"[("ACGT".index(ch) + 1) % 4]
            out.append(ch)
        return "".join(out)

    base = seq(length)
    reads = [mutate(base) for _ in range(n)]
    return [(s, mutate(s)) for s in reads] * copies


def main(argv: list[str]) -> int:
    import torch

    from ..device import resolve
    from ..ops import _build
    from ..ops import ident_cuda as ic
    bands = [int(a) for a in argv if not a.startswith("--")] or [128, 32,
                                                                  288]
    reps = [int(a.split("=", 1)[1]) for a in argv
            if a.startswith("--reps=")] or [5]
    dev = resolve("cuda", what="time_ident times the ident kernel",
                  instead="it has no CPU mode")
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    clock_mhz = float(clk.stdout.split()[0])
    _build.load()
    pairs = timing_pairs()
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n].to(dev) for n in ("a", "aoff", "la", "b", "boff", "lb")]
    out = {"pairs": len(pairs), "device": torch.cuda.get_device_name(0),
           "clock_mhz": clock_mhz, "bands": {}}
    for band in bands:
        got = ic.ident_counts(*ins, band)          # warm, and the digest
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps[0]):
            ic.ident_counts(*ins, band)
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1) / reps[0]
        cells = int(ins[2].long().sum()) * band
        bound = cells * OPS_IDENT_CELL / (INT32_LANES * clock_mhz * 1e6) * 1e3
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        out["bands"][band] = {"ms": ms, "bound_ms": bound,
                              "sha256": digest}
        print(f"ident band {band}: {ms:.4f} ms for {len(pairs)} pairs "
              f"(mean of {reps[0]}), bound {bound:.4f} ms by operations "
              f"({cells} cells x {OPS_IDENT_CELL}), outputs sha256 "
              f"{digest[:16]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
