"""Time the code-chase POA kernels (csrc/poa_code.cu, csrc/poa_stacked.cu)
of the checkout it runs in, on the chip smoke's timing shapes, so that two
versions of them can be compared in turns on one card (run it from the
root of each checkout in one call: old, new, new, old).

Cases, each the fastest of `reps` launches after a warm one (CUDA
events), both kernels:
  block  the chip smoke's phase-3 timing block (16 x ~1 kb, local, V
         1,207) at caps (4352, 2048), one launch
  132    132 copies of it in one launch (one per SM)
  1056   1,056 copies at caps (1280, 1024) (8 per SM)
Each case's outputs are digested (sha256 of meta, exp, paths), so that two
checkouts can be seen to compute the same bytes.  Prints one line per case
and a JSON line.  Needs CUDA.

Usage: python -m smoothxg_tpu_torch.tools.time_chase [reps]
"""
from __future__ import annotations

import hashlib
import json
import sys

import numpy as np

SEED = 20261016
# the chip smoke's phase-3 plan (chip_smoke.py:kernel_phase): (tier,
# local, banded, blocks, (min L, max L), seqs per block, div); the timing
# block is the next draw of the same generator
PHASE3_PLAN = ((0, True, False, 70, (150, 500), (3, 7), 0.02),
               (0, False, False, 70, (150, 500), (3, 7), 0.02),
               (1, True, False, 20, (300, 900), (3, 6), 0.03),
               (1, False, False, 10, (300, 900), (3, 6), 0.03),
               (2, True, False, 10, (1800, 2600), (3, 4), 0.01),
               (2, False, False, 6, (1800, 2600), (3, 4), 0.01),
               (3, True, False, 6, (3000, 3800), (2, 3), 0.01),
               (3, False, False, 4, (3000, 3800), (2, 3), 0.01),
               (4, False, True, 4, (3600, 4400), (5, 5), 0.01))
CAPS = (4352, 2048)
FULL_CAPS = (1280, 1024)
COPIES = (132, 1056)


def phase3_blocks(rng) -> list:
    """The chip smoke's phase-3 blocks, by tier group, from `rng`."""
    from ..testing.synth import make_block
    return [[make_block(rng, int(rng.integers(lo, hi)),
                        int(rng.integers(smin, smax + 1)), div)
             for _ in range(nb)]
            for _, _, _, nb, (lo, hi), (smin, smax), div in PHASE3_PLAN]


def timing_block() -> list:
    """The chip smoke's timing block: 16 sequences of ~1 kb."""
    from ..testing.synth import make_block
    rng = np.random.default_rng(SEED)
    phase3_blocks(rng)
    return make_block(rng, 1000, 16, 0.01)


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = int(argv[0]) if argv else 3
    import torch
    from ..device import resolve
    from ..ops.poa_code import CodeCaps, poa_code
    from ..ops.poa_host import POAParams
    from ..ops.poa_stacked import poa_stacked, stacked_caps
    from ..ops.poa_win import pack_blocks
    from ._probe import card, measure
    try:
        dev = resolve("cuda")
    except RuntimeError as e:
        print(f"time_chase: {e}", file=sys.stderr)
        return 1
    name, smi, mhz = card()
    blk = timing_block()
    p = POAParams(local=True)
    res = {}
    for label, kern, mkcaps in (
            ("poa_code", poa_code,
             lambda VW, LW: CodeCaps(VW, LW, True, False)),
            ("poa_stacked", poa_stacked,
             lambda VW, LW: stacked_caps(VW, LW, True, False))):
        row = {}
        for case, caps, n in (("block", CAPS, 1), ("132", CAPS, COPIES[0]),
                              ("1056", FULL_CAPS, COPIES[1])):
            one = pack_blocks([(blk, p)], caps[1])
            ins = [x.repeat((n,) + (1,) * (x.dim() - 1)).contiguous()
                   .to(dev) for x in one]
            c = mkcaps(*caps)
            out = kern(*ins, c)
            if int(out[0][:, 1].sum()):
                raise SystemExit(f"{label} {case}: the timing block "
                                 f"overflows {caps}")
            ms = measure(lambda: kern(*ins, c), reps)
            row[case] = {"ms": ms, "digest": digest(out),
                         "V": int(out[0][0, 0])}
            print(f"{label} {case} ({n} x V{row[case]['V']} at "
                  f"V{caps[0]}xL{caps[1]}): {ms:.3f} ms, outputs "
                  f"{row[case]['digest']}", flush=True)
            del ins, out
            torch.cuda.empty_cache()
        res[label] = row
    print(json.dumps({"tool": "time_chase", "device": {
        "kind": name, "smi": smi, "max_sm_mhz": mhz}, "reps": reps, **res}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
