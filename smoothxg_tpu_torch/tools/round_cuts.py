"""Where a round task's time goes in csrc/poa_round.cu: timing-only cuts of
the kernel, each a patched copy of the package timed with tools/time_chase
on the chip smoke's V 1,220 round task (and 132 and 264 copies).  A cut
removes one part of the work, so its outputs are invalid by design and
only its time is read; the difference to the kernel as built is what that
part costs.

Cuts (applied to the source of the checkout it runs in):
  traceback  no traceback (the end cell only)
  stores     the fill's plane stores to device memory (Hq, E1, E2, H)
  totals     the scan over the warp totals after the F scan's barrier
  scan       the warp-shuffle F scan
  barrier    the F scan's barrier (with `totals`: nothing reads the
             published totals)
Variants: the kernel as built, without the traceback, and without the
traceback and each other cut.  Copies go under --work (default
smoke_out/round_cuts); each builds its own kernels.  Needs CUDA.  Prints
one line per variant and a JSON line.

Usage: python -m smoothxg_tpu_torch.tools.round_cuts [reps] [--work DIR]
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUTS = {
    "traceback": [("    if (!local || best > 0) {\n        if (local) {",
                   "    if (false) {\n        if (local) {")],
    "stores": [("                *(int4*)(Hqi + j0) = make_int4(hq[0], hq[1], "
                "hq[2], hq[3]);\n                *(int4*)(E1i + j0) = ve1;\n"
                "                *(int4*)(E2i + j0) = ve2;\n", ""),
               ("                *(int4*)(Hi + j0) = v;\n", "")],
    "totals": [("            for (int o = 1; o < nw; o <<= 1) {\n"
                "                const int y1 = __shfl_up_sync(FULL, w1, o);",
                "            for (int o = nw; o < nw; o <<= 1) {\n"
                "                const int y1 = __shfl_up_sync(FULL, w1, o);")],
    "scan": [("            for (int o = 1; o < 32; o <<= 1) {\n"
              "                const int y1 = __shfl_up_sync(FULL, i1, o);",
              "            for (int o = 32; o < 32; o <<= 1) {\n"
              "                const int y1 = __shfl_up_sync(FULL, i1, o);")],
    "barrier": [("            __syncthreads();\n            // the warp "
                 "totals'", "            // the warp totals'")],
}
VARIANTS = (("as built", ()), ("traceback", ("traceback",)),
            ("traceback + stores", ("traceback", "stores")),
            ("traceback + totals", ("traceback", "totals")),
            ("traceback + scan", ("traceback", "scan")),
            ("traceback + totals + barrier",
             ("traceback", "totals", "barrier")))


def patched(src: str, cuts) -> str:
    """`src` with each cut applied; raises if a cut's text is not found
    exactly once (the kernel changed under it)."""
    for name in cuts:
        for old, new in CUTS[name]:
            if src.count(old) != 1:
                raise ValueError(f"cut {name!r} does not apply to "
                                 f"csrc/poa_round.cu")
            src = src.replace(old, new)
    return src


def prepare(work: str) -> list:
    """A patched copy of the package for each variant under `work`;
    returns [(label, directory)]."""
    with open(os.path.join(_PKG, "csrc", "poa_round.cu")) as f:
        src = f.read()
    out = []
    for i, (label, cuts) in enumerate(VARIANTS):
        d = os.path.join(work, f"v{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_PKG, os.path.join(d, "smoothxg_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        with open(os.path.join(d, "smoothxg_tpu_torch", "csrc",
                               "poa_round.cu"), "w") as f:
            f.write(patched(src, cuts))
        out.append((label, d))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    work = os.path.join("smoke_out", "round_cuts")
    if "--work" in argv:
        i = argv.index("--work")
        work = argv[i + 1]
        del argv[i:i + 2]
    reps = argv[0] if argv else "5"
    res = {}
    for label, d in prepare(work):
        r = subprocess.run([sys.executable, "-m",
                            "smoothxg_tpu_torch.tools.time_chase", reps,
                            "poa_round"], cwd=d, capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(f"round_cuts: {label}: time_chase failed\n{r.stderr[-800:]}",
                  file=sys.stderr)
            return 1
        line = json.loads(r.stdout.strip().splitlines()[-1])
        res[label] = {case: v["ms"] for case, v in line["poa_round"].items()}
        print(f"{label}: " + ", ".join(f"{case} {ms:.3f} ms"
                                       for case, ms in res[label].items()),
              flush=True)
        device = line["device"]
    print(json.dumps({"tool": "round_cuts", "device": device, "reps": reps,
                      "ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
