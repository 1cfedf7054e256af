"""Does stacking K blocks' rows make the shift-max step dearer on Hopper?
Counterpart of tools/probe_stack.py:mk_step: N steps of x = max(x,
where(lane >= 1 + (i & 7), roll(x, 1), -16000)) on (8K, 256) rows, K = 1,
2, 4, 8, slope between N1 = 65,536 and N2 = 524,288.  Two layouts:
`block` (256 threads, a column each, the left neighbour by shuffle and
through shared memory at a warp's edge, one __syncthreads a step: the
per-row barrier of poa_win.cu / poa_code.cu) and `warp` (a warp per 8
rows, 8 columns a lane, shuffles only: poa_stacked.cu's layout).  The
difference between the two is the barrier's cost per row.  Prints each
slope and floor beside the bound, then one JSON line; exits 1 if a case
fails or a slope is not positive.

Usage: python -m smoothxg_tpu_torch.tools.probe_stack [--reps R]
"""
import sys

from ._probe import STEP_KS, Case, split_reps, tool_main

N1, N2 = 65536, 524288
CASES = [Case(f"step K={k}", "step", k) for k in STEP_KS]


def main(argv=None) -> int:
    _, reps = split_reps(argv)
    return tool_main("probe_stack", CASES, reps, n1=N1, n2=N2)


if __name__ == "__main__":
    sys.exit(main())
