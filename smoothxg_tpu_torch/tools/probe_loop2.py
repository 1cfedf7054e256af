"""Slope-based loop costs on Hopper: each case at N1 = 65,536 and N2 =
524,288 steps, reported as (slope ns per step, floor ms).  Counterpart of
tools/probe_loop2.py (mk_empty, mk_smem, mk_smem_u8, mk_mread,
mk_mread_u8, mk_chase, mk_slab_u8, mk_vecrow).  The TPU file's manual 8x
bodies (smem_chase_u8, mread_u8, slab_u8) compute the same functions as
`#pragma unroll 8` loops for N a multiple of 8, which both N are.  vecrow
is a fill-row body: an 8-row slab read and 5 x (x = max(x, acc) + 1; acc =
where(x > acc, x - 3, acc)) over 256 columns.  Prints each slope and floor
beside the bound, then one JSON line; exits 1 if a case fails or a slope
is not positive.

Usage: python -m smoothxg_tpu_torch.tools.probe_loop2 [--reps R]
"""
import sys

from ._probe import Case, split_reps, tool_main

N1, N2 = 65536, 524288
CASES = [Case("empty", "scalar", "empty"),
         Case("smem_chase", "scalar", "chase"),
         Case("smem_chase_u8", "scalar", "chase_u8"),
         Case("mread", "row", "mread"),
         Case("mread_u8", "row", "mread_u8"),
         Case("mchase", "row", "chase"),
         Case("slab_u8", "tile", "slab_u8"),
         Case("vecrow", "tile", "vecrow")]


def main(argv=None) -> int:
    _, reps = split_reps(argv)
    return tool_main("probe_loop2", CASES, reps, n1=N1, n2=N2)


if __name__ == "__main__":
    sys.exit(main())
