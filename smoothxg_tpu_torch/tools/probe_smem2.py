"""Slopes on Hopper (N1 = 65,536, N2 = 524,288) of: (a) a 224 KiB set of
graph tables in one block's shared memory — bpp ring nxt npred nsucc (4096
words each), preds (8 x 4096), tgt and path (2048 each) — with a mixed
read/write body; (b) table read-modify-writes; (c) element writes into a
(32, 128) plane; (d) a fill row: 4 table reads + 1 table write (shared
memory), an 8-row slab read of a (4096, 256) plane, a read and a write of
an 8-row slab of the (2048, 256) scratch hh (device memory), 6 x 2 vector
ops over 256 columns, and a barrier a step.  Counterpart of
tools/probe_smem2.py (mk_cap, mk_rmw, mk_mwrite, mk_fillrow).  Prints each
slope and floor beside the bound, then one JSON line; exits 1 if a case
fails or a slope is not positive — cap_224KB[shared] failing to launch
would mean the tables do not fit.

Usage: python -m smoothxg_tpu_torch.tools.probe_smem2 [--reps R]
"""
import sys

from ._probe import Case, split_reps, tool_main

N1, N2 = 65536, 524288
CASES = [Case("cap_224KB", "scalar", "cap"),
         Case("smem_rmw", "scalar", "rmw7"),
         Case("mwrite", "row", "mwrite"),
         Case("fillrow", "tile", "fillrow")]


def main(argv=None) -> int:
    _, reps = split_reps(argv)
    return tool_main("probe_smem2", CASES, reps, n1=N1, n2=N2)


if __name__ == "__main__":
    sys.exit(main())
