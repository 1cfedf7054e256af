"""Cost of scalar table accesses on Hopper, in shared memory and in L2.
Counterpart of tools/probe_smem.py:mk: a table of SZ words t[i] = (97 i +
13) % SZ, then N dependent reads (chase), N independent reads (indep) or N
read-modify-writes (rmw), by one thread, the table in shared memory (the
counterpart of TPU SMEM) or in device memory read with __ldcg.  Prints ns
per op beside the bound, then one JSON line; exits 1 if a case fails (a
table too large for shared memory fails to launch).

Usage: python -m smoothxg_tpu_torch.tools.probe_smem [N] [SZ] [--reps R]
(SZ a power of two)
"""
import sys

from ._probe import Case, split_reps, tool_main


def cases(sz: int) -> list:
    return [Case(f"SMEM[{sz}] {k}", "scalar", k, sz=sz)
            for k in ("chase", "indep", "rmw")]


def main(argv=None) -> int:
    args, reps = split_reps(argv)
    n = int(args[0]) if args else 65536
    sz = int(args[1]) if len(args) > 1 else 4096
    return tool_main("probe_smem", cases(sz), reps, n=n)


if __name__ == "__main__":
    sys.exit(main())
