"""Is a loop of dependent element reads of the (32, 128) plane
latency-bound on Hopper?  Counterpart of tools/probe_scalar_latency.py:mk
(the TPU's masked row reads):

  chase  : each read's index is the value read before (nothing overlaps)
  indep  : index i % 4096 (independent: the loads can pipeline)
  indep4 : 4 independent reads per iteration, N/4 iterations

each from shared memory or device memory (__ldcg, L2), by one thread or
one warp (row read + shuffle max under the lane mask).  Prints ns per read
beside the bound, then one JSON line; exits 1 if a case fails.

Usage: python -m smoothxg_tpu_torch.tools.probe_scalar_latency [N] [--reps R]
"""
import sys

from ._probe import Case, split_reps, tool_main

CASES = [Case(k, "row", k) for k in ("chase", "indep", "indep4")]


def main(argv=None) -> int:
    args, reps = split_reps(argv)
    n = int(args[0]) if args else 4096
    return tool_main("probe_scalar_latency", CASES, reps, n=n)


if __name__ == "__main__":
    sys.exit(main())
