"""Loop overhead against op cost against unrolling on Hopper.
Counterpart of tools/probe_loop.py (mk_empty, mk_smem, mk_slab, mk_mwrite,
mk_mread), N steps each:

  empty / empty_u8     : register arithmetic only (unroll 1 / 8)
  smem_chase / smem_u8 : dependent table reads, SZ 4096 (unroll 1 / 8)
  smem_32k             : the chase at SZ 32768 (capacity)
  slab / slab_u8       : (8, 256) accumulator += an 8-row slab of a
                         (4096, 256) plane in device memory, 256 threads
  mwrite               : one element write a step into a (32, 128) plane
  mread_u8             : acc += element (13 i) % 4096, unroll 8

tables and planes in shared memory or device memory, by one thread or one
warp where the TPU case reads a row.  Prints ns per op beside the bound,
then one JSON line; exits 1 if a case fails.

Usage: python -m smoothxg_tpu_torch.tools.probe_loop [N] [--reps R]
"""
import sys

from ._probe import Case, split_reps, tool_main

CASES = [Case("empty", "scalar", "empty"),
         Case("empty_u8", "scalar", "empty_u8"),
         Case("smem_chase", "scalar", "chase"),
         Case("smem_u8", "scalar", "chase_u8"),
         Case("smem_32k", "scalar", "chase", sz=32768),
         Case("slab", "tile", "slab"),
         Case("slab_u8", "tile", "slab_u8"),
         Case("mwrite", "row", "mwrite"),
         Case("mread_u8", "row", "mread_u8")]


def main(argv=None) -> int:
    args, reps = split_reps(argv)
    n = int(args[0]) if args else 65536
    return tool_main("probe_loop", CASES, reps, n=n)


if __name__ == "__main__":
    sys.exit(main())
