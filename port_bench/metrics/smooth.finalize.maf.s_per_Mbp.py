"""Seconds of the program's `finalize.maf` spans (a block's MSA and MAF
rows, `pipeline/smooth.py:_maf_rows` with `POAGraph.msa_rows`), summed over
the window's blocks, per Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "finalize.maf")
