"""Seconds of the program's `finalize.consensus` spans (a block's
heaviest-bundle consensus, `POAGraph.consensus_path`, in
`pipeline/smooth.py:_finalize_block`), summed over the window's blocks, per
Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "finalize.consensus")
