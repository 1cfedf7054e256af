"""Seconds of the program's `finalize.unchop` spans (a block graph's
`MutableGraph.unchop_toposort`), summed over the window's blocks, per Mbp
of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "finalize.unchop")
