"""Seconds of the program's `finalize.build` spans (a block graph's build
before its unchop: trimmed paths, kept nodes, `MutableGraph`, paths and
edges; `pipeline/smooth.py:_block_graph`), summed over the window's blocks,
per Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "finalize.build")
