"""Seconds of the block engine's `engine.launch` spans (routing, the plan,
`pack_blocks` and the launches, device redos included;
`ops/poa_engine.py`), summed over the window's jobs, per Mbp of input
path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "engine.launch")
