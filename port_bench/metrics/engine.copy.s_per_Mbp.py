"""Seconds of the block engine's `engine.copy` spans (a launch's meta,
`exp` and `paths` read back to the host and cut into blocks, in
`TorchPOAEngine._collect`), summed over the window's jobs, per Mbp of input
path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "engine.copy")
