"""Seconds of the block engine's `engine.wait` spans (the host blocked on
a launch's streams, `wait_shards` in `TorchPOAEngine._collect`), summed
over the window's jobs, per Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "engine.wait")
