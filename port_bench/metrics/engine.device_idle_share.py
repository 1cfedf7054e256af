"""The share of the block engine's time in which no operation ran on the
card, in %: the union of its `engine.*` spans, mapped onto the profiler's
clock, less what the union of the device's operations covers, over that
union."""
from port_bench import program_spans


def read(ctx):
    return program_spans.engine_idle_share(ctx)
