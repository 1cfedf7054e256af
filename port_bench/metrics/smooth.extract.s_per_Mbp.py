"""Seconds of the program's `smooth.extract` spans (`pipeline/smooth.py`:
each block's sequences extracted, deduplicated and encoded), summed over
the window's jobs, per Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "smooth.extract")
