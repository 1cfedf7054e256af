"""Seconds of the program's "prepping graph" stage spans (`utils/progress
.phase`, around `pipeline/prep.py:prep`), summed over the window's jobs,
per Mbp of input path."""
from port_bench import program_spans


def read(ctx):
    return program_spans.s_per_Mbp(ctx, "prepping graph")
