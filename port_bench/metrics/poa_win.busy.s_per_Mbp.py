"""Seconds in which a poa_win kernel ran on the card (the union of its
intervals in the profiler's trace), per Mbp of input path."""
from port_bench import trace


def read(ctx):
    busy = trace.busy_s((s, e) for name, s, e in ctx["trace"]["device"]
                        if "poa_win" in name)
    if busy <= 0 or not ctx["mbp"]:
        return None
    return busy / ctx["mbp"]
