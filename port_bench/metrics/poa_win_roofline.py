"""poa_win's share of its roofline, in %: the least time for the fill's
int32 operations of the window's blocks (`fillops.block_work`, counted from
the jobs' MAFs) at the card's SMs x 128 lanes (assumed) x clocks.max.sm,
over the union of the intervals in which a poa_win kernel ran."""
from port_bench import fillops, trace


def read(ctx):
    busy = trace.busy_s((s, e) for name, s, e in ctx["trace"]["device"]
                        if "poa_win" in name)
    fill = ctx["fill"]
    if busy <= 0 or not fill or not fill["ops"] or not ctx["clock_mhz"]:
        return None
    return 100.0 * fillops.bound_s(fill["ops"], ctx["sms"],
                                   ctx["clock_mhz"]) / busy
