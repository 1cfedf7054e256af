"""The whole window's share of the card's peak, in %: the least time for
the fill's int32 operations of the window's blocks (as `poa_win_roofline`
counts them) over the window's wall time on the host's clock; nothing of
the trace enters it.  It bounds what any kernel's roofline can claim end
to end, whichever kernel runs the fill."""
from port_bench import fillops


def read(ctx):
    fill = ctx["fill"]
    if not fill or not fill["ops"] or not ctx["clock_mhz"] \
            or ctx["window_s"] <= 0:
        return None
    return 100.0 * fillops.bound_s(fill["ops"], ctx["sms"],
                                   ctx["clock_mhz"]) / ctx["window_s"]
