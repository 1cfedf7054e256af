"""The share of the traced window in which no operation ran on the card
(1 - the union of its kernel, copy and set intervals / the window), in %."""
from port_bench import trace


def read(ctx):
    tr = ctx["trace"]
    busy = trace.busy_s((s, e) for _, s, e in tr["device"])
    if busy <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy / tr["window_s"])
