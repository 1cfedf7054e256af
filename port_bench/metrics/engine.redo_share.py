"""Blocks the engine aligned twice or handed to the host (`redo`,
`device_redo`, `fallbacks` of `TorchPOAEngine.stats()`, their change over
the window) over the blocks smoothed in the window, in %."""


def read(ctx):
    blocks = sum(x["blocks"] for x in ctx["smooth"])
    s0, s1 = ctx["stats0"], ctx["stats1"]
    if not blocks or not s1:
        return None
    redo = sum(s1[k] - s0[k] for k in ("redo", "device_redo", "fallbacks"))
    return 100.0 * redo / blocks
