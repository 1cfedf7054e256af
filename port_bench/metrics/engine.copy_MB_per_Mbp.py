"""Megabytes the block engine read back from the card (`copy_bytes` of
`TorchPOAEngine.stats()`: each launch's meta, `exp` and `paths`, in
`_collect`), its change over the window, per Mbp of input path.  None on
an engine without the counter."""


def read(ctx):
    s0, s1 = ctx["stats0"], ctx["stats1"]
    if "copy_bytes" not in s1 or not ctx["mbp"]:
        return None
    return (s1["copy_bytes"] - s0.get("copy_bytes", 0)) / 1e6 / ctx["mbp"]
