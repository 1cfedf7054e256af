"""The smoothing phase's rehydrate seconds (the `rehydrate` figure of
`pipeline/smooth.py`'s `N blocks: engine .., rehydrate .., finalize ..`
line), summed over the window's jobs, per Mbp of input path."""


def read(ctx):
    if not ctx["smooth"] or not ctx["mbp"]:
        return None
    return sum(x["rehydrate"] for x in ctx["smooth"]) / ctx["mbp"]
