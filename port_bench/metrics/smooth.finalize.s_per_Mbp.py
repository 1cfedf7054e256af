"""The smoothing phase's finalize seconds (the `finalize` figure of
`pipeline/smooth.py`'s `N blocks: engine .., rehydrate .., finalize ..`
line), summed over the window's jobs, per Mbp of input path."""


def read(ctx):
    if not ctx["smooth"] or not ctx["mbp"]:
        return None
    return sum(x["finalize"] for x in ctx["smooth"]) / ctx["mbp"]
