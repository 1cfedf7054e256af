"""Seconds of the window outside the pipeline's smoothing phase, per Mbp of
input path: the host stages (`pipeline/run.py` and the stages it calls:
load, prep, index, blocks, breaks, merge, lace, MAF, GFA), from the
traced phase spans."""


def read(ctx):
    spans = ctx["trace"]["spans"]
    smooth = sum(e - s for name, s, e in spans
                 if name.startswith("smoothing"))
    if not spans or not ctx["mbp"]:
        return None
    return (ctx["window_s"] - smooth) / ctx["mbp"]
