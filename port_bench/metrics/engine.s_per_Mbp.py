"""The block engine's seconds (`TorchPOAEngine.poa_block_batch_iter`, the
`engine` figure of `pipeline/smooth.py`'s `N blocks: engine ..` line),
summed over the window's jobs, per Mbp of input path."""


def read(ctx):
    if not ctx["smooth"] or not ctx["mbp"]:
        return None
    return sum(x["engine"] for x in ctx["smooth"]) / ctx["mbp"]
