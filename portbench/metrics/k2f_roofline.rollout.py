"""K2F's roofline share over the traced acting calls, in %: the least time of
its work (`roofline.py`, shapes from the cell) over its traced device time."""
from portbench import roofline


def read(ctx):
    if ctx.kind != "rollout" or ctx.trace is None:
        return None
    return roofline.share(ctx.trace, ctx.shape, "k2f",
                          ctx.launches.get(roofline.WRAPPERS["k2f"], 0))
