"""The window's model operations (``flops.py``: every train call's
rollout and update) over chips x 989 TFLOP/s (bf16, the configuration's
dtype) x the window's wall seconds, in %: the whole step's share of the
peak."""
from portbench import flops, roofline


def read(ctx):
    if ctx.kind != "train":
        return None
    ops = flops.call_ops(ctx.shape) * len(ctx.calls) * ctx.world
    return 100.0 * ops / (ctx.world * roofline.BF16_OPS_PER_S * ctx.window_s)
