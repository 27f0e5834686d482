"""A mixed population's model operations over the window (`flops.py` on
each observation group's shape, summed: its rollout and its update) over
chips x 989 TFLOP/s (bf16) x the window's wall seconds, in %: the whole
step's share of the peak."""
from portbench import flops, roofline
from portbench.loops.train_mixed import group_shape


def read(ctx):
    groups = ctx.shape.get("groups") if ctx.kind == "train" else None
    if not groups:
        return None
    ops = sum(flops.call_ops(group_shape(ctx.shape, g)) for g in groups)
    ops *= len(ctx.calls) * ctx.world
    return 100.0 * ops / (ctx.world * roofline.BF16_OPS_PER_S * ctx.window_s)
