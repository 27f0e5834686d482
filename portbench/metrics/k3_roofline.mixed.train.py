"""K3's roofline share over the traced calls of a mixed population, in %:
the least time of the pixel groups' renders (`roofline.py` on the pixel
group's shape: the cell's with `obs` 'image' and the group's agents, 33
rollout renders and 8 re-renders a call at T 32) over K3's traced device
time; silent if the launches disagree with that shape."""
from portbench import roofline
from portbench.loops.train_mixed import group_shape


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    pixels = [g for g in ctx.shape.get("groups", ())
              if g["style"] == "pixels"]
    if len(pixels) != 1:
        return None
    return roofline.share(ctx.trace, group_shape(ctx.shape, pixels[0]), "k3",
                          ctx.launches.get(roofline.WRAPPERS["k3"], 0))
