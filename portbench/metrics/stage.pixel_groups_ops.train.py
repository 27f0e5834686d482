"""Device operations of the pixel groups' own work a train call replays:
the nodes of the captured step's stage map in `rollout.obs.pixels`,
`rollout.policy.pixels`, `update.forward.pixels` or `update.render`
(`portbench/styles.py`); None for a program without the style stages."""
from portbench import styles


def read(ctx):
    if ctx.kind != "train":
        return None
    return styles.ops("pixels")
