"""Device operations of the env engine a train call replays: the nodes of the
captured step's stage map in `rollout.env_step` and `rollout.fresh_pool`
(`portbench/stages.py`)."""
from portbench import stages


def read(ctx):
    if ctx.kind != "train":
        return None
    return stages.ops("env")
