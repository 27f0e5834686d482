"""Launches of the threefry2x32 kernel (`ops/threefry.py`) a train call:
every hash of the replayed step (the env engine's draws, the policy's Gumbel
draws, the update's permutations), counted by the wrapper while the step is
captured and added at each replay. None for a program without the kernel."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.launches.get("threefry2x32")
