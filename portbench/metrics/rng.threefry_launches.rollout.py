"""Launches of the threefry2x32 kernel (`ops/threefry.py`) an acting call:
every hash of the replayed rollout (the env engine's draws, the fresh
boards', the policy's Gumbel draws), counted by the wrapper while the
rollout is captured and added at each replay. None for a program without
the kernel."""


def read(ctx):
    if ctx.kind != "rollout":
        return None
    return ctx.launches.get("threefry2x32")
