"""Mean device milliseconds a traced train call's graph replay spent outside
the env engine, the observations, the policy and the update: the nodes of the
capture's stage map in none of their stages, the root `step`'s own (the carry
copies, the episode tallies), `rollout`'s own and `rollout.store`
(`portbench/stages.py`); silent where a call does not match the map."""
from portbench import stages


def read(ctx):
    if ctx.kind != "train":
        return None
    return stages.ms(ctx.trace, "other")
