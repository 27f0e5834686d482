"""Mean device milliseconds a traced train call's graph replay spent in the
policy: the nodes that the capture's stage map puts in `rollout.policy` and
`rollout.sample` (`portbench/stages.py`); silent where a call does not match
the map."""
from portbench import stages


def read(ctx):
    if ctx.kind != "train":
        return None
    return stages.ms(ctx.trace, "policy")
