"""Mean device milliseconds a traced acting call's graph replay spent in the
observations: the nodes that the capture's stage map puts in `rollout.obs`
(K1, view gathers) (`portbench/stages.py`); silent where a call does not match
the map."""
from portbench import stages


def read(ctx):
    if ctx.kind != "rollout":
        return None
    return stages.ms(ctx.trace, "obs")
