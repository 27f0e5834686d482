"""Mean device milliseconds a traced train call's graph replay spent in the
encode groups' own work: the nodes that the capture's stage map puts in
`rollout.obs.encode`, `rollout.policy.encode` or `update.forward.encode`
(`portbench/styles.py`); silent where a call does not match the map or the
program has no style stages."""
from portbench import styles


def read(ctx):
    if ctx.kind != "train":
        return None
    return styles.ms(ctx.trace, "encode")
