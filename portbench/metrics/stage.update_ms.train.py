"""Mean device milliseconds a traced train call's graph replay spent in the
update: the nodes that the capture's stage map puts in `update` and its stages
but `update.render` (`portbench/stages.py`); silent where a call does not
match the map."""
from portbench import stages


def read(ctx):
    if ctx.kind != "train":
        return None
    return stages.ms(ctx.trace, "update")
