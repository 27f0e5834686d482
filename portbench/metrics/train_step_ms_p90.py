"""The 90th percentile of the wall time of every train call in the window,
each timed as the train CLI runs it: the call, then its metrics read to
floats (which waits for the card). The run prints the sample count."""
import statistics


def read(ctx):
    if ctx.kind != "train":
        return None
    ms = [done * 1e3 for _, done in ctx.calls]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
