"""1 - (union of the device's work) / (the traced calls' spans), both on the
device's clock: each traced train call's span runs from its first device op's
start to its last one's end, less the gaps the profiler's own bookkeeping
held (``tracing.Trace.idle_share``)."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    return ctx.trace.idle_share()
