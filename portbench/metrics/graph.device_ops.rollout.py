"""Device operations (kernels, memcpys, memsets) a traced acting call ran."""
def read(ctx):
    if ctx.kind != "rollout" or ctx.trace is None:
        return None
    return len(ctx.trace.ops) / ctx.trace.calls
