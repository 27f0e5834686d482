"""Device operations (kernels, memcpys, memsets) a traced train call ran."""
def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    return len(ctx.trace.ops) / ctx.trace.calls
