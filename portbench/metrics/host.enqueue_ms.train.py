"""Mean host milliseconds a train call of the window took to return, before
its metrics were read: what the host spends launching the graph."""
def read(ctx):
    if ctx.kind != "train":
        return None
    return 1e3 * sum(enq for enq, _ in ctx.calls) / len(ctx.calls)
