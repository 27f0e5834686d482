"""Mean host milliseconds an acting call of the window took to return,
before its episode count was read."""
def read(ctx):
    if ctx.kind != "rollout":
        return None
    return 1e3 * sum(enq for enq, _ in ctx.calls) / len(ctx.calls)
