"""All env transitions completed by the train calls of the window (B * T a
call, summed over the ranks) over the window's wall time."""
def read(ctx):
    if ctx.kind != "train":
        return None
    return len(ctx.calls) * ctx.env_steps_per_call / ctx.window_s
