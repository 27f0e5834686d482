"""All env transitions completed by the acting calls of the window (B * T a
call) over the window's wall time."""
def read(ctx):
    if ctx.kind != "rollout":
        return None
    return len(ctx.calls) * ctx.env_steps_per_call / ctx.window_s
