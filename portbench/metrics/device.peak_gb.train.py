"""GB of `torch.cuda.max_memory_reserved` over the window and the traced
calls, after a reset at the window's start: what the process holds on the
card while it trains, the graph's private pool with it (a replay's
intermediates live there, which allocated bytes do not count)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.peak_window_bytes / 1e9
