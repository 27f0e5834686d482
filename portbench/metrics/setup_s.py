"""Host seconds from the process's start to the window's start: imports,
the card, the kernels' build or load, the inputs, the eager first call
and the capture of the cell's own step."""
def read(ctx):
    return ctx.setup_s
