"""Host seconds of the capturing call (the second call: the capture and its
first replay, synchronized), `parallel/graph.py::GraphedStep`."""
def read(ctx):
    return ctx.capture_s
