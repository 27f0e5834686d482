"""Host seconds of the cell's eager first call through the device's completion
of it (`parallel/graph.py::GraphedStep.first_s`): the call that fills the
device tables, Adam's state and the library handles before the capture."""
from portbench import stages


def read(ctx):
    firsts = [getattr(s, "first_s", None) for s in stages.steps()]
    if not firsts or None in firsts:
        return None
    return sum(firsts)
