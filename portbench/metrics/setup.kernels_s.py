"""Host seconds the process spent building (nvcc) or loading the kernel
libraries (`ops/_build.py::build_s`)."""


def read(ctx):
    from marlgrid_tpu_torch.ops import _build

    return getattr(_build, "build_s", None)
