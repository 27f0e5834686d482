"""Plain versions of the port's kernels, frozen: no CUDA source, no build."""
from .transpose import transpose_bk  # noqa: F401
