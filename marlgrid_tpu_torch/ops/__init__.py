"""Hand-written Hopper kernels (CUDA C++ under csrc/), each with its plain
PyTorch version beside it."""
from .transpose import transpose_bk  # noqa: F401
