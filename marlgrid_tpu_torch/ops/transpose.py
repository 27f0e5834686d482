"""Batch-major -> batch-minor transpose: kernel K1 and its plain version.

Counterpart of ``marlgrid_tpu/ops/transpose.py::transpose_bk``. On a CUDA
tensor the wrapper launches the hand-written kernel in
``csrc/transpose.cu``; on a CPU tensor it takes the plain version. There is
no fallback: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def transpose_bk_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, K) -> (K, B), contiguous: the reference the kernel is held to."""
    return x.t().contiguous()


def transpose_bk(x: torch.Tensor) -> torch.Tensor:
    """(B, K) int32 -> (K, B) int32, bit-exact."""
    if x.device.type == "cpu":
        return transpose_bk_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"transpose_bk: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"transpose_bk: wants a contiguous 2-D int32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    B, K = x.shape
    if B >= 2 ** 31 or K > 65535 * 32:     # the grid's x and y limits
        raise ValueError(f"transpose_bk: shape {tuple(x.shape)} too large")
    y = torch.empty((K, B), dtype=x.dtype, device=x.device)
    fn = _build.function("transpose", "transpose_bk_b32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), B, K, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"transpose_bk: kernel launch failed "
                           f"(cudaError {rc})")
    transpose_bk.launches += 1
    return y


#: launches of the K1 kernel in this process (CUDA calls only)
transpose_bk.launches = 0
