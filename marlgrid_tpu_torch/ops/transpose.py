"""Layout swaps: the batch-major -> batch-minor transpose (kernel K1), the
trajectory transpose (kernel K4) and their plain versions.

Counterpart of ``marlgrid_tpu/ops/transpose.py`` (``transpose_bk`` and
``transpose_traj``). On a CUDA tensor a wrapper launches its hand-written
kernel in ``csrc/transpose.cu``; on a CPU tensor it takes the plain
version. There is no fallback: a CUDA tensor the kernel does not take
raises.
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

_TRAJ_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6
                  + (ctypes.c_void_p,))
_TRAJ_SYMBOLS = {torch.uint8: "transpose_traj_b8",
                 torch.int32: "transpose_traj_b32"}
_VEC_BYTES = 16
_SMEM_DEFAULT = 48 * 1024       # a block's shared memory without opt-in
_SMEM_MAX = 232448              # 227 KB, an H100 block's opt-in limit


def traj_plan(F: int, B: int, itemsize: int) -> dict:
    """The K4 kernel's tiling of one (F, B) plane: ``log_vecs`` (a tile row
    is ``2 ** log_vecs`` 16-byte vectors: 8, halved while the chunk would
    pass 48 KB), ``cols`` (columns per tile), ``smem`` (the chunk's bytes,
    ``cols * F * itemsize``) and ``tiles`` (column tiles per plane).
    Raises for an F whose narrowest chunk (16 bytes of columns) passes 227
    KB of shared memory."""
    log_vecs = 3
    while log_vecs > 0 and (_VEC_BYTES << log_vecs) * F > _SMEM_DEFAULT:
        log_vecs -= 1
    smem = (_VEC_BYTES << log_vecs) * F
    if smem > _SMEM_MAX:
        raise ValueError(f"transpose_traj: F = {F} too wide (a 16-byte "
                         f"column tile of {smem} bytes passes the "
                         f"{_SMEM_MAX}-byte shared memory; F <= "
                         f"{_SMEM_MAX // _VEC_BYTES})")
    cols = (_VEC_BYTES << log_vecs) // itemsize
    return dict(log_vecs=log_vecs, cols=cols, smem=smem,
                tiles=-(-B // cols))


def transpose_traj_plain(x: torch.Tensor) -> torch.Tensor:
    """(T, N, F, B) -> (N, T, B, F), contiguous: the reference the kernel is
    held to."""
    return x.permute(1, 0, 3, 2).contiguous()


def transpose_traj(x: torch.Tensor) -> torch.Tensor:
    """(T, N, F, B) uint8 or int32 -> (N, T, B, F), bit-exact: the bulk swap
    of a batch-minor trajectory into sample-major rows."""
    if x.device.type == "cpu":
        return transpose_traj_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"transpose_traj: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _TRAJ_SYMBOLS or \
            not x.is_contiguous():
        raise ValueError(f"transpose_traj: wants a contiguous 4-D uint8 or "
                         f"int32 tensor (T, N, F, B), got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    T, N, F, B = x.shape
    if max(T, N, B) >= 2 ** 31:
        raise ValueError(f"transpose_traj: shape {tuple(x.shape)} has a "
                         f"dimension past 2**31 - 1")
    plan = traj_plan(F, B, x.element_size())
    y = torch.empty((N, T, B, F), dtype=x.dtype, device=x.device)
    fn = _build.function("transpose", _TRAJ_SYMBOLS[x.dtype], _TRAJ_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), T, N, F, B, plan["log_vecs"],
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"transpose_traj: kernel launch failed "
                           f"(cudaError {rc})")
    transpose_traj.launches += 1
    return y


#: launches of the K4 kernel in this process (CUDA calls only)
transpose_traj.launches = 0
