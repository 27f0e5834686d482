"""Sprite composite of the image observation: kernel K3 and its plain
version.

Counterpart of ``marlgrid_tpu/ops/sprite.py::compose_image_b``: per view
cell ids, batch-minor ``(N, vs, vs, B)`` int32 (base sprite row, agent
overlay row, prestige level), become uint8 pixels, each
``alpha(agent) ? trunc_u8(agent_rgb * PRESTIGE_DIM[level]) : base_rgb``,
in the standard image layout or the space-to-depth (s2d) one. On a CUDA
tensor the wrapper launches the hand-written kernel in ``csrc/sprite.cu``,
a table lookup into the full sprite tables (no palette, no matmul); on a
CPU tensor it takes the plain version. There is no fallback: a CUDA call
the kernel cannot serve raises, and an id out of range stops the kernel
(the next synchronisation raises).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from ..device import const
from . import _build

_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
             + (ctypes.c_longlong,) * 2 + (ctypes.c_int, ctypes.c_void_p))


@functools.lru_cache(maxsize=None)
def _tables_np(tile_size: int):
    from .. import rendering

    base = np.concatenate([rendering.base_lut(tile_size),
                           np.zeros((1, tile_size, tile_size, 3), np.uint8)])
    return base, rendering.agent_lut(tile_size)


@functools.lru_cache(maxsize=None)
def tables(tile_size: int, device) -> tuple:
    """``(base (N_BASE_APPEAR + 1, T, T, 3), agent (N_AGENT_APPEAR, T, T,
    4))`` uint8 sprite tables on ``device``, the base table padded with one
    black row (id N_BASE_APPEAR: an invisible cell). Cached and shared:
    never write to them."""
    return tuple(torch.from_numpy(t.copy()).to(device)
                 for t in _tables_np(tile_size))


def _image_shape(vs: int, T: int, s2d: bool):
    side = vs * T
    return (side // 4, side // 4, 48) if s2d else (side, side, 3)


def _check(params, base_id, agent_id, alvl, s2d):
    vs, T = params.view_size, params.view_tile_size
    shape = tuple(base_id.shape)
    if (len(shape) != 4 or shape[1:3] != (vs, vs)
            or tuple(agent_id.shape) != shape or tuple(alvl.shape) != shape):
        raise ValueError(
            f"compose_image_b: wants ids (N, {vs}, {vs}, B), all three of "
            f"one shape; got {shape}, {tuple(agent_id.shape)}, "
            f"{tuple(alvl.shape)}")
    if s2d and T % 4:
        raise ValueError(f"compose_image_b: the s2d layout needs "
                         f"view_tile_size % 4 == 0, got {T}")
    return shape[0], shape[3], vs, T


def compose_image_b_plain(params, base_id, agent_id, alvl, nb_layout=False,
                          s2d=False) -> torch.Tensor:
    """The reference K3 is held to, in plain tensor ops: index the sprite
    tables by the ids, ``where(alpha > 0, trunc_u8(rgb * dim), base)``, then
    the tile interleave (cell (vi, vj) at rows vj*T.., columns vi*T..) and
    the optional s2d permutation (pixel (r, q, c) to channel (r%4)*12 +
    (q%4)*3 + c of block (r//4, q//4)). Same signature and result as
    :func:`compose_image_b`."""
    N, B, vs, T = _check(params, base_id, agent_id, alvl, s2d)
    blut, alut = tables(T, base_id.device)
    base = blut[base_id.long()]                  # (N, vs, vs, B, T, T, 3)
    over = alut[agent_id.long()]                 # (N, vs, vs, B, T, T, 4)
    dim = const(C.PRESTIGE_DIM, torch.float32, base_id.device)[alvl.long()]
    # float32 rgb * dim is exact (bytes <= 255, 8-bit-mantissa factors);
    # .to(uint8) truncates toward zero, as JAX's astype
    rgb = over[..., :3].float().mul_(dim[..., None, None, None]).to(
        torch.uint8)
    img = torch.where(over[..., 3:] > 0, rgb, base)
    img = img.permute(0, 3, 2, 4, 1, 5, 6)       # (N, B, vj, ty, vi, tx, 3)
    side = vs * T
    if s2d:
        img = img.reshape(N, B, side // 4, 4, side // 4, 4, 3).permute(
            0, 1, 2, 4, 3, 5, 6)
    img = img.reshape((N, B) + _image_shape(vs, T, s2d))
    if not nb_layout:
        img = img.transpose(0, 1)
    return img.contiguous()


def compose_image_b(params, base_id, agent_id, alvl, nb_layout=False,
                    s2d=False) -> torch.Tensor:
    """uint8 images from batch-minor per-cell ids, kernel K3 on the card.

    ``base_id``: (N, vs, vs, B) int32 sprite rows (N_BASE_APPEAR = black,
    invisible); ``agent_id``: (N, vs, vs, B) int32 (0 = none, else 1 +
    color*4 + reldir, already masked by visibility); ``alvl``: (N, vs, vs,
    B) int32 prestige level of the observed agent (0..7). N comes from the
    ids (an observer subset renders its own observers). Returns (B, N,
    vs*T, vs*T, 3), or (N, B, ...) with ``nb_layout``; ``s2d`` gives the
    space-to-depth (..., vs*T/4, vs*T/4, 48) image instead. The kernel
    writes either layout directly.
    """
    if base_id.device.type == "cpu":
        return compose_image_b_plain(params, base_id, agent_id, alvl,
                                     nb_layout, s2d)
    if base_id.device.type != "cuda" or any(
            t.device != base_id.device for t in (agent_id, alvl)):
        raise ValueError(f"compose_image_b: ids on {base_id.device}, "
                         f"{agent_id.device}, {alvl.device}")
    N, B, vs, T = _check(params, base_id, agent_id, alvl, s2d)
    for t in (base_id, agent_id, alvl):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"compose_image_b: wants contiguous int32 ids; "
                             f"got {t.dtype} contiguous={t.is_contiguous()}")
    if N * vs * vs * B >= 2 ** 31:
        raise ValueError(f"compose_image_b: {N * B} views too many")
    blut, alut = tables(T, base_id.device)
    dims = const(C.PRESTIGE_DIM, torch.float32, base_id.device)
    lead = (N, B) if nb_layout else (B, N)
    out = torch.empty(lead + _image_shape(vs, T, s2d), dtype=torch.uint8,
                      device=base_id.device)
    stride_n, stride_b = (B, 1) if nb_layout else (1, N)
    fn = _build.function("sprite", "compose_image_b", _ARGTYPES)
    stream = torch.cuda.current_stream(base_id.device).cuda_stream
    rc = fn(base_id.data_ptr(), agent_id.data_ptr(), alvl.data_ptr(),
            blut.data_ptr(), alut.data_ptr(), dims.data_ptr(), out.data_ptr(),
            N, B, vs, T, int(s2d), stride_n, stride_b, base_id.device.index,
            stream)
    if rc != 0:
        raise RuntimeError(f"compose_image_b: kernel launch failed "
                           f"(cudaError {rc})")
    compose_image_b.launches += 1
    return out


#: launches of the K3 kernel in this process (CUDA calls only)
compose_image_b.launches = 0
