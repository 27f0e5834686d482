"""The sprite composite of the image observation, plain (frozen from the
port's ``ops/sprite.py``): index the sprite tables by the ids, dim the
agents' rgb by their prestige level, interleave the tiles."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C
from ..device import const


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
    """uint8 images from batch-minor per-cell ids (the plain version)."""
    return compose_image_b_plain(params, base_id, agent_id, alvl, nb_layout,
                                 s2d)
