"""Sprite composite of the image observation: kernel K3 and its plain
version.

Counterpart of ``marlgrid_tpu/ops/sprite.py::compose_image_b``: per view
cell ids, batch-minor ``(N, vs, vs, B)`` int32 (base sprite row, agent
overlay row, prestige level), become uint8 pixels, each
``alpha(agent) ? trunc_u8(agent_rgb * PRESTIGE_DIM[level]) : base_rgb``,
in the standard image layout or the space-to-depth (s2d) one. On a CUDA
tensor the wrapper launches the hand-written kernel in ``csrc/sprite.cu``,
a lookup into the full sprite tables (no palette, no matmul) that copies
granules of 16, 8 or 1 bytes: the tables are re-laid once in the image's
byte order for the layout (:func:`kernel_tables`), and each granule of an
image is mapped to its view cell and its offset in a re-laid row
(:func:`granule_map`). On a CPU tensor it takes the plain version. There
is no fallback: a CUDA call the kernel cannot serve raises, and an id out
of range stops the kernel (the next synchronisation raises).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from ..device import const
from . import _build

_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6
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


def granule(tile_size: int, s2d: bool) -> int:
    """Bytes of the kernel's granule, a run of image bytes that shows one
    view cell's re-laid row in order: 16 in s2d (a 48-byte block lies in
    one tile), 8 in the standard layout when a tile row is a multiple of 8
    bytes (T % 8 == 0), else 1 (the byte path)."""
    if s2d:
        return 16
    return 8 if tile_size % 8 == 0 else 1


def _row_offsets(T: int, s2d: bool) -> np.ndarray:
    """(T, T, 3): where byte (ty, tx, c) of a sprite goes in a re-laid table
    row, the order in which the image stores the tile's bytes: pixel-major
    (each tile row's T*3 bytes together) for the standard layout; for s2d
    each 4 x 4 block's 48 bytes together, as channel (ty%4)*12 + (tx%4)*3 +
    c of block (ty//4, tx//4)."""
    ty, tx, c = np.meshgrid(np.arange(T), np.arange(T), np.arange(3),
                            indexing="ij")
    if not s2d:
        return (ty * T + tx) * 3 + c
    return (((ty // 4) * (T // 4) + tx // 4) * 48 + (ty % 4) * 12
            + (tx % 4) * 3 + c)


@functools.lru_cache(maxsize=None)
def kernel_tables(tile_size: int, s2d: bool, device) -> tuple:
    """The kernel's tables, each row re-laid by :func:`_row_offsets`:
    ``(base (N_BASE_APPEAR + 1, T*T*3), over (N_PRESTIGE_LEVELS,
    N_AGENT_APPEAR, T*T*3), mask (N_AGENT_APPEAR, T*T*3))`` uint8 on
    ``device``. ``over[l, a]`` is agent row a's rgb times PRESTIGE_DIM[l]
    truncated to uint8, the plain version's own float32 product; ``mask``
    is 255 where the agent row's alpha is nonzero (row 0, no agent, is all
    zero). Cached and shared: never write to them."""
    T = tile_size
    if s2d and T % 4:
        raise ValueError(f"the s2d layout needs T % 4 == 0, got {T}")
    blut, alut = tables(T, device)
    dim = const(C.PRESTIGE_DIM, torch.float32, device)
    over = (alut[None, ..., :3].float()
            * dim[:, None, None, None, None]).to(torch.uint8)
    mask = (alut[..., 3:] > 0).expand(alut.shape[:3] + (3,)).to(
        torch.uint8) * 255
    src = np.empty(T * T * 3, np.int64)      # re-laid offset -> (ty, tx, c)
    src[_row_offsets(T, s2d).reshape(-1)] = np.arange(T * T * 3)
    src = torch.as_tensor(src, device=device)
    return tuple(t.reshape(t.shape[:-3] + (-1,))[..., src].contiguous()
                 for t in (blut, over, mask))


@functools.lru_cache(maxsize=None)
def granule_map(view_size: int, tile_size: int, s2d: bool, device):
    """(G, map): :func:`granule` G and, per granule of an image (G bytes
    from byte i*G), an int32 holding the view cell it shows (vi*vs + vj,
    the ids' cell order) in its low 16 bits and its byte offset in a
    re-laid table row in its high 16, on ``device``. Raises if a granule
    would straddle two cells or a row's order, or sit unaligned."""
    vs, T = view_size, tile_size
    side, G = vs * T, granule(T, s2d)
    if T * T * 3 >= 2 ** 16 or vs * vs > 2 ** 16:
        raise ValueError(f"compose_image_b: view {vs}, tile {T} too large "
                         f"for the kernel's 16-bit granule map")
    o = np.arange(side * side * 3)
    if s2d:
        blk, ch = np.divmod(o, 48)
        br, bq = np.divmod(blk, side // 4)
        r, q, c = br * 4 + ch // 12, bq * 4 + ch % 12 // 3, ch % 3
    else:
        p, c = np.divmod(o, 3)
        r, q = np.divmod(p, side)
    cell = ((q // T) * vs + r // T).reshape(-1, G)
    off = _row_offsets(T, s2d)[r % T, q % T, c].reshape(-1, G)
    if not ((cell == cell[:, :1]).all() and (off[:, 0] % G == 0).all()
            and (off == off[:, :1] + np.arange(G)).all()):
        raise RuntimeError(f"compose_image_b: {G}-byte granules do not "
                           f"follow the re-laid rows at T={T}, s2d={s2d}")
    gmap = (cell[:, 0] | off[:, 0] << 16).astype(np.int32)
    return G, torch.as_tensor(gmap, device=device)


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
    base_t, over, mask = kernel_tables(T, s2d, base_id.device)
    G, gmap = granule_map(vs, T, s2d, base_id.device)
    lead = (N, B) if nb_layout else (B, N)
    out = torch.empty(lead + _image_shape(vs, T, s2d), dtype=torch.uint8,
                      device=base_id.device)
    stride_n, stride_b = (B, 1) if nb_layout else (1, N)
    fn = _build.function("sprite", "compose_image_b", _ARGTYPES)
    stream = torch.cuda.current_stream(base_id.device).cuda_stream
    rc = fn(base_id.data_ptr(), agent_id.data_ptr(), alvl.data_ptr(),
            base_t.data_ptr(), over.data_ptr(), mask.data_ptr(),
            gmap.data_ptr(), out.data_ptr(), N, B, vs, T, int(s2d), G,
            stride_n, stride_b, base_id.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"compose_image_b: kernel launch failed "
                           f"(cudaError {rc})")
    compose_image_b.launches += 1
    return out


#: launches of the K3 kernel in this process (CUDA calls only)
compose_image_b.launches = 0
