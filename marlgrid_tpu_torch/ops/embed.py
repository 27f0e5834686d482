"""Fused one-hot embed, forward and weight gradient: kernels K2f and K2b and
their plain versions.

Counterpart of ``marlgrid_tpu/ops/embed.py``: the encode-obs torso's first
layer, ``out[r, s, :] = sum over view cells of W_type[code] + W_color[code]
+ W_state[min(code, 19)]``, on feature-major codes ``(R, 3*cells, S)``, and
its gradient with respect to the table. On CUDA tensors the wrappers launch
the hand-written kernels, both the one-hot product on the tensor cores:
``csrc/embed_fwd.cu`` with the table staged in shared memory (float32 sums,
one rounding to bf16, as the TPU kernel) and ``csrc/embed_bwd.cu`` (bf16
``dout``, float32 sums). On CPU tensors they take the plain dense one-hot
formulation. There is no fallback between them.

:func:`onehot_embed` is differentiable in the table: when the table needs a
gradient it runs through an autograd Function whose backward is K2b on the
card and the plain backward on the CPU (the codes get no gradient).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as C
from . import _build

N_STATE_CODES = 20                      # door states + bonus phases
WIDTHS = (C.N_TYPES + 1, C.N_COLORS + 1, N_STATE_CODES)
_FWD_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9
                 + (ctypes.c_void_p,))
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10
                 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p))
#: K2b plan (csrc/embed_bwd.cu): blocks to aim for, a constant (two per SM
#: of an H100) so the plan and the bits never depend on the card; samples
#: staged per step (kSteps); rows per warp (kWarpRows); warps per block
_BWD_BLOCKS = 2 * 132
_BWD_STEP = 128
_BWD_WARP_ROWS = 32
_BWD_WARPS = 8
#: K2f/K5f plan (csrc/embed_fwd.cu): SMs of an H100, a constant so the plan
#: never depends on the card; samples per tile (kTile); the shared memory a
#: block may use, and the slot table's static share of it
_FWD_SMS = 132
_FWD_TILE = 128
_FWD_SMEM = 227 * 1024
_FWD_LUT_BYTES = 3 * 256 * 2


def vocab(palettes=None):
    """(widths, values) of the embed's per-plane vocabularies: the full
    static ones (values None) or a compact palette from
    ``core/obs.py::encode_palettes``."""
    if palettes is None:
        return WIDTHS, None
    values = tuple(tuple(int(x) for x in v) for v in palettes)
    return tuple(len(v) for v in values), values


def slot_table(widths=WIDTHS, values=None) -> np.ndarray:
    """(3, 256) int16: the row, within a cell's (sum(widths), H) table, that
    code c of plane p selects, or -1 for none.

    Full vocabulary: type and color codes past their width select nothing,
    state codes clip to 19. Palette: a code outside plane p's vocabulary
    selects nothing (the one-hot of an unused slot)."""
    lut = np.full((3, 256), -1, np.int16)
    off = 0
    for p, n in enumerate(widths):
        if values is None:
            codes = np.arange(256)
            slot = np.minimum(codes, n - 1) if p == 2 else codes
            lut[p] = np.where(slot < n, off + slot, -1)
        else:
            for k, v in enumerate(values[p]):
                if not 0 <= v < 256:
                    raise ValueError(f"palette code {v} outside [0, 256)")
                lut[p, v] = off + k
        off += n
    return lut


@functools.lru_cache(maxsize=None)
def _slot_table_on(widths, values, device) -> torch.Tensor:
    return torch.as_tensor(slot_table(widths, values), device=device)


def pack_weights(w0, w1, w2) -> torch.Tensor:
    """(cells, n_p, H) per-plane tables -> (cells, sum(n_p), H): the layout
    both versions read (no group padding: that was the TPU matrix unit's)."""
    return torch.cat([w0, w1, w2], dim=1)


def onehot_embed_plain(x, w, widths=WIDTHS, values=None,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The dense one-hot formulation in ``dtype``: codes (R, 3*cells, S)
    and table (cells, sum(widths), H) -> (R, S, H). Per plane, the one-hot
    of the codes contracted with that plane's rows over (cell, slot)."""
    R, F, S = x.shape
    cells = F // 3
    o = x.long().reshape(R, 3, cells, S)
    out = None
    off = 0
    for p, n in enumerate(widths):
        code = o[:, p]
        if values is None:
            if p == 2:
                code = code.clamp(0, N_STATE_CODES - 1)
            voc = torch.arange(n, device=x.device)
        else:
            voc = torch.as_tensor(values[p], device=x.device)
        oh = (code[:, :, None, :] == voc[:, None]).to(dtype)  # (R,cells,n,S)
        y = torch.einsum("rcns,cnh->rsh", oh, w[:, off:off + n].to(dtype))
        out = y if out is None else out + y
        off += n
    return out


def onehot_embed_bwd_plain(x, dout, widths=WIDTHS,
                           values=None) -> torch.Tensor:
    """The weight gradient of :func:`onehot_embed_plain`: codes (R,
    3*cells, S) and ``dout`` (R, S, H) -> (cells, sum(widths), H) float32.
    Per plane, the one-hot of the codes contracted with ``dout`` over
    (row, sample), summed in float32 (``dout`` is read as it comes: the
    caller casts it to the compute dtype first)."""
    R, F, S = x.shape
    cells = F // 3
    o = x.long().reshape(R, 3, cells, S)
    d = dout.float()
    parts = []
    for p, n in enumerate(widths):
        code = o[:, p]
        if values is None:
            if p == 2:
                code = code.clamp(0, N_STATE_CODES - 1)
            voc = torch.arange(n, device=x.device)
        else:
            voc = torch.as_tensor(values[p], device=x.device)
        oh = (code[:, :, None, :] == voc[:, None]).float()  # (R,cells,n,S)
        parts.append(torch.einsum("rcns,rsh->cnh", oh, d))
    return torch.cat(parts, dim=1)


def _check_codes(name, x, F_want=None):
    if x.dtype != torch.uint8 or not x.is_contiguous() or x.dim() != 3 or (
            F_want is not None and x.shape[1] != F_want):
        raise ValueError(f"{name}: wants contiguous uint8 codes (R, 3*cells, "
                         f"S); got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def row_bases(cells: int, widths=WIDTHS, plane_major=False) -> np.ndarray:
    """(3*cells,) int32: the forward kernel's row base of each feature f =
    p*cells + j, so that its code selects table row ``rbase[f] +
    lut[p, code]``.

    Packed (K2f: one (cells, cw, H) table, ``lut`` = :func:`slot_table`,
    which holds the plane offsets): ``j * cw``. Plane-major (K5f: the three
    (cells, n_p, H) tables back to back, ``lut`` = the slot within plane
    p): ``cells * (n_0 + .. + n_{p-1}) + j * n_p``."""
    j = np.arange(cells)
    if not plane_major:
        return np.tile(j * sum(widths), 3).astype(np.int32)
    off = np.cumsum((0,) + tuple(widths[:-1]))
    return np.concatenate([cells * o + j * n
                           for o, n in zip(off, widths)]).astype(np.int32)


def fwd_walk(cells: int, widths=WIDTHS, plane_major=False) -> np.ndarray:
    """The forward kernel's walk over the features, int32: first (feature,
    its :func:`row_bases` entry) for the 3*cells features in the order of
    the table rows they select (packed: cell by cell, the three planes of a
    cell in turn; plane-major: the features in order), then, for each
    32-row mask word of the table, the range [i0, i1) of those features
    whose rows can fall in it."""
    rbase = row_bases(cells, widths, plane_major)
    order = np.lexsort((np.arange(rbase.size), rbase))
    plane = order // cells
    off = np.cumsum((0,) + tuple(widths[:-1]))
    lo = rbase[order] + (0 if plane_major else off[plane])
    hi = lo + np.asarray(widths)[plane]
    words = 32 * np.arange(-(-(cells * sum(widths)) // 32))
    ranges = np.stack([np.searchsorted(hi, words, "right"),
                       np.searchsorted(lo, words + 32, "left")], 1)
    return np.concatenate([np.stack([order, rbase[order]], 1).ravel(),
                           ranges.ravel()]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _fwd_walk_on(cells, widths, plane_major, device) -> torch.Tensor:
    return torch.as_tensor(fwd_walk(cells, widths, plane_major),
                           device=device)


class FwdPlan(NamedTuple):
    """K2f's and K5f's launch plan (see :func:`fwd_plan`)."""
    bn: int        # hidden units per block (16, 32, 64 or 128)
    n_groups: int  # groups of bn units over H
    k_steps: int   # 16-row steps over the table's rows, an even number
    tiles: int     # tiles of _FWD_TILE samples over R * S
    blocks: int    # blocks per group
    smem: int      # dynamic shared memory per block, bytes


def fwd_smem(F: int, k_steps: int, bn: int) -> int:
    """A forward block's dynamic shared memory: the table's slice (16 *
    k_steps rows of bn bf16 units), two buffers of row masks (a 32-bit word
    per pair of k-steps per sample of a tile), the codes of a tile and 16
    bytes per feature (row base, plane, index)."""
    return (k_steps * 16 * 2 * bn + 2 * (k_steps // 2) * _FWD_TILE * 4
            + F * (_FWD_TILE + 16))


def fwd_plan(R: int, S: int, F: int, rows: int, H: int) -> FwdPlan:
    """The forward kernel's launch plan, a function of the shapes only.

    Each block stages all ``rows`` table rows (padded to a multiple of 32)
    of a group of ``bn`` hidden units in shared memory and walks tiles of
    ``_FWD_TILE`` samples: block b takes group b % n_groups and tiles
    b // n_groups, + blocks, + 2 * blocks, ... bn is the least of 16, 32,
    64 that holds H, else 128, halved until the slice fits an SM. Per group
    there are as many blocks as tiles, at most ``_FWD_SMS // n_groups`` (and
    at least one). Every output element is summed by one thread in a fixed
    order, so the plan does not change the bits either."""
    k_steps = 2 * -(-rows // 32)
    bn = next((b for b in (16, 32, 64) if H <= b), 128)
    while bn > 16 and fwd_smem(F, k_steps, bn) + _FWD_LUT_BYTES > _FWD_SMEM:
        bn //= 2
    smem = fwd_smem(F, k_steps, bn)
    if smem + _FWD_LUT_BYTES > _FWD_SMEM:
        raise ValueError(f"onehot_embed: a table of {rows} rows does not fit "
                         f"in shared memory even 16 hidden units at a time")
    n_groups = -(-H // bn)
    tiles = -(-(R * S) // _FWD_TILE)
    blocks = max(1, min(tiles, _FWD_SMS // n_groups))
    return FwdPlan(bn, n_groups, k_steps, tiles, blocks, smem)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied if its data does not start on 16 bytes (the
    forward kernel's table copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, w, widths, values, dtype) -> torch.Tensor:
    """The forward on x's device: the plain version on the CPU, K2f on the
    card."""
    if x.device.type == "cpu":
        return onehot_embed_plain(x, w, widths, values, dtype)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"onehot_embed: codes on {x.device}, table on "
                         f"{w.device}")
    cells, cw, H = w.shape
    _check_codes("onehot_embed", x, 3 * cells)
    R, F, S = x.shape
    if cw != sum(widths) or H % 2 or not 0 < H <= 2048 or R > 65535:
        raise ValueError(
            f"onehot_embed: wants R <= 65535 and a (cells, {sum(widths)}, H) "
            f"table with even H <= 2048; got codes {tuple(x.shape)}, table "
            f"{tuple(w.shape)}")
    plan = fwd_plan(R, S, F, cells * cw, H)
    w = _aligned(w.to(torch.bfloat16))
    lut = _slot_table_on(tuple(widths), values, x.device)
    walk = _fwd_walk_on(cells, tuple(widths), False, x.device)
    out = torch.empty((R, S, H), dtype=torch.bfloat16, device=x.device)
    fn = _build.function("embed_fwd", "onehot_embed_fwd", _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), lut.data_ptr(), walk.data_ptr(),
            out.data_ptr(), R, F, S, cells, cw, H, plan.bn, plan.blocks,
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"onehot_embed: kernel launch failed "
                           f"(cudaError {rc})")
    onehot_embed.launches += 1
    return out


class BwdPlan(NamedTuple):
    """K2b's launch plan (see :func:`bwd_plan`)."""
    bn: int          # hidden units per block (16, 32, 64 or 128)
    bm: int          # table rows per block
    row_groups: int  # blocks over the cells * cw rows
    n_groups: int    # blocks over the hidden units
    span: int        # view cells the rows of one block touch, at most
    chunk: int       # samples per block, a multiple of _BWD_STEP
    n_chunks: int    # blocks over the R * S samples


def bwd_plan(R: int, S: int, cells: int, cw: int, H: int) -> BwdPlan:
    """K2b's launch plan, a function of the shapes only (so a run repeats
    itself bit for bit on any card).

    The (cells * cw, H) gradient is cut into tiles of ``bm`` rows by ``bn``
    hidden units (bn the least of 16, 32, 64, 128 that holds H, else 128;
    a warp keeps 32 rows by min(bn, 64) units of float32 sums in
    registers, so bm = 32 * 8 warps / (bn / min(bn, 64))). The samples are
    cut into ``n_chunks`` chunks of ``chunk`` so that the grid is at most
    ``_BWD_BLOCKS`` blocks, one wave (or one chunk, where the tiles alone
    are more); each block sums its chunk, and a second pass adds the chunks
    in order."""
    bn = next((b for b in (16, 32, 64) if H <= b), 128)
    bm = _BWD_WARP_ROWS * _BWD_WARPS // (bn // min(bn, 64))
    rows = cells * cw
    row_groups = -(-rows // bm)
    span = max((min(rows, r0 + bm) - 1) // cw - r0 // cw + 1
               for r0 in range(0, rows, bm))
    n_groups = -(-H // bn)
    M = max(R * S, 1)
    steps = -(-M // _BWD_STEP)
    n_chunks = max(1, min(_BWD_BLOCKS // (row_groups * n_groups), steps))
    chunk = -(-steps // n_chunks) * _BWD_STEP
    return BwdPlan(bn, bm, row_groups, n_groups, span, chunk, -(-M // chunk))


def onehot_embed_bwd(x, dout, widths=WIDTHS, values=None) -> torch.Tensor:
    """K2b: the table's gradient, codes (R, 3*cells, S) uint8 and ``dout``
    (R, S, H) bf16 -> (cells, sum(widths), H) float32, on the card.

    CPU tensors take :func:`onehot_embed_bwd_plain`. CUDA tensors launch
    the two passes of ``csrc/embed_bwd.cu``: per (row tile, sample chunk)
    the one-hot product on the tensor cores, then the chunks' sum in order
    (deterministic: the same inputs give the same bits)."""
    if x.device.type == "cpu":
        return onehot_embed_bwd_plain(x, dout, widths, values)
    if x.device.type != "cuda" or dout.device != x.device:
        raise ValueError(f"onehot_embed_bwd: codes on {x.device}, dout on "
                         f"{dout.device}")
    _check_codes("onehot_embed_bwd", x)
    R, F, S = x.shape
    cells, cw, H = F // 3, sum(widths), dout.shape[-1]
    if (F % 3 or dout.dtype != torch.bfloat16 or not dout.is_contiguous()
            or tuple(dout.shape) != (R, S, H) or H % 2 or not 0 < H <= 2048):
        raise ValueError(
            f"onehot_embed_bwd: wants codes (R, 3*cells, S) and contiguous "
            f"bf16 dout (R, S, H) with even H <= 2048; got codes "
            f"{tuple(x.shape)}, dout {dout.dtype} {tuple(dout.shape)}")
    if cw > 250:
        raise ValueError(f"onehot_embed_bwd: {cw} table rows per cell; the "
                         f"kernel takes at most 250")
    plan = bwd_plan(R, S, cells, cw, H)
    lut = _slot_table_on(tuple(widths), values, x.device)
    partial = torch.empty((plan.n_chunks, cells, cw, H), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((cells, cw, H), dtype=torch.float32, device=x.device)
    fn = _build.function("embed_bwd", "onehot_embed_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dout.data_ptr(), lut.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), R, F, S, cells, widths[0],
            widths[1], cw, H, plan.bn, plan.span, plan.chunk, plan.n_chunks,
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"onehot_embed_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    onehot_embed_bwd.launches += 1
    return dw


class _OneHotEmbedFn(torch.autograd.Function):
    """The embed with its table's gradient: forward K2f / plain, backward
    K2b / plain, on the codes' device. ``dout`` is cast to the compute
    dtype (to bf16 for K2b, which reads the table as bf16 in the forward),
    the sums are float32, and the gradient comes back in the table's
    dtype. The integer codes get none."""

    @staticmethod
    def forward(ctx, x, w, widths, values, dtype):
        ctx.save_for_backward(x)
        ctx.spec = (widths, values, dtype, w.dtype)
        return _forward(x, w, widths, values, dtype)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        widths, values, dtype, w_dtype = ctx.spec
        if x.device.type == "cpu":
            dw = onehot_embed_bwd_plain(x, dout.to(dtype), widths, values)
        else:
            dw = onehot_embed_bwd(x, dout.to(torch.bfloat16).contiguous(),
                                  widths, values)
        return None, dw.to(w_dtype), None, None, None


def onehot_embed(x, w, widths=WIDTHS, values=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Fused one-hot embed: codes (R, 3*cells, S) x table (cells,
    sum(widths), H) -> (R, S, H).

    CPU tensors: the plain version, in ``dtype``. CUDA tensors: the K2f
    kernel (``csrc/embed_fwd.cu``: the one-hot product on the tensor cores,
    deterministic), which takes uint8 codes, reads the table as bf16 and
    returns bf16 (float32 sums, one rounding), like the TPU kernel.
    Differentiable in ``w``: with grad enabled and a table that needs a
    gradient, the call goes through an autograd Function whose backward is
    K2b on the card.
    """
    if torch.is_grad_enabled() and w.requires_grad:
        return _OneHotEmbedFn.apply(x, w, tuple(widths), values, dtype)
    return _forward(x, w, widths, values, dtype)


#: launches of the K2f kernel in this process (CUDA calls only)
onehot_embed.launches = 0
#: launches of the K2b kernel in this process (CUDA calls only)
onehot_embed_bwd.launches = 0
