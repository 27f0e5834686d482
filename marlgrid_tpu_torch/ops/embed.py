"""Fused one-hot embed, forward and weight gradient: kernels K2f and K2b and
their plain versions.

Counterpart of ``marlgrid_tpu/ops/embed.py``: the encode-obs torso's first
layer, ``out[r, s, :] = sum over view cells of W_type[code] + W_color[code]
+ W_state[min(code, 19)]``, on feature-major codes ``(R, 3*cells, S)``, and
its gradient with respect to the table. On CUDA tensors the wrappers launch
the hand-written kernels: the gather-sum of ``csrc/embed.cu`` (float32 sums,
one rounding to bf16, as the TPU kernel) and the one-hot product of
``csrc/embed_bwd.cu`` on the tensor cores (bf16 ``dout``, float32 sums). On
CPU tensors they take the plain dense one-hot formulation. There is no
fallback between them.

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
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
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
    if cw != sum(widths) or H % 2 or H > 2048 or R > 65535:
        raise ValueError(
            f"onehot_embed: wants R <= 65535 and a (cells, {sum(widths)}, H) "
            f"table with even H <= 2048; got codes {tuple(x.shape)}, table "
            f"{tuple(w.shape)}")
    w = w.to(torch.bfloat16).contiguous()
    lut = _slot_table_on(tuple(widths), values, x.device)
    out = torch.empty((R, S, H), dtype=torch.bfloat16, device=x.device)
    fn = _build.function("embed", "onehot_embed_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), lut.data_ptr(), out.data_ptr(),
            R, F, S, cells, cw, H, x.device.index, stream)
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
    kernel, which takes uint8 codes, reads the table as bf16 and returns
    bf16 (float32 sums, one rounding), like the TPU kernel. Differentiable
    in ``w``: with grad enabled and a table that needs a gradient, the call
    goes through an autograd Function whose backward is K2b on the card.
    """
    if torch.is_grad_enabled() and w.requires_grad:
        return _OneHotEmbedFn.apply(x, w, tuple(widths), values, dtype)
    return _forward(x, w, widths, values, dtype)


#: launches of the K2f kernel in this process (CUDA calls only)
onehot_embed.launches = 0
#: launches of the K2b kernel in this process (CUDA calls only)
onehot_embed_bwd.launches = 0
