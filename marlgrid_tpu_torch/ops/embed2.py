"""Plane-major fused one-hot embed, forward and weight gradient: kernels K5f
and K5b and their plain versions.

Counterpart of ``marlgrid_tpu/ops/embed2.py``: the same function as
``ops/embed.py`` (the encode-obs torso's first layer on feature-major codes
``(R, 3*cells, S)``), but over three natural per-plane tables ``(cells, n_p,
H)`` instead of one packed table, with a float32 output that is not rounded
to bf16. The tables are read as bf16 whatever their dtype, and the backward
reads ``dout`` as bf16, as the TPU kernels do. On CUDA tensors the wrappers
launch the hand-written kernels of ``csrc/embed2.cu`` (a gather-sum and a
deterministic two-pass scatter-add); on CPU tensors they take the plain
dense one-hot formulation. There is no fallback between them.

:func:`onehot_embed2` is differentiable in the three tables through an
autograd Function whose backward is K5b on the card and the plain backward
on the CPU (the codes get no gradient). ``models/actor_critic.py`` selects
this route with ``MARLGRID_TPU_EMBED_V2=1``, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .embed import N_STATE_CODES, WIDTHS, _bwd_plan, _check_codes, slot_table

_FWD_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 9 + (
    ctypes.c_void_p,)
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 9
                 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p))


def plane_slot_table(widths=WIDTHS, values=None) -> np.ndarray:
    """(3, 256) int16: the row, within plane p's (n_p, H) vocabulary, that
    code c of plane p selects, or -1 for none (``embed.slot_table`` without
    the packed table's plane offsets)."""
    lut = slot_table(widths, values)
    off = np.cumsum((0,) + tuple(widths[:-1]))[:, None]
    return np.where(lut >= 0, lut - off, -1).astype(np.int16)


@functools.lru_cache(maxsize=None)
def _plane_slot_table_on(widths, values, device) -> torch.Tensor:
    return torch.as_tensor(plane_slot_table(widths, values), device=device)


def _onehots(x, widths, values):
    """Per plane, the float32 one-hot (R, cells, n_p, S) of the codes."""
    R, F, S = x.shape
    o = x.long().reshape(R, 3, F // 3, S)
    for p, n in enumerate(widths):
        code = o[:, p]
        if values is None:
            if p == 2:
                code = code.clamp(0, N_STATE_CODES - 1)
            voc = torch.arange(n, device=x.device)
        else:
            voc = torch.as_tensor(values[p], device=x.device)
        yield (code[:, :, None, :] == voc[:, None]).float()


def onehot_embed2_plain(x, w0, w1, w2, widths=WIDTHS,
                        values=None) -> torch.Tensor:
    """The dense one-hot formulation: codes (R, 3*cells, S) and tables w_p
    (cells, n_p, H) -> (R, S, H) float32. The tables are rounded to bf16;
    per plane the one-hot is contracted with the plane's table over (cell,
    slot) in float32, and the three planes are summed in float32."""
    out = None
    for oh, w in zip(_onehots(x, widths, values), (w0, w1, w2)):
        y = torch.einsum("rcns,cnh->rsh", oh, w.to(torch.bfloat16).float())
        out = y if out is None else out + y
    return out


def onehot_embed2_bwd_plain(x, dout, widths=WIDTHS, values=None):
    """The tables' gradients of :func:`onehot_embed2_plain`: codes (R,
    3*cells, S) and ``dout`` (R, S, H) -> three (cells, n_p, H) float32
    tensors, each the plane's one-hot contracted with ``dout`` over (row,
    sample) in float32 (``dout`` is read as it comes: the caller rounds it
    to bf16 first)."""
    d = dout.float()
    return tuple(torch.einsum("rcns,rsh->cnh", oh, d)
                 for oh in _onehots(x, widths, values))


def _check_tables(name, x, ws, widths):
    cells = x.shape[1] // 3
    H = ws[0].shape[-1]
    for w, n in zip(ws, widths):
        if w.device != x.device or tuple(w.shape) != (cells, n, H):
            raise ValueError(
                f"{name}: wants three tables (cells={cells}, n_p, H) on "
                f"{x.device} with n_p = {tuple(widths)}; got "
                f"{[(tuple(t.shape), str(t.device)) for t in ws]}")
    if H % 2 or not 0 < H <= 2048:
        raise ValueError(f"{name}: wants an even H <= 2048; got H = {H}")
    return cells, H


def _forward(x, ws, widths, values) -> torch.Tensor:
    """The forward on x's device: the plain version on the CPU, K5f on the
    card."""
    if x.device.type == "cpu":
        return onehot_embed2_plain(x, *ws, widths, values)
    if x.device.type != "cuda":
        raise ValueError(f"onehot_embed2: codes on {x.device}")
    _check_codes("onehot_embed2", x)
    cells, H = _check_tables("onehot_embed2", x, ws, widths)
    R, F, S = x.shape
    if F % 3 or R > 65535:
        raise ValueError(f"onehot_embed2: wants codes (R <= 65535, 3*cells, "
                         f"S); got {tuple(x.shape)}")
    w0, w1, w2 = (w.to(torch.bfloat16).contiguous() for w in ws)
    lut = _plane_slot_table_on(tuple(widths), values, x.device)
    out = torch.empty((R, S, H), dtype=torch.float32, device=x.device)
    fn = _build.function("embed2", "onehot_embed2_fwd", _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            lut.data_ptr(), out.data_ptr(), R, F, S, cells, *widths, H,
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"onehot_embed2: kernel launch failed "
                           f"(cudaError {rc})")
    onehot_embed2.launches += 1
    return out


def onehot_embed2_bwd(x, dout, widths=WIDTHS, values=None):
    """K5b: the three tables' gradients, codes (R, 3*cells, S) uint8 and
    ``dout`` (R, S, H) bf16 -> three (cells, n_p, H) float32 tensors.

    CPU tensors take :func:`onehot_embed2_bwd_plain`. CUDA tensors launch
    the two-pass scatter-add of ``csrc/embed2.cu`` (deterministic: the same
    inputs give the same bits)."""
    if x.device.type == "cpu":
        return onehot_embed2_bwd_plain(x, dout, widths, values)
    if x.device.type != "cuda" or dout.device != x.device:
        raise ValueError(f"onehot_embed2_bwd: codes on {x.device}, dout on "
                         f"{dout.device}")
    _check_codes("onehot_embed2_bwd", x)
    R, F, S = x.shape
    cells, cw, H = F // 3, sum(widths), dout.shape[-1]
    if (F % 3 or dout.dtype != torch.bfloat16 or not dout.is_contiguous()
            or tuple(dout.shape) != (R, S, H) or H % 2 or not 0 < H <= 2048):
        raise ValueError(
            f"onehot_embed2_bwd: wants codes (R, 3*cells, S) and contiguous "
            f"bf16 dout (R, S, H) with even H <= 2048; got codes "
            f"{tuple(x.shape)}, dout {dout.dtype} {tuple(dout.shape)}")
    cb, chunk, n_chunks = _bwd_plan(R, S, cells, cw, H)
    lut = _plane_slot_table_on(tuple(widths), values, x.device)
    partial = torch.empty((n_chunks, cells, cw, H), dtype=torch.float32,
                          device=x.device)
    dws = [torch.empty((cells, n, H), dtype=torch.float32, device=x.device)
           for n in widths]
    fn = _build.function("embed2", "onehot_embed2_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dout.data_ptr(), lut.data_ptr(), partial.data_ptr(),
            *(d.data_ptr() for d in dws), R, F, S, cells, *widths, H, cb,
            chunk, n_chunks, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"onehot_embed2_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    onehot_embed2_bwd.launches += 1
    return tuple(dws)


class _OneHotEmbed2Fn(torch.autograd.Function):
    """The plane-major embed with its tables' gradients: forward K5f /
    plain, backward K5b / plain, on the codes' device. ``dout`` is rounded
    to bf16 on both (the TPU kernel's backward casts it so), the sums are
    float32, and each gradient comes back in its table's dtype. The integer
    codes get none."""

    @staticmethod
    def forward(ctx, x, w0, w1, w2, widths, values):
        ctx.save_for_backward(x)
        ctx.spec = (widths, values, (w0.dtype, w1.dtype, w2.dtype))
        return _forward(x, (w0, w1, w2), widths, values)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        widths, values, dtypes = ctx.spec
        dws = onehot_embed2_bwd(x, dout.to(torch.bfloat16).contiguous(),
                                widths, values)
        return (None,) + tuple(d.to(t) for d, t in zip(dws, dtypes)) + (
            None, None)


def onehot_embed2(x, w0, w1, w2, widths=WIDTHS, values=None) -> torch.Tensor:
    """Plane-major fused one-hot embed: codes (R, 3*cells, S) uint8 x three
    tables (cells, n_p, H) -> (R, S, H) float32.

    CPU tensors: the plain version. CUDA tensors: the K5f kernel, which
    reads the tables as bf16 and sums in float32. Differentiable in the
    tables: with grad enabled and a table that needs a gradient, the call
    goes through an autograd Function whose backward is K5b on the card.
    """
    if torch.is_grad_enabled() and any(w.requires_grad for w in (w0, w1, w2)):
        return _OneHotEmbed2Fn.apply(x, w0, w1, w2, tuple(widths), values)
    return _forward(x, (w0, w1, w2), widths, values)


#: launches of the K5f kernel in this process (CUDA calls only)
onehot_embed2.launches = 0
#: launches of the K5b kernel in this process (CUDA calls only)
onehot_embed2_bwd.launches = 0
