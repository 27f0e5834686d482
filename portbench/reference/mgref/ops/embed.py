"""The one-hot embed's plain versions (frozen from the port's
``ops/embed.py``): the reference computes the embed as the dense one-hot
product, summed in float32 and rounded once to its dtype, on whatever
device it runs, with no kernel."""
from __future__ import annotations

import torch

from ..core import constants as C

N_STATE_CODES = 20                      # door states + bonus phases
WIDTHS = (C.N_TYPES + 1, C.N_COLORS + 1, N_STATE_CODES)


def vocab(palettes=None):
    """(widths, values) of the embed's per-plane vocabularies: the full
    static ones (values None) or a compact palette from
    ``core/obs.py::encode_palettes``."""
    if palettes is None:
        return WIDTHS, None
    values = tuple(tuple(int(x) for x in v) for v in palettes)
    return tuple(len(v) for v in values), values


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


def onehot_embed_once(x, w, widths=WIDTHS, values=None,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """The embed as the port's kernel (K2f) and the JAX package's TPU kernel
    define it: the table read in ``dtype``, every plane's one-hot product
    summed in float32, and the sum rounded to ``dtype`` once.
    (:func:`onehot_embed_plain` rounds each plane's product to ``dtype`` and
    adds them in ``dtype``.)"""
    out = onehot_embed_plain(x, w.to(dtype).float(), widths, values,
                             torch.float32)
    return out.to(dtype)


class _OneHotEmbedFn(torch.autograd.Function):
    """The embed (one rounding) with its table's gradient (the plain
    backward: ``dout`` in ``dtype``, float32 sums)."""

    @staticmethod
    def forward(ctx, x, w, widths, values, dtype):
        ctx.save_for_backward(x)
        ctx.spec = (widths, values, dtype, w.dtype)
        return onehot_embed_once(x, w, widths, values, dtype)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        widths, values, dtype, w_dtype = ctx.spec
        dw = onehot_embed_bwd_plain(x, dout.to(dtype), widths, values)
        return None, dw.to(w_dtype), None, None, None


def onehot_embed(x, w, widths=WIDTHS, values=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """codes (R, 3*cells, S) x table (cells, sum(widths), H) -> (R, S, H)
    in ``dtype`` (:func:`onehot_embed_once`), differentiable in ``w``."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _OneHotEmbedFn.apply(x, w, tuple(widths), values, dtype)
    return onehot_embed_once(x, w, widths, values, dtype)
