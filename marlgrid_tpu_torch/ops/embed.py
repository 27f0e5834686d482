"""Fused one-hot embed forward: kernel K2f and its plain version.

Counterpart of the forward half of ``marlgrid_tpu/ops/embed.py``: the
encode-obs torso's first layer, ``out[r, s, :] = sum over view cells of
W_type[code] + W_color[code] + W_state[min(code, 19)]``, on feature-major
codes ``(R, 3*cells, S)``. On a CUDA tensor the wrapper launches the
hand-written gather-sum kernel in ``csrc/embed.cu`` (float32 sums, one
rounding to bf16, as the TPU kernel); on a CPU tensor it takes the plain
dense one-hot formulation. There is no fallback between them.

The weight-gradient kernel is not ported yet: on the card, a call that
would need a gradient for the table raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from . import _build

N_STATE_CODES = 20                      # door states + bonus phases
WIDTHS = (C.N_TYPES + 1, C.N_COLORS + 1, N_STATE_CODES)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


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


def onehot_embed(x, w, widths=WIDTHS, values=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Fused one-hot embed: codes (R, 3*cells, S) x table (cells,
    sum(widths), H) -> (R, S, H).

    CPU tensors: the plain version, in ``dtype``. CUDA tensors: the K2f
    kernel, which takes uint8 codes, reads the table as bf16 and returns
    bf16 (float32 sums, one rounding), like the TPU kernel.
    """
    if x.device.type == "cpu":
        return onehot_embed_plain(x, w, widths, values, dtype)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"onehot_embed: codes on {x.device}, table on "
                         f"{w.device}")
    if torch.is_grad_enabled() and w.requires_grad:
        raise NotImplementedError(
            "onehot_embed: backward kernel not yet ported (ROADMAP: the PPO "
            "update slice); call the forward under torch.no_grad()")
    R, F, S = x.shape
    cells, cw, H = w.shape
    if (x.dtype != torch.uint8 or not x.is_contiguous() or F != 3 * cells
            or cw != sum(widths) or H % 2 or H > 2048 or R > 65535):
        raise ValueError(
            f"onehot_embed: wants contiguous uint8 codes (R, 3*cells, S) "
            f"with R <= 65535 and a (cells, {sum(widths)}, H) table with "
            f"even H <= 2048; got codes {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}, table {tuple(w.shape)}")
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


#: launches of the K2f kernel in this process (CUDA calls only)
onehot_embed.launches = 0
