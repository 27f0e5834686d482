"""The embed-roofline probe: K2f's forward split into its index half and its
sum half (kernel K6) and its plain versions.

Counterpart of ``scripts/embed_roofline.py::_fwd_variant`` on the port's
table layout: codes (R, 3*cells, S) uint8, table (cells, sum(widths), H)
(read as bf16), output (R, S, H) float32. ``mode`` picks the function:

- ``'full'``: ``out[r, s, :]`` = the sum over cells and planes of the table
  row each code selects, in float32 (K2f's function with a float32 store);
- ``'build'``: ``out[r, s, h]`` = the number of (cell, plane) pairs whose
  code selects a row under ``ops/embed.py::slot_table``, for every h (the
  row-sum of the one-hot);
- ``'gemm'``: ``out[r, s, h]`` = ``float(x[r, 0, s])`` times the sum over
  cells and slots of ``W[cell, slot, h]`` (a dense product against a
  broadcast of the first code row).

On CUDA tensors :func:`fwd_variant` launches the ``Mode`` variants of K2f's
own tensor-core kernel (``csrc/embed_fwd.cu``, under K2f's plan, grid and
walk): 'full' is K2f with a float32 store, 'build' its builder warps alone
(the row masks, counted), 'gemm' its mma warps alone (the staged table
times the broadcast code row), so the three times split K2f's. On CPU
tensors it takes :func:`fwd_variant_plain`. The port's model never calls
either.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import _build
from ..ops import embed as E

MODES = ("full", "build", "gemm")
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10
             + (ctypes.c_void_p,))


def fwd_variant_plain(x, w, widths=E.WIDTHS, values=None,
                      mode="full") -> torch.Tensor:
    """The probe's function in plain PyTorch, float32 (see the module)."""
    R, F, S = x.shape
    cells = F // 3
    wf = w.to(torch.bfloat16).float()
    if mode == "full":
        return E.onehot_embed_plain(x, wf, widths, values, torch.float32)
    if mode == "build":
        lut = E._slot_table_on(tuple(widths), values, x.device).long()
        plane = torch.arange(F, device=x.device) // cells
        hits = (lut[plane[None, :, None], x.long()] >= 0).sum(1)   # (R, S)
        return hits.float()[..., None].expand(R, S, w.shape[-1]).contiguous()
    if mode == "gemm":
        return x[:, 0, :].float()[..., None] * wf.sum((0, 1))
    raise ValueError(f"fwd_variant: mode {mode!r} not in {MODES}")


def fwd_variant(x, w, widths=E.WIDTHS, values=None,
                mode="full") -> torch.Tensor:
    """K6: the probe variant ``mode`` of K2f, codes (R, 3*cells, S) uint8 x
    table (cells, sum(widths), H) -> (R, S, H) float32. CPU tensors take
    :func:`fwd_variant_plain`; CUDA tensors launch the kernel."""
    if mode not in MODES:
        raise ValueError(f"fwd_variant: mode {mode!r} not in {MODES}")
    if x.device.type == "cpu":
        return fwd_variant_plain(x, w, widths, values, mode)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"fwd_variant: codes on {x.device}, table on "
                         f"{w.device}")
    cells, cw, H = w.shape
    E._check_codes("fwd_variant", x, 3 * cells)
    R, F, S = x.shape
    if cw != sum(widths) or H % 2 or not 0 < H <= 2048 or R > 65535:
        raise ValueError(
            f"fwd_variant: wants R <= 65535 and a (cells, {sum(widths)}, H) "
            f"table with even H <= 2048; got codes {tuple(x.shape)}, table "
            f"{tuple(w.shape)}")
    plan = E.fwd_plan(R, S, F, cells * cw, H)
    w = E._aligned(w.to(torch.bfloat16))
    lut = E._slot_table_on(tuple(widths), values, x.device)
    walk = E._fwd_walk_on(cells, tuple(widths), False, x.device)
    out = torch.empty((R, S, H), dtype=torch.float32, device=x.device)
    fn = _build.function("embed_fwd", "embed_variant_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), lut.data_ptr(), walk.data_ptr(),
            out.data_ptr(), R, F, S, cells, cw, H, plan.bn, plan.blocks,
            MODES.index(mode), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fwd_variant ({mode}): kernel launch failed "
                           f"(cudaError {rc})")
    fwd_variant.launches += 1
    return out


#: launches of the K6 kernel in this process, all modes (CUDA calls only)
fwd_variant.launches = 0
