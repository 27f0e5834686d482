"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card it raises instead of carrying on silently on the CPU; the CPU runs only
when the caller asks for it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "marlgrid_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def _frozen(v):
    """Nested lists/tuples/arrays as nested tuples (hashable)."""
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    return v


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype, device) -> torch.Tensor:
    """A small constant table on ``device``, copied there once and cached:
    a copy from host memory in a hot loop would stall the host on every
    call. The result is shared; never write to it."""
    return _const(_frozen(values), dtype, torch.device(device))
