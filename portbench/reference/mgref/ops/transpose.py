"""The batch-major -> batch-minor transpose, plain (frozen from the port's
``ops/transpose.py``)."""
from __future__ import annotations

import torch


def transpose_bk(x: torch.Tensor) -> torch.Tensor:
    """(B, K) -> (K, B), contiguous."""
    return x.t().contiguous()
