"""The inputs a run makes from ``--seed`` and hands to both the program and
the reference: the run's key and the policy's weights. Both are made on the
run's device; the same seed gives the same inputs."""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def make_key(seed: int, device) -> torch.Tensor:
    """The run's threefry key ``(2,)`` (uint32 values in int64), the two
    32-bit halves of ``seed``: the key ``jax.random.PRNGKey`` makes of a
    64-bit seed, and the port's ``rng.PRNGKey(seed)`` for seeds below
    2**32."""
    if seed < 0:
        raise ValueError(f"--seed {seed}: a whole number >= 0")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fan_in(name: str, shape) -> int:
    """The fan-in a leaf's scale divides by: the flattened table rows for
    the encode embed's tables (``torso0.w*``, stored (cells * n, H) as flax
    stores them), else everything but the output dim (a Linear's (out, in),
    a conv's (out, in, kh, kw))."""
    if name.startswith("torso0.w"):
        return shape[0]
    return math.prod(shape[1:])


def make_weights(named_shapes, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``named_shapes`` (``(name, shape)``
    in the net's parameter order): one normal draw from a generator on
    ``device`` seeded with ``seed``, cut into the leaves, each matrix or
    kernel scaled to variance 1 / fan-in (flax's lecun scale) and each
    vector (a bias) zero, as flax initializes them."""
    named_shapes = list(named_shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in named_shapes)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        if len(shape) >= 2:
            out[name] = (flat[off:off + n].view(shape)
                         * (1.0 / math.sqrt(fan_in(name, shape))))
        else:
            out[name] = torch.zeros(shape, device=device)
        off += n
    return out
