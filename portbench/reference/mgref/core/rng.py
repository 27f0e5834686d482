"""The RNG protocol (SPEC §4) in PyTorch: threefry2x32, bit-equal to JAX.

Counterpart of ``marlgrid_tpu/core/rng.py``. The engine's randomness is
``jax.random`` under the threefry2x32 PRNG with
``jax_threefry_partitionable=True`` (the default of jax 0.9), so the port
carries its own threefry and rebuilds every sampler the engine and the
rollout use from the same bits: ``PRNGKey``, ``split``, ``fold_in``, random
bits, ``randint``, ``uniform``, ``permutation``, ``gumbel`` (low mode) and
``categorical``. Same key in, same numbers out.

A key is an int64 tensor ``(..., 2)`` holding two uint32 values; every
function takes a batch of keys and draws for each one (the JAX package
vmaps instead). torch has no CPU add, shift or compare for uint32, so all
arithmetic runs in int64 and is masked back to 32 bits, on both devices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: ``(2,)``."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"PRNGKey seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=resolve(device))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of count pairs (x0, x1) under key
    (k1, k2); all int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _counts(n: int, device):
    """(hi, lo) uint32 halves of the flat iota 0..n-1 (``iota_2x32_shape``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``(..., 2) -> (..., num, 2)``."""
    hi, lo = _counts(num, keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (int or int tensor broadcast against
    the key batch) hashed into each key."""
    data = data.long() & MASK32 if torch.is_tensor(data) else data & MASK32
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


#: (shape, part, device) -> the (hi, lo) counts of a part of a draw and the
#: part's shape: static, so made once per shape and not once per step
_PART_COUNTS = {}


def part_counts(shape, part, device):
    """``(hi, lo, part_shape)``: the flat indices of the elements of a draw
    of the global ``shape`` that lie in ``part = (axis, start, stop)``
    (``start <= i < stop`` along ``axis``), split into uint32 halves as
    ``_counts`` splits the whole iota, flattened; and that part's shape.
    In partitionable threefry element i of a draw is the hash of its flat
    index i alone, so the hash of these indices is the part of the global
    draw. Cached per (shape, part, device)."""
    shape = tuple(shape)
    axis, start, stop = part
    axis %= len(shape)
    if not 0 <= start <= stop <= shape[axis]:
        raise ValueError(f"part {part} outside the draw's shape {shape}")
    ck = (shape, (axis, start, stop), str(device))
    if ck not in _PART_COUNTS:
        idx = torch.arange(math.prod(shape), dtype=torch.int64,
                           device=device).reshape(shape)
        idx = idx.narrow(axis, start, stop - start).reshape(-1)
        sub = shape[:axis] + (stop - start,) + shape[axis + 1:]
        _PART_COUNTS[ck] = (idx >> 32, idx & MASK32, sub)
    return _PART_COUNTS[ck]


def random_bits(keys: torch.Tensor, shape, part=None) -> torch.Tensor:
    """32 random bits per element: ``(..., 2) -> (..., *shape)`` int64.
    ``part = (axis, start, stop)``: only the elements of the draw of
    ``shape`` at ``start <= i < stop`` along ``axis`` (a rank's columns of
    a global draw, :func:`part_counts`), bit-equal to that slice of the
    whole draw."""
    shape = tuple(shape)
    if part is None:
        hi, lo = _counts(math.prod(shape), keys.device)
    else:
        hi, lo, shape = part_counts(shape, part, keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(keys.shape[:-1] + shape)


def randint(keys: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` per key,
    for int bounds in the int32 range: ``(..., *shape)`` int32."""
    ks = split(keys)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((higher % span) * mult) & MASK32) + (lower % span)
    off = (off & MASK32) % span
    out = (minval + off) & MASK32
    # the int32 reading of the uint32 sum (two's complement)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, part=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key
    (``part``: a slice of it, as :func:`random_bits` takes)."""
    bits = random_bits(keys, shape, part)
    fbits = (bits >> 9) | 0x3F800000           # mantissa bits, exponent 0
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32, as JAX has them
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(keys: torch.Tensor, shape, part=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default low mode
    (``part``: a slice of it, as :func:`random_bits` takes)."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0, part)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` for one key ``(2,)``:
    the Gumbel-max over ``axis`` of float32 logits, int64 indices."""
    noise = gumbel(key, logits.shape)
    return torch.argmax(noise + logits, dim=axis)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` per key: ``(..., n)`` int64.

    JAX shuffles by ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort
    on fresh 32-bit keys (0 rounds for n = 1, 1 round for 2 <= n <= 8);
    ``torch.sort(stable=True)`` reproduces it, ties included.
    """
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        keys.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(keys)
        keys, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = x.gather(-1, order)
    return x


def reset_draws(keys, n_events: int, max_tries: int, x0, rw, y0, rh,
                width, height):
    """All draws of one reset (SPEC §4), for a batch of keys ``(B, 2)``.

    Returns ``(k_state (B, 2), xs (B, E, T), ys (B, E, T), dirs (B, E),
    split_x (B,), door_y (B,))`` — the JAX ``reset_draws`` per env.
    """
    ks = split(keys)
    k_events, k_state = ks[:, 0], ks[:, 1]
    xs = randint(fold_in(k_events, 0), (n_events, max_tries), x0, x0 + rw)
    ys = randint(fold_in(k_events, 1), (n_events, max_tries), y0, y0 + rh)
    dirs = randint(fold_in(k_events, 2), (n_events,), 0, 4)
    split_x = randint(fold_in(k_events, 3), (), 2, width - 2)
    door_y = randint(fold_in(k_events, 4), (), 1, height - 1)
    return k_state, xs, ys, dirs, split_x, door_y


def step_draws(keys, n_agents: int, max_tries: int, x0, rw, y0, rh,
               with_respawn: bool):
    """All draws of one step (SPEC §4), for a batch of keys ``(B, 2)``.

    Returns ``(next_key, perm (B, N))`` or, with respawn,
    ``(next_key, perm, rxs (B, N, T), rys (B, N, T), rdirs (B, N))``.
    """
    ks = split(keys)
    k_next, sub = ks[:, 0], ks[:, 1]
    perm = permutation(sub, n_agents)
    if not with_respawn:
        return k_next, perm
    rxs = randint(fold_in(sub, 0), (n_agents, max_tries), x0, x0 + rw)
    rys = randint(fold_in(sub, 1), (n_agents, max_tries), y0, y0 + rh)
    rdirs = randint(fold_in(sub, 2), (n_agents,), 0, 4)
    return k_next, perm, rxs, rys, rdirs


def autoreset_key(next_key):
    """Key feeding the fresh episode in ``step_autoreset`` (SPEC §9)."""
    return fold_in(next_key, 0xA110)
