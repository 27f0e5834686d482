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
vmaps instead). The hash itself is ``ops/threefry.py``: every sampler goes
through :func:`split`, :func:`fold_in` or :func:`random_bits`, and each of
those is one call of its wrapper, one kernel launch on the card. torch has
no CPU add, shift or compare for uint32, so the arithmetic around the hash
runs in int64 and is masked back to 32 bits, on both devices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from ..ops import threefry
from ..ops.threefry import MASK32

_F32_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: ``(2,)``."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"PRNGKey seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=resolve(device))


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``(..., 2) -> (..., num, 2)``."""
    return threefry.threefry2x32(threefry.split_draw(keys, num))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (int or int tensor broadcast against
    the key batch) hashed into each key."""
    return threefry.threefry2x32(threefry.fold_in_draw(keys, data))


#: (shape, part, device) -> the (hi, lo) counts of a part of a draw and the
#: part's shape: static, so made once per shape and not once per step
_PART_COUNTS = {}


def part_counts(shape, part, device):
    """``(hi, lo, part_shape)``: the flat indices of the elements of a draw
    of the global ``shape`` that lie in ``part = (axis, start, stop)``
    (``start <= i < stop`` along ``axis``), split into uint32 halves as
    a draw's iota is split, flattened; and that part's shape.
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
        counts = math.prod(shape)
    else:
        hi, lo, shape = part_counts(shape, part, keys.device)
        counts = (hi, lo)
    return threefry.threefry2x32(threefry.bits_draw(keys, counts, shape))


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


def categorical_slice(key: torch.Tensor, local_logits: torch.Tensor,
                      global_size: int, offset: int,
                      env_axis: int) -> torch.Tensor:
    """Rows ``offset .. offset + B`` along ``env_axis`` of
    ``categorical(key, global_logits)`` (the draw over the last axis), from
    this rank's ``local_logits``, whose ``env_axis`` holds those B rows of
    a global axis of ``global_size``: the Gumbel noise of the global draw
    at this rank's flat indices (strided for feature-major (N, B, A)
    logits, ``env_axis=1``; one contiguous range for (B, N, A),
    ``env_axis=0``), bit-equal to the slice of the global draw."""
    shape = list(local_logits.shape)
    B = shape[env_axis]
    shape[env_axis] = global_size
    noise = gumbel(key, shape, (env_axis, offset, offset + B))
    return torch.argmax(noise + local_logits, dim=-1)


def categorical_per_key(keys: torch.Tensor, logits: torch.Tensor,
                        key_axis: int = 0) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical, in_axes=(0, key_axis),
    out_axes=key_axis)(keys, logits)``: the batch of keys ``(K, 2)`` maps
    over the logits' axis ``key_axis`` (of size K), each key drawing Gumbel
    noise of the shape of its slice, and the draw is over the last axis.
    ``key_axis=1`` for feature-major (N, B, A) logits -> (N, B); 0 for
    (B, N, A) -> (B, N)."""
    lg = logits.movedim(key_axis, 0)
    noise = gumbel(keys, lg.shape[1:])
    return torch.argmax(noise + lg, dim=-1).movedim(0, key_axis)


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
