"""The Threefry-2x32 hash of the RNG (``core/rng.py``): its kernel and its
plain version.

No TPU kernel has this counterpart: the JAX package's hash is
``jax.random``'s threefry2x32, which XLA fuses into one elementwise op. The
plain version, :func:`threefry2x32_plain`, emulates the uint32 arithmetic
in int64 (torch has no CPU add, shift or compare for uint32), one masked
elementwise op for every add, shift, or, and and xor: about 171 launches a
draw on the card. On a CUDA tensor :func:`threefry2x32` hashes a whole
draw in one launch of the kernel in ``csrc/threefry.cu``; on a CPU tensor
it evaluates the same draw with the plain version. There is no fallback:
a CUDA draw the kernel cannot take raises.

A draw (:class:`Draw`) is the kernel's form of what a caller asks: K key
rows read through their strides, M counts per key from one of three
sources, and one of two output layouts. Element e of the draw is count
``j = e % M`` of key ``k = e // M``:

- ``IOTA``: the count pair ``(j >> 32, j & MASK32)``, the flat index of the
  draw (``split`` into M, ``random_bits`` of M elements);
- ``TABLE``: ``(hi[j], lo[j])``, the flat indices of a part of a larger
  draw (``random_bits`` with ``part``: ``rng.part_counts``);
- ``FOLD``: ``(0, data[k])`` with M = 1, a datum per key or one int for
  every key (``fold_in``).

The output is the pair of hashed words (``xor`` false: keys ``(..., 2)``)
or their xor (random bits), int64 tensors holding uint32 values.
:func:`split_draw`, :func:`fold_in_draw` and :func:`bits_draw` map the
three callers' operands onto that form.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
IOTA, TABLE, FOLD = 0, 1, 2

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def threefry2x32_plain(k1, k2, x0, x1):
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


class Draw(NamedTuple):
    """One hash call in the kernel's form (see the module docstring)."""
    #: (K, 2) int64 key rows, a view of the caller's keys where one exists
    rows: torch.Tensor
    #: M, the counts per key (1 for FOLD)
    counts: int
    #: IOTA, TABLE or FOLD
    source: int
    #: TABLE: the (M,) int64 halves of the counts
    hi: Optional[torch.Tensor]
    lo: Optional[torch.Tensor]
    #: FOLD: the (K,) int32 or int64 datum of each key, or None for ``value``
    data: Optional[torch.Tensor]
    value: int
    #: the output: the xor of the two words, or the pair
    xor: bool
    #: the caller's output shape, K * M elements (times 2 for the pair)
    shape: tuple


def _rows(keys: torch.Tensor) -> torch.Tensor:
    """The (K, 2) rows of a key batch (..., 2): a view where the batch's
    strides allow one (a slice ``ks[:, 0]``, a broadcast key), else a
    copy."""
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"threefry2x32: wants int64 keys (..., 2), got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    return keys.reshape(-1, 2)


def split_draw(keys: torch.Tensor, num: int) -> Draw:
    """``rng.split``: each key hashed with the counts 0 .. num-1, the pairs
    as ``(..., num, 2)``."""
    return Draw(_rows(keys), num, IOTA, None, None, None, 0, False,
                tuple(keys.shape[:-1]) + (num, 2))


def fold_in_draw(keys: torch.Tensor, data) -> Draw:
    """``rng.fold_in``: ``data`` (an int, or an integer tensor broadcast
    against the key batch) hashed into each key, the pairs as ``(..., 2)``
    of the broadcast batch."""
    if not torch.is_tensor(data):
        return Draw(_rows(keys), 1, FOLD, None, None, None,
                    int(data) & MASK32, False, tuple(keys.shape))
    batch = torch.broadcast_shapes(keys.shape[:-1], data.shape)
    if data.dtype not in (torch.int32, torch.int64):
        data = data.long()
    return Draw(_rows(keys.expand(batch + (2,))), 1, FOLD, None, None,
                data.expand(batch).reshape(-1), 0, False, batch + (2,))


def bits_draw(keys: torch.Tensor, counts, shape) -> Draw:
    """``rng.random_bits``: each key hashed with ``counts`` (an int M, the
    iota 0 .. M-1, or the ``(hi, lo)`` tables of ``rng.part_counts``), the
    xor of each pair as ``(..., *shape)``."""
    shape = tuple(keys.shape[:-1]) + tuple(shape)
    if isinstance(counts, int):
        return Draw(_rows(keys), counts, IOTA, None, None, None, 0, True,
                    shape)
    hi, lo = counts
    return Draw(_rows(keys), hi.numel(), TABLE, hi, lo, None, 0, True, shape)


def threefry2x32_draw_plain(draw: Draw, elements=None) -> torch.Tensor:
    """The kernel's arithmetic with the plain hash: each element e (all of
    the draw in its output shape, or the int64 tensor ``elements`` of flat
    indices, each a value or a pair) as the kernel computes it, from key
    row ``e // M`` and count ``e % M``."""
    M = draw.counts
    e = (torch.arange(draw.rows.shape[0] * M, device=draw.rows.device)
         if elements is None else elements)
    k = e // max(M, 1)
    j = e - k * M
    k1, k2 = draw.rows[k, 0], draw.rows[k, 1]
    if draw.source == IOTA:
        x0, x1 = j >> 32, j & MASK32
    elif draw.source == TABLE:
        x0, x1 = draw.hi[j], draw.lo[j]
    else:
        x0 = 0
        x1 = (draw.value if draw.data is None
              else draw.data[k].long() & MASK32)
    b1, b2 = threefry2x32_plain(k1, k2, x0, x1)
    out = b1 ^ b2 if draw.xor else torch.stack([b1, b2], dim=-1)
    return out if elements is not None else out.reshape(draw.shape)


def threefry2x32(draw: Draw) -> torch.Tensor:
    """The hash of a whole draw, int64 holding uint32 values, in the
    draw's output shape: one kernel launch on the card (none for an empty
    draw), the plain version on the CPU."""
    rows = draw.rows
    if rows.device.type == "cpu":
        return threefry2x32_draw_plain(draw)
    if rows.device.type != "cuda":
        raise ValueError(f"threefry2x32: unsupported device {rows.device}")
    operands = [t for t in (draw.hi, draw.lo, draw.data) if t is not None]
    if any(t.device != rows.device for t in operands):
        raise ValueError(f"threefry2x32: keys on {rows.device}, counts or "
                         f"data on {[str(t.device) for t in operands]}")
    if draw.source == TABLE and not (
            draw.hi.dtype == draw.lo.dtype == torch.int64
            and draw.hi.is_contiguous() and draw.lo.is_contiguous()
            and draw.hi.shape == draw.lo.shape == (draw.counts,)):
        raise ValueError("threefry2x32: wants contiguous (M,) int64 count "
                         "tables")
    out = torch.empty(draw.shape, dtype=torch.int64, device=rows.device)
    if out.numel() == 0:
        return out
    data = draw.data
    fn = _build.function("threefry", "threefry2x32", _ARGTYPES)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = fn(rows.data_ptr(), rows.stride(0), rows.stride(1), rows.shape[0],
            draw.counts, draw.source,
            None if draw.hi is None else draw.hi.data_ptr(),
            None if draw.lo is None else draw.lo.data_ptr(),
            None if data is None else data.data_ptr(),
            0 if data is None else data.stride(0),
            0 if data is None else data.element_size(), draw.value,
            int(draw.xor), out.data_ptr(), rows.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"threefry2x32: kernel launch failed "
                           f"(cudaError {rc})")
    threefry2x32.launches += 1
    return out


#: launches of the threefry2x32 kernel in this process (CUDA calls only)
threefry2x32.launches = 0

