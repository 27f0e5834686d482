"""The threefry2x32 wrapper (``ops/threefry.py``): each caller's operands
mapped onto the kernel's form (key rows read through strides, counts from
the iota, a table or a datum per key, the pair or the xor written), that
form evaluated with the plain hash as the kernel evaluates it, element by
element, against what the callers computed before the kernel (the plain
hash on their operands, broadcast); and the CPU route, which takes the
plain version and launches nothing. ``test_torch_rng.py`` holds the same
samplers bit-equal to ``jax.random``."""
import math

import pytest
import torch

from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.ops import kernel_wrappers, threefry
from marlgrid_tpu_torch.ops.threefry import MASK32, threefry2x32_plain


def _keys(*batch, seed=0):
    """Keys ``(*batch, 2)`` of uint32 values."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, batch + (2,), generator=g,
                         dtype=torch.int64)


# the callers as they hashed before the kernel: the plain hash on their
# own operands, broadcast
def split_before(keys, num):
    idx = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32_plain(keys[..., 0:1], keys[..., 1:2], idx >> 32,
                                idx & MASK32)
    return torch.stack([b1, b2], dim=-1)


def fold_in_before(keys, data):
    data = data.long() & MASK32 if torch.is_tensor(data) else data & MASK32
    b1, b2 = threefry2x32_plain(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def bits_before(keys, shape, part=None):
    shape = tuple(shape)
    if part is None:
        idx = torch.arange(math.prod(shape), dtype=torch.int64)
        hi, lo = idx >> 32, idx & MASK32
    else:
        hi, lo, shape = rng.part_counts(shape, part, keys.device)
    b1, b2 = threefry2x32_plain(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(keys.shape[:-1] + shape)


def _split_view(which):
    """A key batch that is a strided view: keys of a split (the callers'
    ``ks[:, 0]`` and ``ks[..., 1, :]``), or keys stored word-major."""
    ks = rng.split(_keys(6, seed=3), 3)
    if which == "first":
        return ks[:, 0]
    if which == "second":
        return ks[..., 1, :]
    g = torch.Generator().manual_seed(4)
    return torch.randint(0, 2 ** 32, (2, 6), generator=g,
                         dtype=torch.int64).t()


#: case -> (keys, the caller's arguments after the keys, which caller)
CASES = {
    "fold_in int, one key": lambda: (
        _keys(), (0xA110,), "fold_in"),
    "fold_in int, B keys": lambda: (_keys(5), (2 ** 31 + 5,), "fold_in"),
    "fold_in negative int": lambda: (_keys(5), (-1,), "fold_in"),
    "fold_in per-key int64": lambda: (
        _keys(6), (torch.arange(6) + 7,), "fold_in"),
    "fold_in per-key int32": lambda: (
        _keys(6), (torch.arange(6, dtype=torch.int32) - 3,), "fold_in"),
    "fold_in one key, tensor": lambda: (
        _keys(), (torch.arange(9) * 1000,), "fold_in"),
    "fold_in broadcast batch": lambda: (
        _keys(3, 1), (torch.arange(4),), "fold_in"),
    "fold_in 0-d tensor": lambda: (
        _keys(5), (torch.tensor(11),), "fold_in"),
    "fold_in strided keys": lambda: (
        _split_view("first"), (torch.arange(6),), "fold_in"),
    "split one key into 2": lambda: (_keys(), (2,), "split"),
    "split one key into n_envs": lambda: (_keys(), (16,), "split"),
    "split B keys into 2": lambda: (_keys(7), (2,), "split"),
    "split a (2, 3) batch into 3": lambda: (_keys(2, 3), (3,), "split"),
    "split strided keys": lambda: (_split_view("second"), (2,), "split"),
    "split word-major keys": lambda: (_split_view("t"), (2,), "split"),
    "bits one key, iota": lambda: (_keys(), ((4, 9, 7),), "bits"),
    "bits B keys, iota": lambda: (_keys(5), ((4,),), "bits"),
    "bits B keys, scalar": lambda: (_keys(5), ((),), "bits"),
    "bits strided keys": lambda: (_split_view("first"), ((3,),), "bits"),
    "bits one key, part (env axis 1)": lambda: (
        _keys(), ((4, 64, 7), (1, 16, 32)), "bits"),
    "bits one key, part (env axis 0)": lambda: (
        _keys(), ((64, 4, 7), (0, 48, 64)), "bits"),
    "bits B keys, part": lambda: (_keys(3), ((8, 5), (0, 2, 6)), "bits"),
}


def _draw(keys, args, kind):
    if kind == "fold_in":
        return threefry.fold_in_draw(keys, *args)
    if kind == "split":
        return threefry.split_draw(keys, *args)
    shape, part = args[0], (args[1] if len(args) > 1 else None)
    if part is None:
        return threefry.bits_draw(keys, math.prod(shape), shape)
    hi, lo, sub = rng.part_counts(shape, part, keys.device)
    return threefry.bits_draw(keys, (hi, lo), sub)


def _before(keys, args, kind):
    return {"fold_in": fold_in_before, "split": split_before,
            "bits": bits_before}[kind](keys, *args)


def _public(keys, args, kind):
    if kind == "bits":
        return rng.random_bits(keys, *args)
    return getattr(rng, kind)(keys, *args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_draw_is_the_callers_hash(case):
    """The kernel's form of each caller shape, evaluated with the plain
    hash element by element, is what the caller computed before the kernel;
    the public sampler on the CPU returns the same and launches nothing."""
    keys, args, kind = CASES[case]()
    want = _before(keys, args, kind)
    draw = _draw(keys, args, kind)
    assert draw.rows.shape[0] * draw.counts * (1 if draw.xor else 2) == \
        want.numel()
    got = threefry.threefry2x32_draw_plain(draw)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    n0 = threefry.threefry2x32.launches
    assert torch.equal(_public(keys, args, kind), want)
    assert threefry.threefry2x32.launches == n0


@pytest.mark.parametrize("which", ["first", "second", "t"])
def test_strided_keys_are_read_in_place(which):
    """A sliced or word-major key batch is read through its strides: the
    draw's key rows are a view of the caller's keys, no copy."""
    keys = _split_view(which)
    assert not keys.is_contiguous()
    rows = threefry.split_draw(keys, 2).rows
    assert rows.data_ptr() == keys.data_ptr()
    assert rows.stride() == (keys.stride(0), keys.stride(-1))
    one = threefry.fold_in_draw(_keys(), torch.arange(5)).rows
    assert one.shape == (5, 2) and one.stride(0) == 0


def test_flat_index_past_2_32():
    """Elements whose flat index passes 2**32: the iota's high word (x0 =
    e >> 32) enters the hash, and an element of key k of a draw of more
    than 2**32 elements is count e - k * M of that key."""
    key = _keys(1, seed=9)
    n = 2 ** 32 + 8
    e = torch.tensor([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7])
    got = threefry.threefry2x32_draw_plain(
        threefry.bits_draw(key, n, (n,)), e)
    b1, b2 = threefry2x32_plain(key[:, 0], key[:, 1], e >> 32, e & MASK32)
    assert torch.equal(got, b1 ^ b2)
    lo_only = threefry2x32_plain(key[:, 0], key[:, 1], 0, e & MASK32)
    assert not torch.equal(got[3:], (lo_only[0] ^ lo_only[1])[3:])
    pair = threefry.threefry2x32_draw_plain(threefry.split_draw(key, n), e)
    assert torch.equal(pair, torch.stack([b1, b2], dim=-1))
    keys = _keys(3, seed=10)
    M = 2 ** 31 + 3
    e = torch.tensor([M - 1, M, 2 * M + 5, 3 * M - 1])
    k, j = torch.tensor([0, 1, 2, 2]), torch.tensor([M - 1, 0, 5, M - 1])
    got = threefry.threefry2x32_draw_plain(
        threefry.bits_draw(keys, M, (M,)), e)
    b1, b2 = threefry2x32_plain(keys[k, 0], keys[k, 1], j >> 32, j & MASK32)
    assert torch.equal(got, b1 ^ b2)


def test_wrapper_routes_and_refuses():
    """Registered as ``threefry2x32`` beside the other kernels; a CPU draw
    takes the plain version and counts no launch; keys that are not int64
    pairs, and a device that is neither the CPU nor a card, raise (no
    fallback)."""
    assert kernel_wrappers()["threefry2x32"] is threefry.threefry2x32
    n0 = threefry.threefry2x32.launches
    out = threefry.threefry2x32(threefry.split_draw(_keys(4), 2))
    assert out.shape == (4, 2, 2) and threefry.threefry2x32.launches == n0
    with pytest.raises(ValueError):
        threefry.split_draw(_keys(4).int(), 2)
    with pytest.raises(ValueError):
        threefry.split_draw(torch.zeros(4, 3, dtype=torch.int64), 2)
    meta = threefry.split_draw(torch.empty(4, 2, dtype=torch.int64,
                                           device="meta"), 2)
    with pytest.raises(ValueError):
        threefry.threefry2x32(meta)
    empty = threefry.threefry2x32(threefry.bits_draw(_keys(3), 0, (0,)))
    assert empty.shape == (3, 0)
