"""The embed-roofline probe's plain versions
(``marlgrid_tpu_torch/probes/embed_roofline.py::fwd_variant_plain``, kernel
K6's reference) against the TPU probe ``scripts/embed_roofline.py``: its
kernel body ``_variant_kernel`` run through ``pl.pallas_call`` in interpret
mode, as ``_fwd_variant`` calls it, in each of the three modes, with the
goal_cycle palette and the full vocabulary, at 49 and 25 view cells. The
script is imported as it is, from its file.

On the card K6 runs K2f's tensor-core kernel (``csrc/embed_fwd.cu``) in
its 'build' and 'gemm' halves; what each half computes is emulated here
in numpy from the tables the wrapper passes (``fwd_walk``, ``row_bases``,
``slot_table``) and held against the plain versions and the TPU probe."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.ops import embed as JE
from marlgrid_tpu_torch.ops import embed as E
from marlgrid_tpu_torch.probes import embed_roofline as P

ROOT = Path(__file__).resolve().parent.parent
PALETTES = jobs.encode_palettes(JEnvParams(
    width=13, height=13, n_agents=4, scenario="goal_cycle",
    agent_colors=(0, 4, 5, 1), observation_style="encode"))


def _script():
    spec = importlib.util.spec_from_file_location(
        "embed_roofline_script", ROOT / "scripts" / "embed_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()


def _pallas_variant(x, w, cells, bs, widths, values, mode):
    """``_fwd_variant``'s pallas_call with ``interpret=True``."""
    R, F, S = x.shape
    g, k, H = w.shape
    return pl.pallas_call(
        SCRIPT._variant_kernel(cells, widths, values, mode),
        grid=(R, S // bs),
        in_specs=[pl.BlockSpec((1, F, bs), lambda r, i: (r, 0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((g, k, H), lambda r, i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, bs, H), lambda r, i: (r, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, S, H), jnp.float32),
        interpret=True,
    )(x, w)


def _codes(R, cells, S, seed):
    """Codes across and beyond both vocabularies (types and colors past
    the full widths, states past 19)."""
    rs = np.random.default_rng(seed)
    x = np.concatenate([rs.integers(0, 13, (R, cells, S)),
                        rs.integers(0, 12, (R, cells, S)),
                        rs.integers(0, 40, (R, cells, S))], axis=1)
    return x.astype(np.uint8)


@pytest.mark.parametrize("mode", P.MODES)
@pytest.mark.parametrize("cells", [49, 25])
@pytest.mark.parametrize("palettes", [None, PALETTES],
                         ids=["full-vocab", "palette"])
def test_plain_matches_pallas_probe(mode, cells, palettes):
    """'build' exact; 'full' and 'gemm' within 1e-2 relative and 2e-2
    absolute, the tolerance of test_torch_embed.py: the TPU kernel sums
    bf16 products in another order."""
    widths, values = E.vocab(palettes)
    R, S, H, bs = 2, 64, 32, 32
    x = _codes(R, cells, S, seed=cells)
    rs = np.random.default_rng(1)
    ws = [np.array(jnp.asarray(rs.normal(size=(cells, n, H)) * 0.1,
                                 jnp.bfloat16).astype(jnp.float32))
          for n in widths]
    packed = JE.pack_weights(*[jnp.asarray(w, jnp.bfloat16) for w in ws])
    want = np.asarray(_pallas_variant(jnp.asarray(x), packed, cells, bs,
                                      widths, values, mode))
    table = E.pack_weights(*map(torch.as_tensor, ws)).to(torch.bfloat16)
    got = P.fwd_variant(torch.as_tensor(x), table, widths, values, mode)
    assert P.fwd_variant.launches == 0
    assert got.dtype == torch.float32 and got.shape == (R, S, H)
    if mode == "build":
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.min() > 0 and want.max() <= 3 * cells
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=2e-2)
        assert np.abs(want).max() > 0.1


def test_modes_are_the_stated_functions():
    """What the kernel's modes compute, from the table directly: 'full' is
    K2f's plain version in float32, 'build' counts the codes that select a
    slot, 'gemm' scales the table's column sum by the first code."""
    cells, R, S, H = 25, 3, 16, 8
    widths, values = E.vocab(PALETTES)
    x = torch.as_tensor(_codes(R, cells, S, seed=3))
    w = torch.randn(cells, sum(widths), H,
                    generator=torch.Generator().manual_seed(0))
    lut = E.slot_table(widths, values)
    plane = np.repeat(np.arange(3), cells)
    hits = (lut[plane[None, :, None], x.numpy()] >= 0).sum(1)
    np.testing.assert_array_equal(
        P.fwd_variant(x, w, widths, values, "build")[..., 0].numpy(), hits)
    wb = w.to(torch.bfloat16).float()
    torch.testing.assert_close(
        P.fwd_variant(x, w, widths, values, "gemm"),
        x[:, 0, :, None].float() * wb.sum((0, 1)), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        P.fwd_variant(x, w, widths, values, "full"),
        E.onehot_embed_plain(x, wb, widths, values, torch.float32))
    with pytest.raises(ValueError, match="mode"):
        P.fwd_variant(x, w, widths, values, "dense")


def _mask_bit(row):
    """The bit of a table row within its 32-row mask word (the builders'
    layout: a thread's A-fragment rows 2t, 2t + 1 of a k-step in the two
    halves of the word)."""
    return ((row >> 1) & 7) | ((row >> 4) & 1) << 3 | (row & 1) << 4


def _mask_words(x, widths, values):
    """(R * S, k_words) uint32: the row masks K6's builder warps store for
    each sample, built as they build them: per 32-row word, the OR over the
    features of the word's range in ``fwd_walk`` of the bit of the row each
    selects (``row_bases`` + ``slot_table``), where that row is in the
    word."""
    R, F, S = x.shape
    cells = F // 3
    walk = E.fwd_walk(cells, widths, False)
    feats = walk[:2 * F].reshape(F, 2)
    ranges = walk[2 * F:].reshape(-1, 2)
    lut = E.slot_table(widths, values).astype(np.int64)
    codes = x.transpose(0, 2, 1).reshape(R * S, F).astype(np.int64)
    words = np.zeros((R * S, len(ranges)), np.uint64)
    for w, (i0, i1) in enumerate(ranges):
        for f, rbase in feats[i0:i1]:
            slot = lut[f // cells, codes[:, f]]
            row = rbase + slot
            hit = (slot >= 0) & (row >> 5 == w)
            words[:, w] |= np.where(hit, np.uint64(1) << _mask_bit(
                np.maximum(row, 0)).astype(np.uint64), np.uint64(0))
    return words.astype(np.uint32)


@pytest.mark.parametrize("cells", [49, 25])
@pytest.mark.parametrize("palettes", [None, PALETTES],
                         ids=["full-vocab", "palette"])
def test_build_mode_is_the_popcount_of_the_masks(cells, palettes):
    """'build' on the card stores, for every unit, the popcount of the
    sample's mask words: equal to the plain 'build' (the count of (cell,
    plane) pairs whose code selects a row), so no two features set one
    bit, and the bit layout is one-to-one within a word."""
    assert sorted(_mask_bit(np.arange(32)).tolist()) == list(range(32))
    widths, values = E.vocab(palettes)
    R, S, H = 2, 64, 8
    x = _codes(R, cells, S, seed=cells + 7)
    words = _mask_words(x, widths, values)
    assert words.shape[1] == -(-cells * sum(widths) // 32)
    bits = np.unpackbits(words.view(np.uint8), axis=1).sum(1)
    want = P.fwd_variant_plain(torch.as_tensor(x), torch.zeros(
        cells, sum(widths), H), widths, values, "build")
    np.testing.assert_array_equal(bits.reshape(R, S), want[..., 0].numpy())
    assert bits.min() > 0


def _gemm_emulated(x, table):
    """K6 'gemm' as the mma warps compute it, in numpy: every A entry of a
    sample is its first code in bf16 (exact), and each 16-row k-step over
    the table padded with zero rows to a multiple of 32 adds its products
    (exact in float32) to the float32 sums, one k-step at a time in
    order."""
    R, F, S = x.shape
    T = table.reshape(-1, table.shape[-1]).astype(np.float32)
    k_steps = 2 * -(-T.shape[0] // 32)
    T = np.concatenate([T, np.zeros((16 * k_steps - T.shape[0],
                                     T.shape[1]), np.float32)])
    x0 = x[:, 0, :].reshape(R * S).astype(np.float32)
    out = np.zeros((R * S, T.shape[1]), np.float32)
    for kk in range(k_steps):
        step = (x0[:, None, None] * T[None, 16 * kk:16 * (kk + 1)]).sum(
            1, dtype=np.float32)
        out += step
    return out.reshape(R, S, -1)


@pytest.mark.parametrize("cells", [49, 25])
@pytest.mark.parametrize("palettes", [None, PALETTES],
                         ids=["full-vocab", "palette"])
def test_gemm_mode_broadcast_k_steps(cells, palettes):
    """'gemm''s k-step sum against the plain 'gemm' (x0 * colsum(W)) and
    the TPU probe's kernel in interpret mode, run as
    test_plain_matches_pallas_probe runs it: within 1e-5 of max |out|
    (float32 sums of the same exact products in another order)."""
    widths, values = E.vocab(palettes)
    R, S, H, bs = 2, 64, 32, 32
    x = _codes(R, cells, S, seed=cells + 3)
    rs = np.random.default_rng(4)
    ws = [np.array(jnp.asarray(rs.normal(size=(cells, n, H)) * 0.1,
                                 jnp.bfloat16).astype(jnp.float32))
          for n in widths]
    table = E.pack_weights(*map(torch.as_tensor, ws))
    got = _gemm_emulated(x, table.numpy())
    plain = P.fwd_variant_plain(torch.as_tensor(x), table, widths, values,
                                "gemm").numpy()
    packed = JE.pack_weights(*[jnp.asarray(w, jnp.bfloat16) for w in ws])
    probe = np.asarray(_pallas_variant(jnp.asarray(x), packed, cells, bs,
                                       widths, values, "gemm"))
    for want in (plain, probe):
        scale = float(np.abs(want).max())
        assert scale > 1
        assert float(np.abs(got - want).max()) <= 1e-5 * scale
