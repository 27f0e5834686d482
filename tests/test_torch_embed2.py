"""The plane-major embed (``marlgrid_tpu_torch/ops/embed2.py``: the plain
versions of K5f and K5b and the slot table the CUDA kernels read) against
JAX's Pallas ``onehot_embed2`` in interpret mode and ``jax.grad`` through
it, and ``OneHotEmbed``'s plane-major route against its K2 route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.ops import embed2 as JE2
from marlgrid_tpu_torch.models.actor_critic import OneHotEmbed
from marlgrid_tpu_torch.ops import embed as E
from marlgrid_tpu_torch.ops import embed2 as E2

PALETTES = jobs.encode_palettes(JEnvParams(
    width=13, height=13, n_agents=4, scenario="goal_cycle",
    agent_colors=(0, 4, 5, 1), observation_style="encode"))


def _codes(R, cells, S, seed):
    """Codes across and beyond both vocabularies: types up to 15, colors
    up to 12 (past the full widths and outside the palette), states up to
    199 (box-packed states clip at 19)."""
    rs = np.random.default_rng(seed)
    x = np.concatenate([rs.integers(0, 16, (R, cells, S)),
                        rs.integers(0, 13, (R, cells, S)),
                        rs.integers(0, 200, (R, cells, S))], axis=1)
    return x.astype(np.uint8)


def _tables(cells, widths, H, seed):
    rs = np.random.default_rng(seed)
    return [(rs.normal(size=(cells, n, H)) * 0.1).astype(np.float32)
            for n in widths]


CASES = [
    # (cells, R, S, H, palettes)
    (49, 2, 128, 128, None),
    (49, 2, 256, 64, PALETTES),       # goal_cycle's compact vocabulary
    (25, 3, 128, 32, None),
]
IDS = ["full", "palette", "full-5x5"]


def _pallas(x, ws, widths, values):
    return JE2.onehot_embed2(jnp.asarray(x), *map(jnp.asarray, ws),
                             x.shape[1] // 3, 128, True, widths, values)


@pytest.mark.parametrize("cells,R,S,H,palettes", CASES, ids=IDS)
def test_plain_embed2_matches_pallas(cells, R, S, H, palettes):
    """The plain forward (float32 sums of the bf16-rounded tables) against
    the Pallas kernel in interpret mode: both add the same float32 products
    (bf16 tables times exact 0/1), in another order, and return float32
    unrounded, so they agree within 1e-5 of max |out|."""
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=cells + R)
    ws = _tables(cells, widths, H, seed=1)
    want = np.asarray(_pallas(x, ws, widths, values))
    got = E2.onehot_embed2(torch.as_tensor(x),
                           *map(torch.as_tensor, ws), widths, values)
    assert got.dtype == torch.float32 and got.shape == (R, S, H)
    assert E2.onehot_embed2.launches == 0
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("cells,R,S,H,palettes", CASES, ids=IDS)
def test_plain_embed2_grad_matches_jax_grad(cells, R, S, H, palettes):
    """The gradient through the port's autograd Function (on the CPU: the
    plain backward of the bf16-rounded dout) against ``jax.grad`` through
    the interpret-mode kernel (whose custom_vjp rounds dout to bf16 and runs
    the Pallas ``_bwd``), with a float32 cotangent: per table within 1e-5
    of max |dW| (the same float32 sums in another order)."""
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=cells + R + 1)
    ws = _tables(cells, widths, H, seed=2)
    g = np.random.default_rng(3).normal(size=(R, S, H)).astype(np.float32)

    def loss(*w):
        y = JE2.onehot_embed2(jnp.asarray(x), *w, cells, 128, True, widths,
                              values)
        return (y * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, ws))
    tw = [torch.as_tensor(w).requires_grad_(True) for w in ws]
    out = E2.onehot_embed2(torch.as_tensor(x), *tw, widths, values)
    assert type(out.grad_fn).__name__ == "_OneHotEmbed2FnBackward"
    got = torch.autograd.grad(out, tw, torch.as_tensor(g))
    assert E2.onehot_embed2_bwd.launches == 0
    for p, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, p
        scale = float(np.abs(b).max())
        assert scale > 0, p
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale, p


@pytest.mark.parametrize("palettes", [None, PALETTES], ids=["full",
                                                           "palette"])
def test_plane_slot_table_gather_sum(palettes):
    """What the CUDA kernels compute, in numpy: each output row is the sum
    of the rows of plane p's table that ``plane_slot_table`` selects. It
    equals the plain one-hot formulation (1e-5 covers the order of the
    float32 sums); the palette's table selects exactly its codes."""
    cells, R, S, H = 49, 2, 64, 16
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=5)
    # bf16-representable tables: the kernels read the tables as bf16
    ws = [torch.as_tensor(w).to(torch.bfloat16).float().numpy()
          for w in _tables(cells, widths, H, seed=6)]
    lut = E2.plane_slot_table(widths, values)
    want = np.zeros((R, S, H), np.float32)
    for f in range(3 * cells):
        p, j = divmod(f, cells)
        slot = lut[p][x[:, f, :]]                        # (R, S)
        rows = ws[p][j][np.maximum(slot, 0)]             # (R, S, H)
        want += np.where(slot[..., None] >= 0, rows, 0.0)
    got = E2.onehot_embed2_plain(torch.as_tensor(x),
                                 *map(torch.as_tensor, ws), widths, values)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for p, n in enumerate(widths):
        assert set(lut[p][lut[p] >= 0].tolist()) == set(range(n))
        if values is not None:
            assert set(np.flatnonzero(lut[p] >= 0).tolist()) == set(values[p])


def _ulp(y):
    """The spacing of bf16 values at |y| (8 significant bits)."""
    _, e = torch.frexp(y.float().abs())
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("palettes", [None, PALETTES], ids=["full",
                                                           "palette"])
def test_plane_major_route_matches_k2_route(palettes):
    """``OneHotEmbed`` at bf16 with the same weights on its two routes. The
    plane-major route (float32 sums of the bf16 tables, one rounding to
    bf16, the bias added in bf16) is within 1 bf16 ulp of the K2 route as
    K2f computes it on the card (the same float32 sums of the packed bf16
    table, rounded once). The K2 route's CPU version rounds each plane's
    bf16 product and the two sums between them, so against it the bar is
    2 bf16 ulps of the largest |output|."""
    cells, R, S, H = 49, 3, 64, 32
    x = torch.as_tensor(_codes(R, cells, S, seed=7))
    a = OneHotEmbed(cells, H, torch.bfloat16, palettes,
                    torch.Generator().manual_seed(0), plane_major=True)
    b = OneHotEmbed(cells, H, torch.bfloat16, palettes, plane_major=False)
    with torch.no_grad():
        a.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        ya, yb = a(x), b(x)
        k2f = E.onehot_embed_plain(
            x, b.table().to(torch.bfloat16).float(), b.widths, b.values,
            torch.float32).to(torch.bfloat16) + b.bias.to(torch.bfloat16)
    assert ya.dtype == yb.dtype == torch.bfloat16 and ya.shape == (R, S, H)
    assert bool(((ya.float() - k2f.float()).abs() <= _ulp(k2f)).all())
    top = float(ya.float().abs().max())
    assert float((ya.float() - yb.float()).abs().max()) <= 2 * float(
        _ulp(torch.tensor(top)))


def test_route_selected_by_environment(monkeypatch):
    """``MARLGRID_TPU_EMBED_V2`` picks the route when the module is built
    (as the JAX package reads it), an explicit keyword overrides it, and
    the plane-major route's gradient reaches the three tables and the bias
    through the embed2 autograd Function."""
    monkeypatch.delenv("MARLGRID_TPU_EMBED_V2", raising=False)
    assert not OneHotEmbed(4, 8).plane_major
    monkeypatch.setenv("MARLGRID_TPU_EMBED_V2", "1")
    emb = OneHotEmbed(4, 8, torch.float32)
    assert emb.plane_major and not OneHotEmbed(4, 8,
                                               plane_major=False).plane_major
    x = torch.as_tensor(_codes(2, 4, 16, seed=9))
    out = emb(x)
    out.sum().backward()
    for name in ("w0", "w1", "w2", "bias"):
        assert float(getattr(emb, name).grad.abs().sum()) > 0, name
