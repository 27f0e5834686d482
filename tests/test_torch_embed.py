"""The encode embed (K2f's plain version and the slot table its CUDA kernel
reads) against JAX's Pallas ``onehot_embed`` in interpret mode, and the
ported ActorCritic, loaded with the flax weights, against the flax model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.models import ActorCritic as JActorCritic
from marlgrid_tpu.ops import embed as JE
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.models import ActorCritic, load_flax_params
from marlgrid_tpu_torch.models.actor_critic import lecun_normal_
from marlgrid_tpu_torch.ops import embed as E
from marlgrid_tpu_torch.parallel import ppo

GOAL_CYCLE = JEnvParams(width=13, height=13, n_agents=4,
                        scenario="goal_cycle", n_clutter=10,
                        agent_colors=(0, 4, 5, 1),
                        observation_style="encode")
PALETTES = jobs.encode_palettes(GOAL_CYCLE)


def _codes(R, cells, S, seed, state_hi=20):
    """Codes across and beyond both vocabularies: types up to 12, colors
    up to 11 (past the full widths), states up to ``state_hi``."""
    rs = np.random.default_rng(seed)
    x = np.concatenate([rs.integers(0, 13, (R, cells, S)),
                        rs.integers(0, 12, (R, cells, S)),
                        rs.integers(0, state_hi, (R, cells, S))], axis=1)
    return x.astype(np.uint8)


def _tables(cells, widths, H, seed):
    rs = np.random.default_rng(seed)
    return [(rs.normal(size=(cells, n, H)) * 0.1).astype(np.float32)
            for n in widths]


CASES = [
    # (cells, R, S, H, state_hi, palettes)
    (49, 2, 256, 128, 20, None),
    (25, 3, 128, 128, 200, None),      # box-packed states clip at 19
    (49, 2, 256, 128, 20, PALETTES),   # goal_cycle's compact vocabulary
]


@pytest.mark.parametrize("cells,R,S,H,state_hi,palettes", CASES)
def test_plain_embed_matches_pallas(cells, R, S, H, state_hi, palettes):
    """The plain version (float32) against the Pallas kernel in interpret
    mode, called as tests/test_embed_kernel.py calls it, with that file's
    tolerance: the kernel's bf16 products are summed in another order."""
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=cells + R, state_hi=state_hi)
    ws = _tables(cells, widths, H, seed=1)
    want = JE.onehot_embed(jnp.asarray(x),
                           JE.pack_weights(*map(jnp.asarray, ws)), cells,
                           128, True, widths, values)
    table = E.pack_weights(*map(torch.as_tensor, ws))
    got = E.onehot_embed(torch.as_tensor(x), table, widths, values,
                         torch.float32)
    assert got.shape == (R, S, H) and E.onehot_embed.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("palettes", [None, PALETTES])
def test_slot_table_gather_sum(palettes):
    """What the CUDA kernel computes, in numpy: each output row is the sum
    of the table rows that ``slot_table`` selects. It equals the plain
    one-hot formulation in float32 (both sum the same float32 values; the
    1e-5 covers the order)."""
    cells, R, S, H = 49, 2, 64, 16
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=5, state_hi=200)
    ws = _tables(cells, widths, H, seed=2)
    table = np.concatenate(ws, axis=1)                  # (cells, cw, H)
    lut = E.slot_table(widths, values)
    plane = np.repeat(np.arange(3), cells)              # feature -> plane
    cell = np.tile(np.arange(cells), 3)
    slot = lut[plane[None, :, None], x]                 # (R, F, S)
    rows = np.where(slot[..., None] >= 0,
                    table[cell[None, :, None], np.maximum(slot, 0)], 0.0)
    want = rows.sum(1)                                  # (R, S, H)
    got = E.onehot_embed_plain(torch.as_tensor(x), torch.as_tensor(table),
                               widths, values, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if values is not None:
        for p in range(3):
            inside = set(np.flatnonzero(lut[p] >= 0).tolist())
            assert inside == set(values[p])


def _flax_and_port(dtype, jdtype, hidden=32):
    jcfg = jppo.PPOConfig(hidden=hidden, dtype=jdtype,
                          embed_palettes=PALETTES)
    jnet = JActorCritic(jcfg)
    params = jnet.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 7, 7, 3), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    cfg = ppo.PPOConfig(hidden=hidden, dtype=dtype, embed_palettes=PALETTES)
    net = ActorCritic(cfg, 7, device="cpu")
    net.load_state_dict(load_flax_params(params))
    return jnet, params, net


def _obs(N=4, S=64):
    """Feature-major (N, 147, S) codes inside the goal_cycle palette."""
    rs = np.random.default_rng(7)
    planes = [rs.choice(np.asarray(v), size=(N, 49, S)) for v in PALETTES]
    return np.concatenate(planes, axis=1).astype(np.uint8)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-5),
    # bf16 activations: each of the three layers rounds to bf16 (2**-8
    # relative), and torch and XLA may round a sum at different places;
    # 1e-2 is about two bf16 ulps of the largest logit (~1.3)
    (torch.bfloat16, jnp.bfloat16, 1e-2),
])
def test_actor_critic_matches_flax(dtype, jdtype, tol):
    jnet, params, net = _flax_and_port(dtype, jdtype)
    obs = _obs()
    jl, jv = jnet.apply(params, jnp.asarray(obs), feature_major=True)
    with torch.no_grad():
        logits, value = net(torch.as_tensor(obs))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (4, 64, 7) and value.shape == (4, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=tol,
                               atol=tol)


def test_own_init_is_lecun_normal():
    """The port's init draws flax's lecun-normal (a normal cut at two
    standard deviations, variance 1/fan_in) from an explicit generator."""
    g = torch.Generator().manual_seed(0)
    w = lecun_normal_(torch.empty(200000), 50, g)
    assert abs(float(w.std()) - (1 / 50) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / 50) ** 0.5 / 0.87962566 + 1e-6
    cfg = ppo.PPOConfig(hidden=16, embed_palettes=PALETTES)
    a = ActorCritic(cfg, 7, torch.Generator().manual_seed(3), device="cpu")
    b = ActorCritic(cfg, 7, torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert a.torso0.w0.shape == (49 * len(PALETTES[0]), 16)
    assert torch.count_nonzero(a.pi.bias) == 0


def _dout(R, S, H, seed):
    """bf16-representable dout, as the kernels read it."""
    rs = np.random.default_rng(seed)
    return np.array(jnp.asarray(rs.normal(size=(R, S, H)), jnp.bfloat16)
                    .astype(jnp.float32))


@pytest.mark.parametrize("cells,R,S,H,state_hi,palettes", CASES)
def test_plain_embed_bwd_matches_pallas(cells, R, S, H, state_hi, palettes):
    """The plain weight gradient against the Pallas ``_bwd_w`` in
    interpret mode, with the same bf16 dout (the custom_vjp's backward casts
    dout to bf16 and calls ``_bwd_w`` so). Pallas returns group-packed
    (g, grp*cw, H) tables; unpacked to (cells, cw, H). Both sum the same
    float32 values in another order: max |err| <= 1e-5 of max |g|."""
    widths, values = E.vocab(palettes)
    x = _codes(R, cells, S, seed=cells + R, state_hi=state_hi)
    d = _dout(R, S, H, seed=2)
    want = JE._bwd_w(jnp.asarray(x), jnp.asarray(d, jnp.bfloat16), cells,
                     128, True, widths, values)
    g = want.shape[0]
    want = np.asarray(want).reshape(g * JE.group_size(widths), sum(widths),
                                    H)[:cells]
    got = E.onehot_embed_bwd(torch.as_tensor(x), torch.as_tensor(d), widths,
                             values)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert E.onehot_embed_bwd.launches == 0
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("palettes", [None, PALETTES])
def test_embed_grad_is_dense_autograd(palettes):
    """On the CPU, OneHotEmbed's gradient goes through the embed's
    autograd Function with the plain backward, and equals autograd of the
    dense one-hot formulation in float32 (the same float32 products summed
    in the same einsum: within 1e-6)."""
    from marlgrid_tpu_torch.models.actor_critic import OneHotEmbed

    cells, R, S, H = 49, 2, 32, 16
    emb = OneHotEmbed(cells, H, torch.float32, palettes,
                      torch.Generator().manual_seed(1))
    x = torch.as_tensor(_codes(R, cells, S, seed=4, state_hi=200))
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=(R, S, H)).astype(np.float32))
    out = E.onehot_embed(x, emb.table(), emb.widths, emb.values,
                         torch.float32)
    assert type(out.grad_fn).__name__ == "_OneHotEmbedFnBackward"
    (emb(x) * g).sum().backward()
    got = [emb.w0.grad, emb.w1.grad, emb.w2.grad, emb.bias.grad]

    ws = [getattr(emb, f"w{i}").detach().clone().requires_grad_(True)
          for i in range(3)]
    bias = emb.bias.detach().clone().requires_grad_(True)
    o = x.long().reshape(R, 3, cells, S)
    dense = bias
    for p, (w, n) in enumerate(zip(ws, emb.widths)):
        code = o[:, p]
        if palettes is None:
            code = code.clamp(0, 19) if p == 2 else code
            voc = torch.arange(n)
        else:
            voc = torch.as_tensor(palettes[p])
        oh = (code[:, :, None, :] == voc[:, None]).float()
        dense = dense + torch.einsum("rcns,cnh->rsh", oh,
                                     w.reshape(cells, n, H))
    (dense * g).sum().backward()
    for a, b in zip(got, ws + [bias]):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert float(emb.w2.grad.abs().sum()) > 0
