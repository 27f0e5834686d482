"""The port's rewards and prestige bit-equal to the jitted JAX step.

XLA compiles ``marlgrid_tpu/core/step.py``'s reward decay ``1 - 0.9 * s /
max_steps`` into ``1 - s * c`` with ``c = f32(f32(0.9) * f32(1 / max_steps))``
as one fused multiply-add, and the prestige update ``prestige * beta +
max(rew, 0)`` as another; the port's ``core/step.py`` rounds each once the
same way (``reward_decay``, ``fma_f32``). The reference is the jitted JAX function, as VectorEnv,
the wrapper and the trainers run it (op-by-op JAX rounds each op). Every
field is compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import grid_gen as jgrid, step as jstep
from marlgrid_tpu.core.state import EnvParams as JParams, default_agent_colors
from marlgrid_tpu_torch.core import grid_gen, step as step_mod
from marlgrid_tpu_torch.core.state import FIELDS, EnvParams, state_to_numpy

B, T = 64, 150

CONFIGS = [
    pytest.param(JParams(width=9, height=9, n_agents=1, scenario="empty",
                         view_size=5, max_steps=200,
                         agent_colors=default_agent_colors(1),
                         observation_style="encode"), id="empty-9x9-decay"),
    pytest.param(JParams(width=13, height=13, n_agents=4,
                         scenario="goal_cycle", n_clutter=10,
                         reward_decay=False, max_steps=250,
                         agent_colors=default_agent_colors(4),
                         observation_style="encode"),
                 id="goalcycle-13x13-no-decay"),
    pytest.param(JParams(width=11, height=11, n_agents=3,
                         scenario="goal_cycle", n_clutter=5, max_steps=170,
                         agent_prestige_betas=(0.9, 0.95, 0.99),
                         agent_colors=default_agent_colors(3),
                         observation_style="encode"),
                 id="goalcycle-11x11-per-agent-betas"),
]


@pytest.mark.parametrize("jparams", CONFIGS)
def test_reward_fields_bit_equal(jparams):
    """150 steps of 64 envs from ``split(PRNGKey(0), 64)`` with
    ``default_rng(0)`` actions: rew and every state field (last_reward,
    accum_reward and prestige among them) bit-equal to ``jax.vmap(step)``
    under one jitted scan."""
    params = EnvParams.from_dict(jparams.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    acts = np.random.default_rng(0).integers(
        0, 7, (T, B, jparams.n_agents), dtype=np.int32)

    @jax.jit
    def run(keys, acts):
        s = jax.vmap(lambda k: jgrid.reset(jparams, k))(keys)

        def body(s, a):
            s2, r, d = jax.vmap(lambda ss, aa: jstep.step(jparams, ss, aa))(
                s, a)
            return s2, (s2, r)
        return jax.lax.scan(body, s, acts)[1]

    jtraj, jrew = jax.tree.map(np.asarray, run(keys, jnp.asarray(acts)))
    state = grid_gen.reset(params, torch.as_tensor(
        np.asarray(keys).astype(np.int64)))
    rewarded = 0
    for t in range(T):
        state, rew, _ = step_mod.step(params, state, torch.as_tensor(acts[t]))
        np.testing.assert_array_equal(rew.numpy(), jrew[t], err_msg=f"t={t}")
        got = state_to_numpy(state)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], getattr(jtraj, f)[t],
                                          err_msg=f"t={t} {f}")
        rewarded += int((jrew[t] != 0).sum())
    assert rewarded > 0                  # the runs do pay rewards


def test_decay_sweep_bit_equal():
    """The decay at every step count 1..max_steps for each max_steps 1..1000
    against the jitted JAX expression of core/step.py (max_steps a
    compile-time constant, as in the step)."""
    s_all = np.arange(1, 1001, dtype=np.int32)

    @jax.jit
    def decays(s):
        sf = s.astype(jnp.float32)
        return jnp.stack([1.0 - 0.9 * sf / m for m in range(1, 1001)])

    want = np.asarray(decays(jnp.asarray(s_all)))
    counts = torch.as_tensor(s_all)
    for m in range(1, 1001):
        got = step_mod.reward_decay(EnvParams(max_steps=m), counts[:m])
        np.testing.assert_array_equal(got.numpy(), want[m - 1, :m],
                                      err_msg=f"max_steps={m}")


@pytest.mark.parametrize("beta", [0.9, 0.95, 0.99])
def test_prestige_sweep_bit_equal(beta):
    """200,000 prestige updates of seeded values against the jitted JAX
    ``prestige * beta + max(rew, 0)`` (beta a compile-time constant)."""
    g = np.random.default_rng(int(beta * 100))
    n = 200_000
    prestige = np.concatenate([
        g.uniform(0, 40, n // 2), g.exponential(2.0, n // 2)]).astype(
            np.float32)
    rew = np.concatenate([
        g.uniform(-1, 3, n // 2),
        np.where(g.random(n // 2) < 0.5, 0.0,
                 g.uniform(0, 1, n // 2))]).astype(np.float32)
    betas = (beta,)

    @jax.jit
    def upd(p, r):
        return p * jnp.asarray(betas, jnp.float32) + jnp.maximum(r, 0.0)

    want = np.asarray(upd(jnp.asarray(prestige[:, None]),
                          jnp.asarray(rew[:, None])))[:, 0]
    got = step_mod.fma_f32(torch.as_tensor(prestige),
                           torch.tensor(betas, dtype=torch.float32).double(),
                           torch.as_tensor(rew).clamp(min=0.0)).numpy()
    np.testing.assert_array_equal(got, want)
    # the sweep reaches the cases that one rounding decides
    twice = (prestige * np.float32(beta)) + np.maximum(rew, 0)
    assert (twice != want).sum() > 100


def test_fma_matches_exact_rounding():
    """fma_f32 is the correctly rounded a*b + c, against exact rational
    arithmetic, where a float64 sum rounded again to float32 goes wrong:
    a = 1 + i/4096, b = 1 + j/4096 with i, j odd make the product exactly a
    float32 half-way point, and c = +-2**-70 tips it, a term the float64
    sum drops."""
    from fractions import Fraction

    g = np.random.default_rng(3)
    i, j = (2 * g.integers(0, 800, 500) + 1 for _ in range(2))
    a = (1 + i / 4096).astype(np.float32)
    b = (1 + j / 4096).astype(np.float32)
    c = (np.where(g.random(500) < 0.5, 1.0, -1.0) * 2.0 ** -70).astype(
        np.float32)
    got = step_mod.fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                           torch.as_tensor(c)).numpy()
    want = []
    for ai, bi, ci in zip(a, b, c):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(
            float(ci))
        # the float32 neighbours of the exact value: the nearest wins
        lo = np.float32(float(exact))
        if Fraction(float(lo)) > exact:
            lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(lo, np.float32(np.inf))
        want.append(lo if exact - Fraction(float(lo))
                    < Fraction(float(hi)) - exact else hi)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    # the ties a float64 sum leaves go to even: wrong on about half
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != got).sum() > 150
