"""The PPO update of the port (``marlgrid_tpu_torch/parallel/ppo.py``)
against the JAX package's ``make_train_step``, on the CPU.

One full train step on goal_cycle 13x13 with 4 agents, B = 16, T = 8,
hidden 32, float32, the compact embed palettes and 2 epochs x 4
minibatches, from the same weights and key: the first minibatch's
gradients, every metric, the updated weights, the env state and the key.
Also GAE, the minibatch permutation at full width, the row-alignment check
(``ratio_dev`` at lr = 0), the remainder warning, the overlap variant and
the learning signal, mirroring ``tests/test_ppo.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           default_agent_colors,
                                           state_to_numpy)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo

B, T = 16, 8
METRICS = ("loss", "pg_loss", "vf_loss", "entropy", "ratio_dev",
           "episode_return", "episode_length", "episode_cycles",
           "n_episodes")


def _t(key):
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def _record_first_grad():
    """An optax stage that passes updates through and keeps the first
    ones it sees: placed after the clip, it holds the first minibatch's
    clipped gradient."""
    def init(params):
        return dict(g=jax.tree.map(jnp.zeros_like, params),
                    n=jnp.zeros((), jnp.int32))

    def update(updates, state, params=None):
        g = jax.tree.map(lambda a, b: jnp.where(state["n"] == 0, a, b),
                         updates, state["g"])
        return updates, dict(g=g, n=state["n"] + 1)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (compiled once for the module) and what went in."""
    jep = JEnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                     max_steps=12, reward_decay=False,
                     agent_colors=(0, 4, 5, 1), observation_style="encode")
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32,
                          embed_palettes=jobs.encode_palettes(jep))
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    net, params, _, _ = jppo.init_state(jep, jcfg, k_net)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    params = jax.tree.map(np.asarray, params)
    env0 = jppo.init_env_batch(jep, B, k_env, stagger=True)
    step = jppo.make_train_step(jep, jcfg, net, tx)
    p1, o1, env1, key1, m = jax.tree.map(np.asarray, step(
        jax.tree.map(jnp.asarray, params), tx.init(params), env0, k_step))
    return dict(jep=jep, jcfg=jcfg, params0=params, k_env=k_env,
                k_step=k_step, params1=p1, grad0=o1[1]["g"], env1=env1,
                key1=key1, metrics={k: float(v) for k, v in m.items()})


def _port(jep, jcfg, params):
    """The port's EnvParams, float32 PPOConfig, net (loaded with the flax
    weights) and optimizer for the JAX configuration."""
    ep = EnvParams.from_dict(jep.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(jcfg))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    net, opt = ppo.init_state(ep, cfg, device="cpu")
    net.load_state_dict(load_flax_params(params))
    return ep, cfg, net, opt


def test_train_step_matches_jax(jax_step):
    j = jax_step
    ep, cfg, net, opt = _port(j["jep"], j["jcfg"], j["params0"])
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in net.named_parameters()})
        if not grads else None)
    step = ppo.make_train_step(ep, cfg, net, opt, device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, key1, m = step(env0, _t(j["k_step"]))

    # the first minibatch's gradients (after the global-norm clip): two
    # float32 stacks summing in different orders
    want_g = load_flax_params(j["grad0"])
    assert len(grads) == 1 and opt.state[net.pi.weight]["step"] == 8
    for name, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), j["metrics"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert j["metrics"]["n_episodes"] > 0
    # updated weights: Adam's first step moves a weight by +-lr whatever
    # the size of its gradient, so a gradient at float32 noise level may
    # take the other sign in the other framework; compare where JAX's
    # first gradient is above 1e-6
    want_p = load_flax_params(j["params1"])
    for name, p in net.state_dict().items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_allclose(got1[f], np.asarray(getattr(j["env1"], f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])


def test_gae_matches_jax():
    Tg, M = 9, 7
    rs = np.random.default_rng(0)
    rew = rs.normal(size=(Tg, M)).astype(np.float32)
    val = rs.normal(size=(Tg, M)).astype(np.float32)
    done = rs.random((Tg, M)) < 0.3
    last = rs.normal(size=(M,)).astype(np.float32)
    want = jax.jit(lambda *a: jppo._gae(*a, 0.99, 0.95))(
        jnp.asarray(rew), jnp.asarray(val), jnp.asarray(done),
        jnp.asarray(last))
    got = ppo._gae(*map(torch.as_tensor, (rew, val, done, last)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("n", [8192, 33])
def test_permutation_matches_jax(n):
    """The minibatch order: at full width G = 8192 blocks, which takes two
    stable-sort rounds."""
    key = jax.random.fold_in(jax.random.PRNGKey(11), n)
    want = np.asarray(jax.random.permutation(key, n))
    got = rng.permutation(_t(key), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_layout():
    """c = 128 at full width (G = 8192 blocks); block g of the layout is
    (agent, step, env-chunk) = divmod over (N, T, B // c)."""
    assert ppo.block_size(4096, 64, 4) == 128
    T, N, Fd, B, c = 3, 2, 5, 8, 4
    obs = torch.arange(T * N * Fd * B).reshape(T, N, Fd, B)
    blocks = ppo.obs_blocks(obs, c)
    assert blocks.shape == (N * T * (B // c), Fd, c)
    for g in range(blocks.shape[0]):
        a, rest = divmod(g, T * (B // c))
        t, k = divmod(rest, B // c)
        assert torch.equal(blocks[g], obs[t, a, :, k * c:(k + 1) * c])


def test_clip_by_global_norm_matches_optax():
    rs = np.random.default_rng(1)
    gs = [rs.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in gs], None)
        got = [torch.as_tensor(g.copy()) for g in gs]
        ppo.clip_by_global_norm(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)


EP_SMALL = EnvParams(width=9, height=9, n_agents=2, scenario="empty",
                     max_steps=20, view_size=5, observation_style="encode",
                     agent_colors=default_agent_colors(2))


def _small(cfg, seed, overlap=False):
    net, opt = ppo.init_state(EP_SMALL, cfg,
                              torch.Generator().manual_seed(seed),
                              device="cpu")
    key = rng.PRNGKey(seed, device="cpu")
    env = ppo.init_env_batch(EP_SMALL, cfg.n_envs, rng.fold_in(key, 1),
                             device="cpu")
    step = ppo.make_train_step(EP_SMALL, cfg, net, opt, device="cpu",
                               overlap=overlap)
    return net, env, key, step


def test_ratio_dev_row_alignment():
    """At lr = 0 the stored logp, recomputed from the stored feature-major
    obs at unchanged weights, agrees: |ratio - 1| stays ~0."""
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=8, n_epochs=1,
                        n_minibatches=1, lr=0.0, dtype=torch.float32)
    net, env, key, step = _small(cfg, 3)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    _, _, m = step(env, key)
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_minibatch_remainder_warns():
    """Blocks that do not divide into n_minibatches are dropped, with a
    warning (G = 2 agents x 8 steps = 16 blocks, 16 % 3 != 0)."""
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=8, n_epochs=1,
                        n_minibatches=3)
    _, env, key, step = _small(cfg, 0)
    with pytest.warns(UserWarning, match="dropping"):
        step(env, key)


def test_overlap_step_runs_and_aligns():
    """The overlap variant: a priming rollout, then steps whose update
    takes the previous trajectory; at lr = 0 it still aligns."""
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=8, n_epochs=1,
                        n_minibatches=1, lr=0.0, dtype=torch.float32)
    _, env, key, (step, prime) = _small(cfg, 5, overlap=True)
    env, prev, key = prime(env, key)
    for _ in range(2):
        env, prev, key, m = step(env, prev, key)
    assert np.isfinite(float(m["loss"]))
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])


@pytest.mark.slow
def test_learning_signal():
    """A few iterations on a trivial task raise the episode return."""
    ep = EnvParams(width=7, height=7, n_agents=1, scenario="empty",
                   max_steps=12, view_size=5, observation_style="encode",
                   agent_colors=default_agent_colors(1))
    cfg = ppo.PPOConfig(n_envs=64, rollout_len=24, n_epochs=2,
                        n_minibatches=2, lr=1e-3, ent_coef=0.003)
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    key = rng.PRNGKey(1, device="cpu")
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             device="cpu")
    step = ppo.make_train_step(ep, cfg, net, opt, device="cpu")
    rets = []
    for _ in range(30):
        env, key, m = step(env, key)
        rets.append(float(m["episode_return"]))
    early, late = np.mean(rets[2:8]), np.mean(rets[-6:])
    assert late > early + 0.05, f"no learning: early={early:.3f} " \
                                f"late={late:.3f}"
