"""The port's recurrent PPO on rendered observations (the image/rich path of
``marlgrid_tpu_torch/parallel/ppo_rnn.py``) against the JAX package's
``make_train_step_rnn``, on the CPU.

One full train step on empty 9x9 with 2 agents, 7x7 views of 8-pixel tiles,
B = 8, T = 4, the 'cnn_s2d' torso with a GRU, hidden 32, float32 and 2
epochs x 4 minibatches, from the same weights and key: the first
minibatch's gradients, every metric, the updated weights, the carry, the
env state and the key. Also the cnn_s2d ``RecurrentActorCritic`` against
flax, and the row alignment of the rich path (``ratio_dev`` at lr = 0 with
an LSTM on the 'cnn_image' torso, every observe_* field, two BPTT windows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_rnn as jppo_rnn
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           state_to_numpy)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo, ppo_rnn
from test_torch_ppo import METRICS, _record_first_grad, _t
from test_torch_rnn import check_recurrent_vs_flax

B, T = 8, 4
JEP = JEnvParams(width=9, height=9, n_agents=2, scenario="empty",
                 max_steps=6, observation_style="image", agent_colors=(0, 4))


@pytest.fixture(scope="module")
def jax_step():
    """One JAX recurrent image train step and what went in."""
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          torso="cnn_s2d", rnn="gru", dtype=jnp.float32)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    net, params, _, _, h = jppo_rnn.init_state_rnn(JEP, jcfg, k_net)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    params = jax.tree.map(np.asarray, params)
    env0 = jppo.init_env_batch(JEP, B, k_env, stagger=True)
    step = jppo_rnn.make_train_step_rnn(JEP, jcfg, net, tx)
    p1, o1, env1, h1, key1, m = jax.tree.map(np.asarray, step(
        jax.tree.map(jnp.asarray, params), tx.init(params), env0, h, k_step))
    return dict(jcfg=jcfg, params0=params, k_env=k_env, k_step=k_step,
                params1=p1, grad0=o1[1]["g"], env1=env1, h1=h1, key1=key1,
                metrics={k: float(v) for k, v in m.items()})


def test_image_rnn_train_step_matches_jax(jax_step):
    j = jax_step
    ep = EnvParams.from_dict(JEP.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(j["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, device="cpu")
    net.load_state_dict(load_flax_params(j["params0"]))
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in net.named_parameters()})
        if not grads else None)
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, h1, key1, m = step(env0, h, _t(j["k_step"]))

    # the first minibatch's gradients (after the global-norm clip): two
    # float32 conv stacks and cells summing in different orders
    want_g = load_flax_params(j["grad0"])
    assert len(grads) == 1 and opt.state[net.pi.weight]["step"] == 8
    for name, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), j["metrics"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert j["metrics"]["n_episodes"] > 0
    # Adam's first step moves a weight by +-lr whatever the size of its
    # gradient: compare where JAX's first gradient is above 1e-6
    want_p = load_flax_params(j["params1"])
    for name, p in net.state_dict().items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert h1.shape == (B, 2, 32)
    np.testing.assert_allclose(h1.numpy(), j["h1"], rtol=0, atol=1e-5)
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])


def test_recurrent_cnn_s2d_matches_flax():
    check_recurrent_vs_flax("gru", "cnn_s2d")


RICH = EnvParams(width=9, height=9, n_agents=2, scenario="doorkey",
                 max_steps=10, observation_style="rich", view_size=5,
                 view_tile_size=4, observe_rewards=True,
                 observe_position=True, observe_orientation=True,
                 agent_colors=(0, 4))


def test_rich_rnn_row_alignment():
    """At lr = 0 the update re-renders each window's stored states, rebuilds
    the aux features and re-runs the cell from the stored entry carry: the
    log-probs equal the rollout's (|ratio - 1| ~ 0) and no weight moves.
    The trajectory holds the pre-step states; the carry is (B, N, H)."""
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1,
                        n_minibatches=2, lr=0.0, hidden=16, rnn="lstm",
                        bptt_window=2, torso="cnn_image",
                        dtype=torch.float32)
    net, opt, h = ppo_rnn.init_state_rnn(
        RICH, cfg, torch.Generator().manual_seed(3), device="cpu")
    assert net.cell.i.in_features == 3 * 3 * 64 + ppo.aux_dim(RICH)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    key = rng.PRNGKey(3, device="cpu")
    env = ppo.init_env_batch(RICH, 8, rng.fold_in(key, 1), device="cpu")
    rollout = ppo_rnn.make_rollout_rnn(RICH, cfg, net, device="cpu")
    _, _, _, traj, h0s, _ = rollout(env, h, key)
    assert traj["obs"].grid_type.shape == (4, 8, 81)
    assert torch.equal(traj["obs"].agent_pos[0], env.agent_pos)
    assert traj["act"].shape == traj["rew"].shape == (4, 8, 2)
    assert h0s[0].shape == (2, 8, 2, 16) and not h0s[0][0].any()
    step = ppo_rnn.make_train_step_rnn(RICH, cfg, net, opt, device="cpu")
    _, _, _, m = step(env, h, key)
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
