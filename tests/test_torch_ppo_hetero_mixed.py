"""The port's mixed-style heterogeneous PPO
(``marlgrid_tpu_torch/parallel/ppo_hetero_mixed.py``) against the JAX
package's ``make_train_step_hetero_mixed``, on the CPU.

One train step on goal_cycle 13x13 with three agents of three styles: an
encode agent with a 7x7 view, an image agent and a rich agent (rewards and
orientation) with 5x5 views of 4-pixel tiles (the cnn_s2d torso), B = 16,
T = 8, hidden 32, float32, from the same weights and key: each group's
gradients, the metrics, the weights, the env state and the key, with
``test_torch_ppo.py``'s tolerances.

Under Adam the step runs one epoch of 2 minibatches of (step, env-chunk)
blocks. Adam moves a weight by about lr whatever the size of its gradient,
so a conv weight whose gradient is at float32 noise takes either sign, and
from the second minibatch on those weights feed the gradients: at 2 epochs
x 4 minibatches the groups' gradients agree to 1.2e-6 of their max at the
first minibatch but the pixel groups' to 1e-5 - 2.6e-4 at the later ones,
and 34 of the image group's 5324 conv1 weights end up to 1.25e-4 apart,
past the weights' 1e-4. Under SGD, which moves a weight in proportion to
its gradient, every one of the eight minibatches' gradients agrees to
5.6e-6 of its max; so the 2 x 4 step, with its second epoch's key and
permutation, is held to JAX under SGD. Also the row alignment at lr = 0
and the group configs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_hetero_mixed as jmixed
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo, ppo_hetero_mixed
from test_torch_ppo import METRICS, _t
from test_torch_ppo_hetero import (B, T, check_step, jax_hetero_step,
                                   port_config, record_first_grads)

MIXED = JEnvParams(width=13, height=13, n_agents=3, scenario="goal_cycle",
                   max_steps=12, reward_decay=False, agent_colors=(0, 4, 5),
                   observation_style="encode", view_tile_size=4,
                   agent_obs_styles=("encode", "image", "rich"),
                   agent_view_sizes=(7, 5, 5), observe_rewards=True,
                   observe_orientation=True)


@pytest.fixture(scope="module")
def jax_step():
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32, n_epochs=1, n_minibatches=2)
    return jax_hetero_step(MIXED, jcfg, jmixed.init_state_hetero_mixed,
                           jmixed.make_train_step_hetero_mixed)


def test_train_step_matches_jax(jax_step):
    j = jax_step
    ep, cfg = port_config(MIXED, j["jcfg"])
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(ep, cfg,
                                                         device="cpu")
    assert [n.kind for n in nets] == ["mlp", "cnn_s2d", "cnn_s2d"]
    for net, sd in zip(nets, load_flax_params(j["params0"])):
        net.load_state_dict(sd)
    grads = record_first_grads(nets, opt)
    step = ppo_hetero_mixed.make_train_step_hetero_mixed(ep, cfg, nets, opt,
                                                         device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, key1, m = step(env0, _t(j["k_step"]))
    check_step(j, nets, opt, grads, m, env1, key1)


def _record_grads(n):
    """An optax stage that passes updates through and keeps the first
    ``n`` it sees, stacked: placed after the clip, each minibatch's clipped
    gradient."""
    def init(params):
        return dict(g=jax.tree.map(
            lambda p: jnp.zeros((n,) + p.shape, p.dtype), params),
            i=jnp.zeros((), jnp.int32))

    def update(updates, state, params=None):
        at = jnp.minimum(state["i"], n - 1)
        g = jax.tree.map(lambda u, s: s.at[at].set(u), updates, state["g"])
        return updates, dict(g=g, i=state["i"] + 1)

    return optax.GradientTransformation(init, update)


def test_two_epochs_match_jax_under_sgd():
    """The default 2 epochs x 4 minibatches under SGD at lr 1 on both
    sides: every minibatch's gradients per group (rtol 1e-4, atol 1e-6;
    they read 5.6e-6 of their max apart at most), the weights (atol 1e-5:
    they read 1.2e-7 apart, and each weight tensor moves by 5e-4 to 0.1),
    the metrics (1e-5), the env state and the key."""
    lr, steps = 1.0, 8
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32)
    assert jcfg.n_epochs * jcfg.n_minibatches == steps
    j = jax_hetero_step(MIXED, jcfg, jmixed.init_state_hetero_mixed,
                        jmixed.make_train_step_hetero_mixed,
                        record=_record_grads(steps), last=optax.sgd(lr))
    ep, cfg = port_config(MIXED, jcfg)
    nets, _ = ppo_hetero_mixed.init_state_hetero_mixed(ep, cfg, device="cpu")
    for net, sd in zip(nets, load_flax_params(j["params0"])):
        net.load_state_dict(sd)
    w0 = [{k: v.clone() for k, v in n.state_dict().items()} for n in nets]
    opt = torch.optim.SGD(nets.parameters(), lr=lr)
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        [{n: p.grad.clone() for n, p in net.named_parameters()}
         for net in nets]))
    step = ppo_hetero_mixed.make_train_step_hetero_mixed(ep, cfg, nets, opt,
                                                         device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, key1, m = step(env0, _t(j["k_step"]))
    assert len(grads) == steps
    for i in range(steps):
        want = load_flax_params(jax.tree.map(lambda a: a[i], j["grad0"]))
        for g in range(len(nets)):
            for name, grad in grads[i][g].items():
                np.testing.assert_allclose(
                    grad.numpy(), want[g][name].numpy(), rtol=1e-4,
                    atol=1e-6, err_msg=f"minibatch {i} group {g} {name}")
    want_p = load_flax_params(j["params1"])
    for g, net in enumerate(nets):
        for name, p in net.state_dict().items():
            assert float((p - w0[g][name]).abs().max()) > 1e-4, name
            np.testing.assert_allclose(p.numpy(), want_p[g][name].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"group {g} {name}")
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), j["metrics"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])


def test_alignment_at_lr0_and_group_cfg():
    """At lr = 0 the encode group's stored codes and the pixel groups'
    re-render from the stored pre-step states (the rich features too) give
    back the rollout's log-probs, on the second step too (nonzero
    last_reward); a 5x5 view of 5-pixel tiles (side 25) takes cnn_image."""
    ep = EnvParams.from_dict(MIXED.to_dict())
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1, n_minibatches=2,
                        lr=0.0, hidden=16, dtype=torch.float32)
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(3), device="cpu")
    key = rng.PRNGKey(3, device="cpu")
    env = ppo.init_env_batch(ep, 8, rng.fold_in(key, 1), device="cpu")
    step = ppo_hetero_mixed.make_train_step_hetero_mixed(ep, cfg, nets, opt,
                                                         device="cpu")
    for _ in range(2):
        env, key, m = step(env, key)
        assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    gp = ep.agent_obs_params(1)
    assert ppo_hetero_mixed.group_cfg(cfg, gp).torso == "cnn_s2d"
    assert ppo_hetero_mixed.group_cfg(
        cfg, gp.replace(view_tile_size=5)).torso == "cnn_image"
    assert ppo_hetero_mixed.group_cfg(
        cfg, ep.agent_obs_params(0)).torso == "mlp"
