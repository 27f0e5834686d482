"""The port's image-observation PPO (the recompute path of
``marlgrid_tpu_torch/parallel/ppo.py``) against the JAX package's
``make_train_step``, on the CPU.

One full train step on empty 9x9 with 2 agents, 7x7 views of 8-pixel tiles,
B = 8, T = 4, the 'cnn_s2d' torso, hidden 32, float32 and 2 epochs x 4
minibatches, from the same weights and key: the first minibatch's
gradients, every metric, the updated weights, the env state and the key.
Also the row alignment of the rich-obs path (``ratio_dev`` at lr = 0 with
the 'cnn_image' torso and every observe_* field), ``rich_aux`` and the
state-block layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import EnvState as JEnvState
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           state_to_numpy)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo
from test_torch_ppo import METRICS, _record_first_grad, _t

B, T = 8, 4


@pytest.fixture(scope="module")
def jax_step():
    """One JAX image train step and what went in."""
    jep = JEnvParams(width=9, height=9, n_agents=2, scenario="empty",
                     max_steps=6, observation_style="image",
                     agent_colors=(0, 4))
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          torso="cnn_s2d", dtype=jnp.float32)
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


def test_image_train_step_matches_jax(jax_step):
    j = jax_step
    ep = EnvParams.from_dict(j["jep"].to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(j["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    net, opt = ppo.init_state(ep, cfg, device="cpu")
    net.load_state_dict(load_flax_params(j["params0"]))
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in net.named_parameters()})
        if not grads else None)
    step = ppo.make_train_step(ep, cfg, net, opt, device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, key1, m = step(env0, _t(j["k_step"]))

    # the first minibatch's gradients (after the global-norm clip): two
    # float32 conv stacks summing in different orders
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
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])


RICH = EnvParams(width=9, height=9, n_agents=2, scenario="doorkey",
                 max_steps=10, observation_style="rich",
                 observe_rewards=True, observe_position=True,
                 observe_orientation=True, agent_colors=(0, 4))


def test_rich_row_alignment():
    """At lr = 0 the stored logp, recomputed from the re-rendered obs and
    the aux features of the stored states at unchanged weights, agrees:
    |ratio - 1| stays ~0 and no weight moves. The trajectory holds the
    pre-step states, in (T, B, ...) leaves."""
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1,
                        n_minibatches=2, lr=0.0, hidden=16,
                        torso="cnn_image", dtype=torch.float32)
    net, opt = ppo.init_state(RICH, cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    assert net.torso.in_features == 3136 + ppo.aux_dim(RICH)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    key = rng.PRNGKey(3, device="cpu")
    env = ppo.init_env_batch(RICH, 8, rng.fold_in(key, 1), device="cpu")
    rollout = ppo.make_rollout(RICH, cfg, net, device="cpu")
    _, _, traj, last = rollout(env, key)
    assert traj["obs"].grid_type.shape == (4, 8, 81)
    assert torch.equal(traj["obs"].agent_pos[0], env.agent_pos)
    assert traj["act"].shape == traj["rew"].shape == (4, 8, 2)
    step = ppo.make_train_step(RICH, cfg, net, opt, device="cpu")
    _, _, m = step(env, key)
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_rich_aux_matches_jax():
    jparams = JEnvParams.from_dict(RICH.replace(width=11).to_dict())
    params = EnvParams.from_dict(jparams.to_dict())
    env = ppo.init_env_batch(params, 4, rng.PRNGKey(5, device="cpu"),
                             device="cpu")
    env.last_reward = torch.linspace(-1, 1, 8).reshape(4, 2)
    js = JEnvState(**{f: jnp.asarray(v)
                      for f, v in state_to_numpy(env).items()})
    got = ppo.rich_aux(params, env)
    assert got.shape == (4, 2, 7) and ppo.aux_dim(params) == 7
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jppo.rich_aux(jparams, js)))
    assert ppo.rich_aux(params.replace(observe_rewards=False,
                                       observe_position=False,
                                       observe_orientation=False),
                        env) is None


@pytest.mark.parametrize("style,torso", [("image", "cnn_s2d"),
                                         ("rich", "cnn_image"),
                                         ("encode", "mlp")])
def test_obs_spec_matches_jax(style, torso):
    ep = RICH.replace(observation_style=style, view_size=5,
                      view_tile_size=12)
    jep = JEnvParams.from_dict(ep.to_dict())
    shape, dtype = ppo.obs_spec(ep, ppo.PPOConfig(torso=torso))
    jshape, jdtype = jppo.obs_spec(jep, jppo.PPOConfig(torso=torso))
    assert shape == jshape
    assert str(dtype).split(".")[-1] == np.dtype(jdtype).name


def test_state_blocks_and_paths():
    """c = 32 at the train default (G = 8192 state blocks); the two row-store
    configurations build and train a step (image obs without recompute, the
    'cnn' torso on encode obs); the recurrent one raises, naming its
    ROADMAP slice."""
    assert ppo.state_block_size(4096, 64) == 32
    assert ppo.state_block_size(8, 4) == 8
    img = RICH.replace(observation_style="image", view_size=5)
    for cfg, ep in (
            (ppo.PPOConfig(torso="cnn_s2d", recompute_image_obs=False), img),
            (ppo.PPOConfig(torso="cnn"), img.replace(
                observation_style="encode"))):
        cfg = ppo.PPOConfig(**{**cfg.__dict__, "n_envs": 4, "rollout_len": 2,
                               "hidden": 8, "channels": (4,),
                               "board_pool": 4, "dtype": torch.float32})
        net, opt = ppo.init_state(ep, cfg, device="cpu")
        key = rng.PRNGKey(0, device="cpu")
        env = ppo.init_env_batch(ep, 4, key, device="cpu")
        _, _, m = ppo.make_train_step(ep, cfg, net, opt, device="cpu")(
            env, key)
        assert np.isfinite(float(m["loss"]))
    with pytest.raises(NotImplementedError, match="Slice D"):
        ppo.init_state(img, ppo.PPOConfig(torso="cnn_s2d", rnn="gru"),
                       device="cpu")
    with pytest.raises(ValueError, match="cnn_s2d or cnn_image"):
        ppo.make_rollout(img, ppo.PPOConfig(torso="mlp"), None, device="cpu")
