"""The slice end to end: the port's ``make_rollout`` against the JAX
``rollout_only`` (``make_train_step(..., overlap=True)[1]``) on goal_cycle
13x13 with 4 agents, B = 16, T = 8, hidden 32, board pool 4, float32 and
the compact embed palettes, from the same key and the same weights.

Trajectory obs, actions, rewards, dones and episode tallies and the final
env state are equal; logp, val and last_value agree within 1e-5 (two
float32 GEMM stacks summing in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import ActorCritic, load_flax_params
from marlgrid_tpu_torch.parallel import ppo

B, T = 16, 8


def _t(key):
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def test_rollout_matches_jax():
    jep = JEnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                     max_steps=12, reward_decay=False,
                     agent_colors=(0, 4, 5, 1), observation_style="encode")
    pals = jobs.encode_palettes(jep)
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32, embed_palettes=pals)
    k_net, k_env, k_roll = jax.random.split(jax.random.PRNGKey(0), 3)
    net, params, tx, _ = jppo.init_state(jep, jcfg, k_net)
    rollout_only = jppo.make_train_step(jep, jcfg, net, tx, overlap=True)[1]
    js0 = jppo.init_env_batch(jep, B, k_env, stagger=True)
    js1, (jtraj, jlast), jkey = jax.tree.map(
        np.asarray, rollout_only(params, js0, k_roll))

    ep = EnvParams.from_dict(jep.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(jcfg))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    tnet = ActorCritic(cfg, ep.view_size, device="cpu")
    tnet.load_state_dict(load_flax_params(jax.tree.map(np.asarray, params)))
    ts0 = ppo.init_env_batch(ep, B, _t(k_env), stagger=True, device="cpu")
    got0 = state_to_numpy(ts0)
    for f in FIELDS:
        np.testing.assert_array_equal(got0[f], np.asarray(getattr(js0, f)))

    rollout = ppo.make_rollout(ep, cfg, tnet, device="cpu")
    ts1, key, traj, last = rollout(ts0, _t(k_roll))

    assert traj["obs"].dtype == torch.uint8
    assert traj["obs"].shape == (T, 4, 147, B)
    for k in ("obs", "act", "done", "ep_len", "ep_cyc", "rew", "ep_ret"):
        assert traj[k].numpy().dtype == jtraj[k].dtype, k
        np.testing.assert_array_equal(traj[k].numpy(), jtraj[k], err_msg=k)
    for k in ("logp", "val"):
        np.testing.assert_allclose(traj[k].numpy(), jtraj[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(last.numpy(), jlast, rtol=1e-5, atol=1e-5)
    got1 = state_to_numpy(ts1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f], np.asarray(getattr(js1, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(rng.fold_in(key, 1).numpy(), jkey)
    assert jtraj["done"].any() and (jtraj["rew"] != 0).any()


def test_ppo_config_round_trip():
    jcfg = jppo.PPOConfig(n_envs=64, hidden=48, board_pool=8,
                          embed_palettes=((0, 1), (0, 7), (0, 1, 2, 3)))
    d = jppo.ppo_config_to_dict(jcfg)
    cfg = ppo.ppo_config_from_dict(d)
    assert ppo.ppo_config_to_dict(cfg) == d
    assert ppo.ppo_config_to_dict(ppo.PPOConfig()) == \
        jppo.ppo_config_to_dict(jppo.PPOConfig())
    assert ppo.PPOConfig().dtype == torch.bfloat16
