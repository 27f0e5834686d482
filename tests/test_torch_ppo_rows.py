"""The port's row-major trajectory store (``parallel/ppo.py``, the JAX row
store of ``make_train_step``) against the JAX package, on the CPU: encode
observations with the 'cnn' torso.

Empty 9x9 with 2 agents, 7x7 views, B = 8, T = 4, hidden 16, channels
(4, 8), float32 and 2 epochs x 4 minibatches, from the same weights and
keys. One JAX compile: the overlap step (``make_train_step(...,
overlap=True)``), fed as its previous trajectory the port's own first
rollout, runs JAX's rollout and JAX's update of that trajectory in one
call, and the port's overlap step does both on the same inputs. Held
bit-equal: the uint8 trajectory obs, the actions, rewards, dones and
episode tallies, the env state and the key. Within float32 tolerance:
logp and values (1e-5, two conv stacks summing in other orders), the
first minibatch's gradients (rtol 1e-4, atol 1e-6), every metric (1e-5)
and the updated weights (1e-4 where the first gradient is above 1e-6),
the bars of ``test_torch_ppo.py``. Also the row-block count, its remainder
warning and the refusals.
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
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo
from test_torch_ppo import METRICS, _record_first_grad, _t

B, T = 8, 4
TRAJ_EXACT = ("obs", "act", "rew", "done", "ep_ret", "ep_len", "ep_cyc")


def run_pair(jep, jcfg):
    """The port's and JAX's overlap steps from one start: the port's
    priming rollout, then one step of each on it. Returns (JAX outputs,
    port outputs, the port's first-minibatch gradients, its net)."""
    k_net, k_env, k_prime, k_step = jax.random.split(jax.random.PRNGKey(0),
                                                     4)
    net_j, params, _, _ = jppo.init_state(jep, jcfg, k_net)
    params = jax.tree.map(np.asarray, params)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))

    ep = EnvParams.from_dict(jep.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(jcfg))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    net, opt = ppo.init_state(ep, cfg, device="cpu")
    net.load_state_dict(load_flax_params(params))
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in net.named_parameters()})
        if not grads else None)
    step, prime = ppo.make_train_step(ep, cfg, net, opt, device="cpu",
                                      overlap=True)
    env0 = ppo.init_env_batch(ep, B, _t(k_env), stagger=True, device="cpu")
    env_p, prev, _ = prime(env0, _t(k_prime))
    traj_p, last_p = prev
    # JAX's overlap step on the same state and previous trajectory
    js = JEnvState(**{f: jnp.asarray(v)
                      for f, v in state_to_numpy(env_p).items()})
    jprev = ({k: jnp.asarray(v.numpy()) for k, v in traj_p.items()},
             jnp.asarray(last_p.numpy()))
    jstep = jppo.make_train_step(jep, jcfg, net_j, tx, overlap=True)[0]
    p1, o1, env1, (traj, last), key1, m = jax.tree.map(np.asarray, jstep(
        jax.tree.map(jnp.asarray, params), tx.init(params), js, jprev,
        k_step))
    want = dict(params1=p1, grad0=o1[1]["g"], env1=env1, traj=traj,
                last=last, key1=key1,
                metrics={k: float(v) for k, v in m.items()})
    env1_p, (traj1_p, last1_p), key1_p, m_p = step(
        env_p, (traj_p, last_p), _t(k_step))
    got = dict(env1=env1_p, traj=traj1_p, last=last1_p, key1=key1_p,
               metrics=m_p, prime_traj=traj_p)
    return want, got, grads, net


def check_pair(want, got, grads, net):
    """The bars of the module docstring."""
    traj, jtraj = got["traj"], want["traj"]
    assert traj["obs"].dtype == torch.uint8
    assert got["prime_traj"]["obs"].shape == traj["obs"].shape
    for k in TRAJ_EXACT:
        assert traj[k].numpy().dtype == jtraj[k].dtype, k
        np.testing.assert_array_equal(traj[k].numpy(), jtraj[k], err_msg=k)
    for k in ("logp", "val"):
        np.testing.assert_allclose(traj[k].numpy(), jtraj[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["last"].numpy(), want["last"], rtol=1e-5,
                               atol=1e-5)
    assert jtraj["done"].any()
    got1 = state_to_numpy(got["env1"])
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(want["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got["key1"].numpy(), want["key1"])

    want_g = load_flax_params(want["grad0"])
    assert len(grads) == 1
    for name, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(got["metrics"][k]),
                                   want["metrics"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    want_p = load_flax_params(want["params1"])
    for name, p in net.state_dict().items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def encode_cnn():
    jep = JEnvParams(width=9, height=9, n_agents=2, scenario="empty",
                     max_steps=6, observation_style="encode",
                     agent_colors=(0, 4))
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=16,
                          channels=(4, 8), board_pool=4, torso="cnn",
                          dtype=jnp.float32)
    return run_pair(jep, jcfg)


def test_encode_cnn_train_step_matches_jax(encode_cnn):
    want, got, grads, net = encode_cnn
    # the row store: (T, B*N, 3*vs*vs) uint8 codes, (T, B, N) labels
    assert got["traj"]["obs"].shape == (T, B * 2, 147)
    assert got["traj"]["act"].shape == (T, B, 2)
    assert net.Conv_1.weight.shape == (8, 4, 3, 3)
    check_pair(want, got, grads, net)


def test_row_blocks():
    """G: the largest power of two <= 8192 dividing T*B*N, or single rows
    when that is fewer than the minibatches (the JAX rule)."""
    assert ppo.row_blocks(64 * 4096 * 4, 4) == 8192
    assert ppo.row_blocks(4 * 8 * 2, 4) == 64
    assert ppo.row_blocks(3 * 5, 4) == 15       # G = 1 < 4: single rows
    assert ppo.row_blocks(12, 4) == 4


def test_row_remainder_warns():
    """15 rows in 4 minibatches: 3 rows dropped per epoch, with the JAX
    warning; the step still trains."""
    ep = EnvParams(width=7, height=7, n_agents=1, scenario="empty",
                   max_steps=5, view_size=3, observation_style="encode",
                   agent_colors=(0,))
    cfg = ppo.PPOConfig(n_envs=5, rollout_len=3, hidden=8, channels=(4,),
                        torso="cnn", board_pool=5, dtype=torch.float32)
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    env = ppo.init_env_batch(ep, 5, rng.fold_in(key, 1), device="cpu")
    step = ppo.make_train_step(ep, cfg, net, opt, device="cpu")
    with pytest.warns(UserWarning, match="dropping 3 block"):
        _, _, m = step(env, key)
    assert np.isfinite(float(m["loss"]))


def test_storage_paths():
    """Which store each configuration takes, and the refusals, as the JAX
    step's asserts."""
    enc = EnvParams(width=9, height=9, n_agents=2, scenario="empty",
                    observation_style="encode", agent_colors=(0, 4))
    img = enc.replace(observation_style="image")
    rich = enc.replace(observation_style="rich", observe_rewards=True)
    cases = [(enc, dict(torso="mlp"), ppo.FEATURES),
             (enc, dict(torso="cnn"), ppo.ROWS),
             (enc, dict(torso="cnn_s2d"), ppo.ROWS),
             (enc, dict(torso="cnn_image"), ppo.ROWS),
             (img, dict(torso="cnn_s2d"), ppo.STATES),
             (img, dict(torso="cnn_s2d", recompute_image_obs=False),
              ppo.ROWS),
             (rich, dict(torso="cnn_image"), ppo.STATES)]
    for ep, kw, want in cases:
        assert ppo.storage(ep, ppo.PPOConfig(**kw)) == want, kw
    with pytest.raises(ValueError, match="recompute_image_obs=True"):
        ppo.storage(rich, ppo.PPOConfig(torso="cnn_s2d",
                                        recompute_image_obs=False))
    with pytest.raises(ValueError, match="cnn_s2d or cnn_image"):
        ppo.storage(img, ppo.PPOConfig(torso="cnn"))
