"""Recurrent PPO of the port (``marlgrid_tpu_torch/parallel/ppo_rnn.py``
and the recurrent family of ``models/actor_critic.py``) against the JAX
package, on the CPU.

The gate-fused cells and the mlp ``RecurrentActorCritic`` against flax
with the same weights (the pixels torso is in
``test_torch_ppo_rnn_image.py``); one GRU encode train step on goal_cycle
13x13 with 4 agents, B = 16, T = 8, hidden 32, float32, the compact embed
palettes and 2 epochs x 4 minibatches against JAX's ``make_train_step_rnn``
from the same weights and key (the first minibatch's gradients, every
metric, the weights, the carry, the env state and the key). The rest of
``tests/test_ppo_rnn.py``'s checks are in ``test_torch_ppo_rnn.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.models import RecurrentActorCritic as JRecurrent
from marlgrid_tpu.models.actor_critic import (FusedGRUCell as JGRU,
                                              FusedLSTMCell as JLSTM)
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_rnn as jppo_rnn
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import (FusedGRUCell, FusedLSTMCell,
                                       RecurrentActorCritic,
                                       load_flax_params)
from marlgrid_tpu_torch.parallel import ppo, ppo_rnn
from test_torch_ppo import METRICS, _record_first_grad, _t

B, T = 16, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_fused_cells_match_flax(kind):
    """The port's cells, loaded with a flax cell's weights (``i`` kernel and
    bias, ``h`` kernel, the GRU's ``hn_bias``), give the flax cell's new
    carry and output at float32."""
    H, M, D = 16, 8, 24
    rs = np.random.default_rng(0)
    x = rs.normal(size=(M, D)).astype(np.float32)
    h = rs.normal(size=(M, H)).astype(np.float32)
    c = rs.normal(size=(M, H)).astype(np.float32)
    jcell = (JGRU if kind == "gru" else JLSTM)(H, dtype=jnp.float32)
    carry = jnp.asarray(h) if kind == "gru" else (jnp.asarray(c),
                                                  jnp.asarray(h))
    params = jcell.init(jax.random.PRNGKey(1), carry, jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)   # nonzero biases
    jcarry, jy = jcell.apply(params, carry, jnp.asarray(x))
    p = _np(params)["params"]
    cell = (FusedGRUCell if kind == "gru" else FusedLSTMCell)(
        D, H, torch.float32)
    sd = {k[len("cell."):]: v for k, v in load_flax_params(
        {"cell": p, "torso": {"kernel": np.zeros((1, 1)), "bias": [0]},
         "pi": {"kernel": np.zeros((1, 1)), "bias": [0]},
         "v": {"kernel": np.zeros((1, 1)), "bias": [0]},
         "torso0": {k: np.zeros(1) for k in ("w0", "w1", "w2", "bias")}}
    ).items() if k.startswith("cell.")}
    cell.load_state_dict(sd)
    tcarry = torch.as_tensor(h) if kind == "gru" else (torch.as_tensor(c),
                                                       torch.as_tensor(h))
    with torch.no_grad():
        new, y = cell(tcarry, torch.as_tensor(x))
    for a, b in zip(jax.tree.leaves(jcarry) + [jy],
                    (list(new) if kind == "lstm" else [new]) + [y]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


GOAL_CYCLE = JEnvParams(width=13, height=13, n_agents=4,
                        scenario="goal_cycle", max_steps=12,
                        reward_decay=False, agent_colors=(0, 4, 5, 1),
                        observation_style="encode")
PALETTES = jobs.encode_palettes(GOAL_CYCLE)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_recurrent_actor_critic_matches_flax(kind):
    check_recurrent_vs_flax(kind, "mlp")


def check_recurrent_vs_flax(kind, torso):
    """One timestep of the port's RecurrentActorCritic, loaded through
    ``load_flax_params``, against the flax model at float32: logits,
    values and the new carry (mlp: feature-major codes with the palettes;
    cnn_s2d: s2d POVs with three 'rich' extras)."""
    mlp = torso == "mlp"
    jcfg = jppo.PPOConfig(hidden=32, dtype=jnp.float32, rnn=kind,
                          torso=torso,
                          embed_palettes=PALETTES if mlp else None)
    jnet = JRecurrent(jcfg)
    rs = np.random.default_rng(2)
    N, S = 2, 12
    if mlp:
        obs = np.concatenate([rs.choice(np.asarray(v), size=(N, 49, S))
                              for v in PALETTES], axis=1).astype(np.uint8)
        kw, tkw, aux = dict(feature_major=True), {}, 0
        lead = (N, S)
    else:
        obs = rs.integers(0, 256, (S, N, 14, 14, 48)).astype(np.uint8)
        aux = rs.normal(size=(S, N, 3)).astype(np.float32)
        kw, tkw = dict(aux=jnp.asarray(aux)), dict(aux=torch.as_tensor(aux))
        lead = (S, N)
    carry0 = jax.tree.map(
        lambda z: jnp.asarray(rs.normal(size=z.shape), jnp.float32),
        jnet.initial_carry(lead))
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs), carry0, **kw)
    jl, jv, jc = jnet.apply(params, jnp.asarray(obs), carry0, **kw)
    cfg = ppo.PPOConfig(hidden=32, dtype=torch.float32, rnn=kind,
                        torso=torso, embed_palettes=PALETTES if mlp else None)
    net = RecurrentActorCritic(cfg, 7, device="cpu",
                               aux_dim=0 if mlp else 3)
    net.load_state_dict(load_flax_params(_np(params)))
    carry = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), carry0)
    with torch.no_grad():
        logits, value, new = net(torch.as_tensor(obs), carry, **tkw)
    assert logits.shape == lead + (7,) and value.shape == lead
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
            new, is_leaf=torch.is_tensor)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    z = net.initial_carry((3, 4))
    if kind == "lstm":
        assert z[0].shape == (3, 4, 32) and z[0] is not z[1]
    else:
        assert z.shape == (3, 4, 32) and z.dtype == torch.float32


@pytest.fixture(scope="module")
def jax_step():
    """One JAX recurrent train step (compiled once for the module) and what
    went in."""
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32, rnn="gru",
                          embed_palettes=PALETTES)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    net, params, _, _, h = jppo_rnn.init_state_rnn(GOAL_CYCLE, jcfg, k_net)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    params = _np(params)
    env0 = jppo.init_env_batch(GOAL_CYCLE, B, k_env, stagger=True)
    step = jppo_rnn.make_train_step_rnn(GOAL_CYCLE, jcfg, net, tx)
    p1, o1, env1, h1, key1, m = _np(step(
        jax.tree.map(jnp.asarray, params), tx.init(params), env0, h, k_step))
    return dict(jcfg=jcfg, params0=params, k_env=k_env, k_step=k_step,
                params1=p1, grad0=o1[1]["g"], env1=env1, h1=h1, key1=key1,
                metrics={k: float(v) for k, v in m.items()})


def test_train_step_matches_jax(jax_step):
    j = jax_step
    ep = EnvParams.from_dict(GOAL_CYCLE.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(j["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, device="cpu")
    assert not net.torso0.plane_major
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
    # Adam's first step moves a weight by +-lr whatever the size of its
    # gradient: compare where JAX's first gradient is above 1e-6
    want_p = load_flax_params(j["params1"])
    for name, p in net.state_dict().items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert h1.shape == (4, B, 32)
    np.testing.assert_allclose(h1.numpy(), j["h1"], rtol=0, atol=1e-5)
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])
