"""The port's all-encode heterogeneous PPO
(``marlgrid_tpu_torch/parallel/ppo_hetero.py``) against the JAX package's
``make_train_step_hetero``, on the CPU.

One train step on goal_cycle 13x13 with 4 agents in two view-size groups
(7, 5, 7, 5: the perf gate's population), B = 16, T = 8, hidden 32,
float32, the full vocabularies (the CLI turns the palettes off for hetero
runs) and 2 epochs x 4 minibatches, from the same weights (the flax list
through ``load_flax_params``) and key: each group's first-minibatch
gradients, every metric, the updated weights, the env state and the key,
with ``test_torch_ppo.py``'s tolerances. Also the row alignment at lr = 0
and the paths that exit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_hetero as jhet
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo, ppo_hetero
from test_torch_ppo import METRICS, _record_first_grad, _t

B, T = 16, 8
GOAL_CYCLE = JEnvParams(width=13, height=13, n_agents=4,
                        scenario="goal_cycle", max_steps=12,
                        reward_decay=False, agent_colors=(0, 4, 5, 1),
                        observation_style="encode",
                        agent_view_sizes=(7, 5, 7, 5))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_hetero_step(jep, jcfg, init, make, carry=False, record=None,
                    last=None):
    """One JAX hetero train step (``init``/``make`` a module's pair) with
    the first minibatch's clipped gradients recorded (or what the optax
    stage ``record`` keeps), under Adam (or the optax stage ``last``), and
    what went in."""
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    made = init(jep, jcfg, k_net)
    nets, params = made[0], _np(made[1])
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     record or _record_first_grad(),
                     last or optax.adam(jcfg.lr))
    env0 = jppo.init_env_batch(jep, B, k_env, stagger=True)
    step = make(jep, jcfg, nets, tx)
    args = (jax.tree.map(jnp.asarray, params), tx.init(params), env0)
    if carry:
        args += (made[4],)
    out = _np(step(*args, k_step))
    j = dict(jcfg=jcfg, params0=params, k_env=k_env, k_step=k_step,
             params1=out[0], grad0=out[1][1]["g"], env1=out[2],
             key1=out[-2], metrics={k: float(v) for k, v in out[-1].items()})
    if carry:
        j["h1"] = out[3]
    return j


def port_config(jep, jcfg):
    """The port's EnvParams and float32 PPOConfig for the JAX ones."""
    ep = EnvParams.from_dict(jep.to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(jcfg))
    return ep, ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})


def record_first_grads(nets, opt):
    """The first Adam step's gradients (after the clip), per group."""
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        [{n: p.grad.clone() for n, p in net.named_parameters()}
         for net in nets]) if not grads else None)
    return grads


def check_step(j, nets, opt, grads, m, env1, key1):
    """Each group's first gradients (rtol 1e-4, atol 1e-6: two float32
    stacks summing in other orders), the metrics (1e-5), the weights where
    JAX's first gradient is above 1e-6 (1e-4: Adam's first step moves a
    weight by about lr whatever the size of its gradient, so a gradient at
    float32 noise may take the other sign), the env state and the key."""
    want_g = load_flax_params(j["grad0"])
    want_p = load_flax_params(j["params1"])
    assert len(grads) == 1 and len(want_g) == len(nets)
    steps = j["jcfg"].n_epochs * j["jcfg"].n_minibatches
    assert opt.state[nets[0].pi.weight]["step"] == steps
    for g, net in enumerate(nets):
        for name, grad in grads[0][g].items():
            np.testing.assert_allclose(grad.numpy(), want_g[g][name].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"group {g} {name}")
        for name, p in net.state_dict().items():
            sure = want_g[g][name].abs() > 1e-6
            assert sure.any(), name
            np.testing.assert_allclose(p[sure].numpy(),
                                       want_p[g][name][sure].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"group {g} {name}")
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), j["metrics"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert j["metrics"]["n_episodes"] > 0
    got1 = state_to_numpy(env1)
    for f in FIELDS:
        np.testing.assert_array_equal(got1[f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(key1.numpy(), j["key1"])


@pytest.fixture(scope="module")
def jax_step():
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32)
    return jax_hetero_step(GOAL_CYCLE, jcfg, jhet.init_state_hetero,
                           jhet.make_train_step_hetero)


def test_train_step_matches_jax(jax_step):
    j = jax_step
    ep, cfg = port_config(GOAL_CYCLE, j["jcfg"])
    nets, opt = ppo_hetero.init_state_hetero(ep, cfg, device="cpu")
    assert [n.torso0.w0.shape[0] for n in nets] == [49 * 12, 25 * 12]
    for net, sd in zip(nets, load_flax_params(j["params0"])):
        net.load_state_dict(sd)
    grads = record_first_grads(nets, opt)
    step = ppo_hetero.make_train_step_hetero(ep, cfg, nets, opt,
                                             device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, key1, m = step(env0, _t(j["k_step"]))
    check_step(j, nets, opt, grads, m, env1, key1)


def test_alignment_at_lr0_and_exits():
    """At lr = 0 the update's log-probs, recomputed per group from the
    stored feature-major blocks, equal the rollout's (|ratio - 1| ~ 0) and
    no weight moves; a non-encode group and too few blocks exit."""
    ep = EnvParams.from_dict(GOAL_CYCLE.to_dict())
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1, n_minibatches=2,
                        lr=0.0, hidden=16, dtype=torch.float32)
    nets, opt = ppo_hetero.init_state_hetero(
        ep, cfg, torch.Generator().manual_seed(1), device="cpu")
    before = [{k: v.clone() for k, v in n.state_dict().items()} for n in nets]
    key = rng.PRNGKey(1, device="cpu")
    env = ppo.init_env_batch(ep, 8, rng.fold_in(key, 1), device="cpu")
    step = ppo_hetero.make_train_step_hetero(ep, cfg, nets, opt,
                                             device="cpu")
    _, _, m = step(env, key)
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    for n, b in zip(nets, before):
        for k, v in n.state_dict().items():
            assert torch.equal(v, b[k]), k
    with pytest.raises(SystemExit, match="'encode' obs groups only"):
        ppo_hetero.hetero_groups(ep.replace(
            agent_obs_styles=("encode", "image", "encode", "encode")))
    with pytest.raises(SystemExit, match="fewer than --minibatches 64"):
        ppo_hetero.make_update_hetero(ep, ppo.PPOConfig(
            n_envs=8, rollout_len=4, n_minibatches=64), nets, opt,
            device="cpu")
