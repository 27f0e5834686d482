"""The port's explicit-collective train step
(``ppo.make_train_step_shard_map``) on two gloo ranks against the JAX
package's ``make_train_step_shard_map`` on a 2-device mesh, on the CPU.

Both start from the same weights (the flax ones through
``load_flax_params``; on the port, rank 0's, broadcast to a rank that drew
others) and keys, float32, in two cases:

- ``no_resets``, the JAX package's shard-count equivalence case
  (``tests/test_shard_map.py``): cluttered 9x9, 2 agents, B = 16, T = 4,
  max_steps 100, no stagger, 1 epoch x 1 minibatch;
- ``resets``: empty 9x9, max_steps 10 with the stagger, B = 32, T = 8,
  2 epochs x 2 minibatches: each rank's own fresh-board pool and its
  shuffle of its own blocks show.

After one step the env state gathered from the ranks and the key are
bit-equal to JAX's, the first minibatch's all-reduced, clipped gradients
and the metrics match within ``test_torch_ppo.py``'s bounds (rtol 1e-4 /
1e-5), and so do the weights. Then, where no env resets, the port's D = 2
after two steps against its D = 1 at the JAX test's tolerance (weights
rtol 2e-4, atol 2e-5; loss rtol 2e-3). The recurrent step is in
``test_torch_shard_map_rnn.py``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_rnn as jppo_rnn
from marlgrid_tpu.parallel.mesh import make_mesh as jmake_mesh
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           default_agent_colors)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import mesh as mesh_mod
from marlgrid_tpu_torch.parallel import ppo, ppo_rnn
from test_torch_ppo import METRICS, _record_first_grad, _t
import torch_dist_worker

#: name -> (EnvParams fields, PPOConfig fields, stagger, port steps)
CASES = {
    "no_resets": (dict(scenario="cluttered", n_clutter=6, max_steps=100),
                  dict(n_envs=16, rollout_len=4, n_epochs=1,
                       n_minibatches=1), False, 2),
    "resets": (dict(scenario="empty", max_steps=10),
               dict(n_envs=32, rollout_len=8, n_epochs=2, n_minibatches=2),
               True, 1),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_case(name, rnn="", **extra):
    """The JAX configuration of case ``name``, its initial weights and keys:
    a dict for :func:`jax_step` and :func:`port_run`."""
    ep_kw, cfg_kw, stagger, steps = CASES[name]
    jep = JEnvParams(width=9, height=9, n_agents=2, view_size=5,
                     observation_style="encode",
                     agent_colors=default_agent_colors(2), **ep_kw)
    jcfg = jppo.PPOConfig(dtype=jnp.float32, rnn=rnn, **cfg_kw, **extra)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    if rnn:
        net, params, _, _, h = jppo_rnn.init_state_rnn(jep, jcfg, k_net)
    else:
        (net, params, _, _), h = jppo.init_state(jep, jcfg, k_net), None
    return dict(jep=jep, jcfg=jcfg, net=net, params0=_np(params), h0=h,
                k_env=k_env, k_step=k_step, stagger=stagger, steps=steps)


def jax_step(c, devices):
    """One JAX shard_map step of case ``c`` on a 2-device 'data' mesh,
    with the first minibatch's clipped gradient kept by an optax stage."""
    jcfg = c["jcfg"]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    mesh = jmake_mesh(n_data=2, n_model=1, devices=devices[:2])
    env0 = jppo.init_env_batch(c["jep"], jcfg.n_envs, c["k_env"],
                               stagger=c["stagger"])
    params = jax.tree.map(jnp.asarray, c["params0"])
    if jcfg.rnn:
        step = jppo_rnn.make_train_step_rnn_shard_map(c["jep"], jcfg,
                                                      c["net"], tx, mesh)
        p1, o1, env1, h1, key1, m = _np(step(params, tx.init(params), env0,
                                             c["h0"], c["k_step"]))
    else:
        step = jppo.make_train_step_shard_map(c["jep"], jcfg, c["net"], tx,
                                              mesh)
        (p1, o1, env1, key1, m), h1 = _np(step(params, tx.init(params), env0,
                                               c["k_step"])), None
    return dict(params1=p1, grad0=o1[1]["g"], env1=env1, h1=h1, key1=key1,
                metrics={k: float(v) for k, v in m.items()})


def port_run(c, **over):
    """The worker's description of the port's run of case ``c``."""
    return dict(dict(ep=c["jep"].to_dict(),
                     cfg=jppo.ppo_config_to_dict(c["jcfg"]),
                     state_dict=load_flax_params(c["params0"]),
                     env_key=_t(c["k_env"]), key=_t(c["k_step"]),
                     stagger=c["stagger"], steps=c["steps"]), **over)


def port_d1(c):
    """The port's D = 1 run of case ``c`` in this process (no process
    group: identity collectives), :func:`port_run`'s steps: the weights
    and the metrics after the last."""
    ep = EnvParams.from_dict(c["jep"].to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(c["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    mesh = mesh_mod.make_mesh(device="cpu")
    if cfg.rnn:
        net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, device="cpu")
        step = ppo_rnn.make_train_step_rnn_shard_map(ep, cfg, net, opt, mesh,
                                                     device="cpu")
    else:
        (net, opt), h = ppo.init_state(ep, cfg, device="cpu"), None
        step = ppo.make_train_step_shard_map(ep, cfg, net, opt, mesh,
                                             device="cpu")
    net.load_state_dict(load_flax_params(c["params0"]))
    env = ppo.init_env_batch(ep, cfg.n_envs, _t(c["k_env"]),
                             stagger=c["stagger"], device="cpu", mesh=mesh)
    key = _t(c["k_step"])
    for _ in range(c["steps"]):
        if h is None:
            env, key, m = step(env, key)
        else:
            env, h, key, m = step(env, h, key)
    return net.state_dict(), {k: float(v) for k, v in m.items()}


def check_against_jax(j, ranks, rnn=False):
    """Rank 0's first step against JAX's (see the module docstring); rank
    1's weights, gradients and metrics equal rank 0's, bit for bit."""
    r0 = ranks[0]
    s = r0["snaps"][0]
    for f in FIELDS:
        np.testing.assert_array_equal(s["env"][f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(s["key"].numpy(), j["key1"])
    want_g = load_flax_params(j["grad0"])
    for name, g in r0["grad0"].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(s["metrics"][k], j["metrics"][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # Adam's first step moves a weight by +-lr whatever the size of its
    # gradient: compare where JAX's first gradient is above 1e-6
    want_p = load_flax_params(j["params1"])
    for name, p in s["weights"].items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    if rnn:
        np.testing.assert_allclose(s["h"].numpy(), j["h1"], rtol=0,
                                   atol=1e-5)
    for a, b in zip(r0["snaps"], ranks[1]["snaps"]):
        assert a["metrics"] == b["metrics"]
        for name, w in a["weights"].items():
            assert torch.equal(w, b["weights"][name]), name
    for name, g in r0["grad0"].items():
        assert torch.equal(g, ranks[1]["grad0"][name]), name


def check_d2_against_d1(ranks, d1):
    """The JAX test's shard-count bound: D = 2 against D = 1 after the
    same steps, where no env resets."""
    weights, metrics = d1
    last = ranks[0]["snaps"][-1]
    for name, w in last["weights"].items():
        np.testing.assert_allclose(w.numpy(), weights[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert np.isfinite(last["metrics"]["loss"])
    np.testing.assert_allclose(last["metrics"]["loss"], metrics["loss"],
                               rtol=2e-3, atol=1e-4)


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    """The port's two-rank runs of both cases (one pair of processes,
    started first), JAX's step of each while they run, and the port's
    D = 1 run of the no-reset case."""
    cases = {name: jax_case(name) for name in CASES}
    with torch_dist_worker.start(
            tmp_path_factory.mktemp("shard_map"), "train",
            dict(runs=[port_run(c) for c in cases.values()])) as wait:
        jax_out = {name: jax_step(c, devices8) for name, c in cases.items()}
        d1 = port_d1(cases["no_resets"])
        ranks = wait()
    return dict(jax=jax_out, d1=d1, ranks={
        name: [r[i] for r in ranks] for i, name in enumerate(CASES)})


@pytest.mark.parametrize("case", list(CASES))
def test_shard_map_step_matches_jax(results, case):
    check_against_jax(results["jax"][case], results["ranks"][case])
    ranks = results["ranks"][case]
    # per minibatch: the advantage mean, its variance, the gradients with
    # the loss and aux metrics; per step: the episode tallies
    _, cfg_kw, _, steps = CASES[case]
    per_step = 3 * cfg_kw["n_epochs"] * cfg_kw["n_minibatches"] + 1
    assert ranks[0]["all_reduces"] == steps * per_step
    if case == "resets":
        assert results["jax"][case]["metrics"]["n_episodes"] > 0


def test_shard_map_two_ranks_match_one(results):
    check_d2_against_d1(results["ranks"]["no_resets"], results["d1"])


def test_shard_map_rank_key_plumbing():
    """What differs from the unsharded step even at D = 1, as in JAX: the
    fresh-board key folded with the rank, per-env action keys; and the
    refusals (overlap; a batch that does not split over the ranks)."""
    ep = EnvParams(width=9, height=9, n_agents=2, scenario="empty",
                   max_steps=10, view_size=5, observation_style="encode",
                   agent_colors=default_agent_colors(2))
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, hidden=16,
                        dtype=torch.float32)
    mesh = mesh_mod.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="--overlap"):
        ppo.make_train_step(ep, cfg, None, None, device="cpu", overlap=True,
                            axis=mesh)
    with pytest.raises(AssertionError):     # 8 envs over 3 ranks
        ppo.make_train_step_shard_map(
            ep, cfg, None, None, SimpleNamespace(D=3, rank=0, group=None),
            device="cpu")
    outs = []
    for shard in (False, True):
        net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        key = rng.PRNGKey(0, device="cpu")
        env = ppo.init_env_batch(ep, 8, rng.fold_in(key, 1), device="cpu")
        roll = ppo.make_rollout(ep, cfg, net, device="cpu",
                                axis=mesh if shard else None)
        outs.append(roll(env, key)[2]["act"])
    assert not torch.equal(*outs)
