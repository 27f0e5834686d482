"""The port's sharded default path (``ppo.make_train_step(mesh=...)``) on
two gloo ranks against the JAX package's GSPMD step,
``make_train_step(mesh=make_mesh(n_data=2, n_model=1, ...))`` on two
virtual CPU devices, on the CPU.

Both start from the same weights (the flax ones through
``load_flax_params``; on the port, rank 0's, broadcast to a rank that drew
others) and keys, float32, in the feedforward cases of :data:`CASES`:

- ``resets``: encode obs, the mlp torso's feature-major store, empty 9x9
  with max_steps 10 and the stagger, B = 32, T = 8, 2 epochs x 2
  minibatches: envs reset inside the rollout, and the fresh-board pool
  (K = 32) is larger than a rank's 16 envs;
- ``odd_minibatch``: B = 16, T = 6, 4 minibatches of 3 blocks, which two
  ranks split as 1 and 2 (the first padded with a block at weight 0);
- ``overlap``: ``overlap=True`` (the update takes the priming rollout's
  trajectory);

and, in ``test_torch_gspmd_stores.py``, the row and EnvState stores.

After one step the env state gathered from the ranks and the key are
bit-equal to JAX's; the first minibatch's all-reduced, clipped gradients,
the metrics and the weights are within ``test_torch_ppo.py``'s bounds
(rtol 1e-4 / 1e-5). Each loss call of a rank sees ``ceil(mb / 2)`` blocks
of the minibatch's mb, not mb. Then, with resets, the port's D = 2 after
two steps against its D = 1: env state and key bit-equal, weights within
rtol 2e-4, atol 2e-5, loss within rtol 2e-3.
"""
import math

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
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           default_agent_colors)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import mesh as mesh_mod
from marlgrid_tpu_torch.parallel import ppo, ppo_rnn
from test_torch_ppo import _record_first_grad, _t
from test_torch_shard_map import (_np, check_against_jax,
                                  check_d2_against_d1)
import torch_dist_worker

RESETS = dict(scenario="empty", max_steps=10)

#: name -> (EnvParams fields, PPOConfig fields, options, (blocks per
#: minibatch, samples per block)); options: ``overlap``, ``steps`` (the
#: port's), ``stagger`` (default True)
CASES = {
    "resets": (RESETS, dict(n_envs=32, rollout_len=8, n_epochs=2,
                            n_minibatches=2), dict(steps=2), (8, 32)),
    "odd_minibatch": (RESETS, dict(n_envs=16, rollout_len=6, n_epochs=1,
                                   n_minibatches=4), {}, (3, 16)),
    "overlap": (RESETS, dict(n_envs=16, rollout_len=8, n_epochs=1,
                             n_minibatches=2), dict(overlap=True), (8, 16)),
}


def make_case(ep_kw, cfg_kw, opts):
    """The JAX configuration of a case, its initial weights and keys: a dict
    for :func:`jax_mesh_step`, :func:`port_run` and :func:`port_d1`."""
    ep_kw = dict(dict(width=9, height=9, view_size=5,
                      observation_style="encode"), **ep_kw)
    jep = JEnvParams(n_agents=2, agent_colors=default_agent_colors(2),
                     **ep_kw)
    jcfg = jppo.PPOConfig(dtype=jnp.float32, **cfg_kw)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    if jcfg.rnn:
        net, params, _, _, h = jppo_rnn.init_state_rnn(jep, jcfg, k_net)
    else:
        (net, params, _, _), h = jppo.init_state(jep, jcfg, k_net), None
    return dict(jep=jep, jcfg=jcfg, net=net, params0=_np(params), h0=h,
                k_env=k_env, k_step=k_step,
                stagger=opts.get("stagger", True),
                overlap=opts.get("overlap", False),
                steps=opts.get("steps", 1))


def jax_mesh_step(c, devices):
    """One JAX GSPMD step of case ``c`` on a 2-device 'data' mesh (the env
    batch sharded over it), with the first minibatch's clipped gradient
    kept by an optax stage."""
    jcfg, jep = c["jcfg"], c["jep"]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    mesh = jmake_mesh(n_data=2, n_model=1, devices=devices[:2])
    env0 = jppo.init_env_batch(jep, jcfg.n_envs, c["k_env"], mesh,
                               stagger=c["stagger"])
    params = jax.tree.map(jnp.asarray, c["params0"])
    opt0 = tx.init(params)
    h1 = None
    if jcfg.rnn:
        step = jppo_rnn.make_train_step_rnn(jep, jcfg, c["net"], tx,
                                            mesh=mesh)
        p1, o1, env1, h1, key1, m = _np(step(params, opt0, env0, c["h0"],
                                             c["k_step"]))
    elif c["overlap"]:
        step, prime = jppo.make_train_step(jep, jcfg, c["net"], tx,
                                           mesh=mesh, overlap=True)
        env, prev, key = prime(params, env0, c["k_step"])
        p1, o1, env1, _, key1, m = _np(step(params, opt0, env, prev, key))
    else:
        step = jppo.make_train_step(jep, jcfg, c["net"], tx, mesh=mesh)
        p1, o1, env1, key1, m = _np(step(params, opt0, env0, c["k_step"]))
    return dict(params1=p1, grad0=o1[1]["g"], env1=env1, h1=h1, key1=key1,
                metrics={k: float(v) for k, v in m.items()})


def port_run(c, **over):
    """The worker's description of the port's mesh run of case ``c``."""
    return dict(dict(ep=c["jep"].to_dict(),
                     cfg=jppo.ppo_config_to_dict(c["jcfg"]),
                     state_dict=load_flax_params(c["params0"]),
                     env_key=_t(c["k_env"]), key=_t(c["k_step"]),
                     stagger=c["stagger"], steps=c["steps"], path="mesh",
                     overlap=c["overlap"]), **over)


def port_d1(c):
    """The port's D = 1 mesh run of case ``c`` in this process (no process
    group: the collectives return their inputs), :func:`port_run`'s steps:
    the weights, the metrics, the env state and the key after the last."""
    ep = EnvParams.from_dict(c["jep"].to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(c["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    mesh = mesh_mod.make_mesh(device="cpu")
    if cfg.rnn:
        net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, device="cpu")
        step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cpu",
                                           mesh=mesh)
    else:
        (net, opt), h = ppo.init_state(ep, cfg, device="cpu"), None
        step = ppo.make_train_step(ep, cfg, net, opt, device="cpu",
                                   mesh=mesh)
    net.load_state_dict(load_flax_params(c["params0"]))
    env = ppo.init_env_batch(ep, cfg.n_envs, _t(c["k_env"]),
                             stagger=c["stagger"], device="cpu", mesh=mesh)
    key = _t(c["k_step"])
    for _ in range(c["steps"]):
        if h is None:
            env, key, m = step(env, key)
        else:
            env, h, key, m = step(env, h, key)
    return (net.state_dict(), {k: float(v) for k, v in m.items()},
            {f: getattr(env, f).numpy() for f in FIELDS}, key)


def check_d2_against_d1_with_resets(ranks, d1):
    """D = 2 against D = 1 after the same steps, resets included: the JAX
    test's weight and loss bounds, and the env state and key bit-equal."""
    weights, metrics, env, key = d1
    check_d2_against_d1(ranks, (weights, metrics))
    last = ranks[0]["snaps"][-1]
    assert last["metrics"]["n_episodes"] > 0
    for f in FIELDS:
        np.testing.assert_array_equal(last["env"][f], env[f], err_msg=f)
    assert torch.equal(last["key"], key)


def check_shares(ranks, case_spec, n_ranks=2):
    """Each loss call of each rank saw its share of a minibatch's blocks,
    ``ceil(mb / D)`` of them, never the whole minibatch; one all-gather
    and ``3 * minibatches + 1`` all-reduces a step."""
    _, cfg_kw, opts, (mb, per_block) = case_spec
    calls = cfg_kw["n_epochs"] * cfg_kw["n_minibatches"]
    steps = opts.get("steps", 1)
    want = math.ceil(mb / n_ranks) * per_block
    for r in ranks:
        assert r["loss_samples"] == [want] * (calls * steps)
        assert want < mb * per_block
        assert r["all_gathers"] == steps
        assert r["all_reduces"] == steps * (3 * calls + 1)


def run_cases(tmp, devices, cases, d1_case=None):
    """The port's two-rank mesh runs of ``cases`` (one pair of processes,
    started first), JAX's GSPMD step of each while they run, and the
    port's D = 1 run of ``d1_case``."""
    made = {name: make_case(*spec[:3]) for name, spec in cases.items()}
    with torch_dist_worker.start(
            tmp, "train",
            dict(runs=[port_run(c) for c in made.values()])) as wait:
        jax_out = {name: jax_mesh_step(c, devices)
                   for name, c in made.items()}
        d1 = port_d1(made[d1_case]) if d1_case else None
        ranks = wait()
    return dict(jax=jax_out, d1=d1, ranks={
        name: [r[i] for r in ranks] for i, name in enumerate(cases)})


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    return run_cases(tmp_path_factory.mktemp("gspmd"), devices8, CASES,
                     "resets")


@pytest.mark.parametrize("case", list(CASES))
def test_gspmd_step_matches_jax(results, case):
    check_against_jax(results["jax"][case], results["ranks"][case])
    check_shares(results["ranks"][case], CASES[case])
    assert results["jax"][case]["metrics"]["n_episodes"] > 0


def test_gspmd_two_ranks_match_one_with_resets(results):
    check_d2_against_d1_with_resets(results["ranks"]["resets"],
                                    results["d1"])


def test_gspmd_refuses_axis_and_mesh():
    """``axis=`` (shard_map) and ``mesh=`` select two paths: not both."""
    ep = EnvParams(width=9, height=9, n_agents=2, view_size=5,
                   observation_style="encode",
                   agent_colors=default_agent_colors(2))
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, hidden=16)
    mesh = mesh_mod.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="exclude each other"):
        ppo.make_train_step(ep, cfg, None, None, device="cpu", axis=mesh,
                            mesh=mesh)
    with pytest.raises(ValueError, match="exclude each other"):
        ppo_rnn.make_train_step_rnn(ep, ppo.PPOConfig(rnn="gru"), None,
                                    None, device="cpu", axis=mesh, mesh=mesh)
