"""The port's all-encode hetero trainer on the sharded default path
(``ppo_hetero.make_train_step_hetero(mesh=...)``) on two gloo ranks against
the JAX package's GSPMD ``make_train_step_hetero(mesh=make_mesh(n_data=2,
n_model=1, ...))`` on two virtual CPU devices, on the CPU.

Both start from the same weights (the flax list through
``load_flax_params``; on the port, rank 0's, broadcast to a rank that drew
others) and keys, float32. The case: goal_cycle 9x9 with max_steps 6 and
the stagger, three agents in two view-size groups (5, 3, 5), B = 16, T = 6,
hidden 16, 2 epochs x 2 minibatches. Envs reset inside the rollout, the
fresh-board pool (K = 16) is larger than a rank's 8 envs, and the 3-agent
group's minibatch share is 6 blocks of 16 envs while the 1-agent group's
is 3, which two ranks split as 1 and 2 (the first padded with a block at
weight 0).

The bars: after one step the env state gathered from the ranks and the
key are bit-equal to JAX's; the first minibatch's all-reduced, clipped
gradients (rtol 1e-4, atol 1e-6), the metrics (rtol 1e-5, atol 1e-5) and
the weights where JAX's first gradient is above 1e-6 (atol 1e-4) are
within ``test_torch_ppo.py``'s bounds, and rank 1's equal rank 0's bit for
bit. Each loss call of a rank sees ``ceil(mb_g / 2)`` blocks of each
group's share mb_g; a step makes one all-gather and ``3 * minibatches +
1`` all-reduces. Then the port's D = 2 after two steps against its D = 1:
env state and key bit-equal, weights within rtol 2e-4, atol 2e-5, loss
within rtol 2e-3.

``test_torch_gspmd_hetero_rnn.py`` and ``test_torch_gspmd_hetero_mixed.py``
hold the other two hetero trainers so, with this file's helpers.
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
from marlgrid_tpu.parallel import ppo_hetero as jhet
from marlgrid_tpu.parallel.mesh import make_mesh as jmake_mesh
from marlgrid_tpu_torch.core.state import EnvParams, FIELDS
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import mesh as mesh_mod
from marlgrid_tpu_torch.parallel import ppo
from marlgrid_tpu_torch.parallel import train as train_mod
from test_torch_gspmd import check_d2_against_d1_with_resets
from test_torch_ppo import METRICS, _record_first_grad, _t
from test_torch_shard_map import _np
import torch_dist_worker

VIEWS = JEnvParams(width=9, height=9, n_agents=3, scenario="goal_cycle",
                   max_steps=6, reward_decay=False, agent_colors=(0, 4, 5),
                   observation_style="encode", agent_view_sizes=(5, 3, 5))
CFG = dict(n_envs=16, rollout_len=6, hidden=16, n_epochs=2, n_minibatches=2)


def flat(state_dicts):
    """A list of per-group state_dicts as one ModuleList state_dict."""
    return {f"{g}.{k}": v for g, sd in enumerate(state_dicts)
            for k, v in sd.items()}


def make_case(jep, cfg_kw, init, make, steps=2):
    """The JAX configuration of a case, its step factory ``make``, its
    initial weights, carry and keys."""
    jcfg = jppo.PPOConfig(dtype=jnp.float32, **cfg_kw)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(0), 3)
    made = init(jep, jcfg, k_net)
    return dict(jep=jep, jcfg=jcfg, make=make, nets=made[0],
                params0=_np(made[1]), h0=made[4] if len(made) > 4 else None,
                k_env=k_env, k_step=k_step, steps=steps)


def jax_mesh_step(c, devices):
    """One JAX GSPMD hetero step of case ``c`` on a 2-device 'data' mesh,
    with the first minibatch's clipped gradients kept by an optax
    stage."""
    jcfg, jep = c["jcfg"], c["jep"]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    mesh = jmake_mesh(n_data=2, n_model=1, devices=devices[:2])
    env0 = jppo.init_env_batch(jep, jcfg.n_envs, c["k_env"], mesh,
                               stagger=True)
    params = jax.tree.map(jnp.asarray, c["params0"])
    step = c["make"](jep, jcfg, c["nets"], tx, mesh=mesh)
    args = (params, tx.init(params), env0)
    if c["h0"] is not None:
        args += (c["h0"],)
    out = _np(step(*args, c["k_step"]))
    return dict(params1=out[0], grad0=out[1][1]["g"], env1=out[2],
                h1=out[3] if c["h0"] is not None else None, key1=out[-2],
                metrics={k: float(v) for k, v in out[-1].items()})


def port_run(c):
    """The worker's description of the port's mesh run of case ``c``."""
    return dict(ep=c["jep"].to_dict(),
                cfg=jppo.ppo_config_to_dict(c["jcfg"]),
                state_dict=flat(load_flax_params(c["params0"])),
                env_key=_t(c["k_env"]), key=_t(c["k_step"]), stagger=True,
                steps=c["steps"], path="mesh")


def port_d1(c):
    """The port's D = 1 mesh run of case ``c`` in this process (no process
    group: the collectives return their inputs): the weights, the metrics,
    the env state, the key and the carry after its steps."""
    dev = torch.device("cpu")
    ep = EnvParams.from_dict(c["jep"].to_dict())
    cfg = ppo.ppo_config_from_dict(jppo.ppo_config_to_dict(c["jcfg"]))
    cfg = ppo.PPOConfig(**{**cfg.__dict__, "dtype": torch.float32})
    mesh = mesh_mod.make_mesh(device=dev)
    nets, opt, h = train_mod.init(ep, cfg, None, dev)
    nets.load_state_dict(flat(load_flax_params(c["params0"])))
    step = train_mod.make_step(ep, cfg, nets, opt, dev, mesh=mesh)
    env = ppo.init_env_batch(ep, cfg.n_envs, _t(c["k_env"]), device=dev,
                             mesh=mesh)
    key = _t(c["k_step"])
    for _ in range(c["steps"]):
        if h is None:
            env, key, m = step(env, key)
        else:
            env, h, key, m = step(env, h, key)
    return (nets.state_dict(), {k: float(v) for k, v in m.items()},
            {f: getattr(env, f).numpy() for f in FIELDS}, key, h)


def run_case(tmp, devices, c):
    """The port's two-rank mesh run of case ``c`` (started first), JAX's
    GSPMD step while it runs, and the port's D = 1 run."""
    with torch_dist_worker.start(tmp, "train",
                                 dict(runs=[port_run(c)])) as wait:
        j = jax_mesh_step(c, devices)
        d1 = port_d1(c)
        ranks = [r[0] for r in wait()]
    return dict(jax=j, d1=d1, ranks=ranks)


def check_against_jax(j, ranks):
    """Rank 0's first step against JAX's, and rank 1 against rank 0 (see
    the module docstring)."""
    r0 = ranks[0]
    s = r0["snaps"][0]
    for f in FIELDS:
        np.testing.assert_array_equal(s["env"][f],
                                      np.asarray(getattr(j["env1"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(s["key"].numpy(), j["key1"])
    want_g = flat(load_flax_params(j["grad0"]))
    assert set(r0["grad0"]) == set(want_g)
    for name, g in r0["grad0"].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(s["metrics"][k], j["metrics"][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert j["metrics"]["n_episodes"] > 0
    # Adam's first step moves a weight by +-lr whatever the size of its
    # gradient: compare where JAX's first gradient is above 1e-6
    want_p = flat(load_flax_params(j["params1"]))
    for name, p in s["weights"].items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    if j["h1"] is not None:
        for g, hg in s["h"].items():
            np.testing.assert_allclose(hg.numpy(), j["h1"][g], rtol=0,
                                       atol=1e-5, err_msg=f"carry {g}")
    for a, b in zip(r0["snaps"], ranks[1]["snaps"]):
        assert a["metrics"] == b["metrics"]
        for name, w in a["weights"].items():
            assert torch.equal(w, b["weights"][name]), name
    for name, g in r0["grad0"].items():
        assert torch.equal(g, ranks[1]["grad0"][name]), name


def check_shares(ranks, c, group_mbs, per_block):
    """Each loss call of each rank saw ``ceil(mb_g / 2)`` blocks of each
    group's minibatch share ``mb_g`` (``per_block[g]`` samples a block),
    one of them odd, so the ranks split it unevenly; one all-gather and
    ``3 * minibatches + 1`` all-reduces a step."""
    cfg = c["jcfg"]
    calls = cfg.n_epochs * cfg.n_minibatches
    assert any(mb % 2 for mb in group_mbs)
    want = tuple(math.ceil(mb / 2) * n for mb, n in zip(group_mbs, per_block))
    for r in ranks:
        assert r["loss_samples"] == [want] * (calls * c["steps"])
        assert r["all_gathers"] == c["steps"]
        assert r["all_reduces"] == c["steps"] * (3 * calls + 1)


def check_d2_against_d1(ranks, d1):
    """D = 2 against D = 1 after the same steps, resets included (and the
    carries, on the recurrent trainer, within 1e-5)."""
    weights, metrics, env, key, h = d1
    check_d2_against_d1_with_resets(ranks, (weights, metrics, env, key))
    if h is not None:
        for g, hg in ranks[0]["snaps"][-1]["h"].items():
            np.testing.assert_allclose(hg.numpy(), h[g].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"carry {g}")


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    c = make_case(VIEWS, CFG, jhet.init_state_hetero,
                  jhet.make_train_step_hetero)
    return dict(run_case(tmp_path_factory.mktemp("gspmd_hetero"), devices8,
                         c), case=c)


def test_gspmd_hetero_step_matches_jax(results):
    check_against_jax(results["jax"], results["ranks"])


def test_gspmd_hetero_odd_shares(results):
    # c = 16 (one env chunk): G_g = n_g * T blocks, halved by 2 minibatches
    check_shares(results["ranks"], results["case"], (6, 3), (16, 16))


def test_gspmd_hetero_two_ranks_match_one(results):
    check_d2_against_d1(results["ranks"], results["d1"])
