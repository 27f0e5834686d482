"""The port's ``VectorEnv`` against the JAX package's: per-env resets
(``core/step.py::step_autoreset``, ``independent_resets=True``),
``example_actions`` and ``rollout_fn``, bit for bit over episode
boundaries, on the CPU (where ``rollout_fn`` runs eagerly; on the card it
is one CUDA graph, held against the eager run by ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import grid_gen as jgrid, step as jstep
from marlgrid_tpu.core.state import EnvParams as JParams, default_agent_colors
from marlgrid_tpu.vector import VectorEnv as JVectorEnv
from marlgrid_tpu_torch.core import grid_gen, rng, step as step_mod
from marlgrid_tpu_torch.core.state import FIELDS, EnvParams, state_to_numpy
from marlgrid_tpu_torch.vector import VectorEnv

B = 8

JP = JParams(width=9, height=9, n_agents=2, scenario="cluttered",
             n_clutter=6, max_steps=6, view_size=5,
             observation_style="encode", agent_colors=default_agent_colors(2))
#: a hetero population: a 5x5 encode group and a 3x3 image group
JP_HETERO = JParams(width=9, height=9, n_agents=3, scenario="goal_cycle",
                    n_clutter=4, max_steps=5, view_size=5,
                    observation_style="encode",
                    agent_view_sizes=(5, 3, 5),
                    agent_obs_styles=("encode", "image", "encode"),
                    agent_colors=default_agent_colors(3))


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def assert_tree_equal(jt, tt, where):
    if isinstance(jt, dict):
        assert set(jt) == set(tt), where
        for k in jt:
            assert_tree_equal(jt[k], tt[k], f"{where}[{k}]")
        return
    want = np.asarray(jt)
    got = tt.numpy()
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=where)


def assert_state_equal(js, ts, where):
    got = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f"{where} {f}")


def test_step_autoreset_bit_equal():
    """``step_autoreset`` against ``jax.vmap(step.step_autoreset)``: state,
    rew, done and info over T steps that cross every env's episode end."""
    params = EnvParams.from_dict(JP.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    acts = np.random.default_rng(3).integers(0, 7, (3 * JP.max_steps, B, 2),
                                             dtype=np.int32)
    js = jax.jit(jax.vmap(lambda k: jgrid.reset(JP, k)))(keys)
    jstep_fn = jax.jit(jax.vmap(lambda s, a: jstep.step_autoreset(JP, s, a)))
    ts = grid_gen.reset(params, _t(keys))
    finished = np.zeros(B, int)
    for t in range(acts.shape[0]):
        js, jr, jd, ji = jstep_fn(js, jnp.asarray(acts[t]))
        ts, rew, done, info = step_mod.step_autoreset(
            params, ts, torch.as_tensor(acts[t]))
        assert_state_equal(js, ts, f"t={t}")
        assert_tree_equal(jr, rew, f"rew t={t}")
        assert_tree_equal(jd, done, f"done t={t}")
        assert_tree_equal(ji, info, f"info t={t}")
        finished += done.numpy()
    assert (finished >= 2).all()


@pytest.mark.parametrize("jparams", [JP, JP_HETERO],
                         ids=["encode", "hetero"])
def test_vector_env_independent_resets(jparams):
    """``VectorEnv(independent_resets=True)``: reset and steps (state, obs,
    rew, done, info) against the JAX VectorEnv's."""
    params = EnvParams.from_dict(jparams.to_dict())
    jenv = JVectorEnv(jparams, B, independent_resets=True)
    env = VectorEnv(params, B, independent_resets=True, device="cpu")
    js, jobs = jenv.reset(jax.random.PRNGKey(5))
    ts, obs = env.reset(rng.PRNGKey(5, device="cpu"))
    assert_state_equal(js, ts, "reset")
    assert_tree_equal(jobs, obs, "obs reset")
    acts = np.random.default_rng(5).integers(
        0, 7, (jparams.max_steps + 2, B, jparams.n_agents),
        dtype=np.int32)
    for t in range(acts.shape[0]):
        js, jobs, jr, jd, ji = jenv.step(js, jnp.asarray(acts[t]))
        ts, obs, rew, done, info = env.step(ts, torch.as_tensor(acts[t]))
        assert_state_equal(js, ts, f"t={t}")
        assert_tree_equal(
            dict(obs=jobs, rew=jr, done=jd, info=ji),
            dict(obs=obs, rew=rew, done=done, info=info), f"t={t}")


@pytest.mark.parametrize("independent", [False, True],
                         ids=["shared-board", "independent"])
@pytest.mark.parametrize("jparams", [JP, JP_HETERO],
                         ids=["encode", "hetero"])
def test_rollout_fn_bit_equal(jparams, independent):
    """``rollout_fn`` with a seeded random policy (``rng.randint`` against
    ``jax.random.randint`` on the step's key): the final state and the
    trajectory (obs, actions, rew, done on a leading T axis), bit-equal to
    the JAX ``rollout_fn``'s, in both reset modes."""
    params = EnvParams.from_dict(jparams.to_dict())
    T, N = jparams.max_steps + 2, jparams.n_agents
    jenv = JVectorEnv(jparams, B, independent_resets=independent)
    env = VectorEnv(params, B, independent_resets=independent, device="cpu")

    def jpolicy(_, obs, key):
        return jax.random.randint(key, (B, N), 0, 7)

    def policy(obs, key):
        return rng.randint(key, (B, N), 0, 7).to(torch.int32)

    js, _ = jenv.reset(jax.random.PRNGKey(7))
    ts, _ = env.reset(rng.PRNGKey(7, device="cpu"))
    jfn = jenv.rollout_fn(jpolicy, T)
    js, jtraj = jfn(None, js, jax.random.PRNGKey(8))
    fn = env.rollout_fn(policy, T)
    ts, traj = fn(ts, rng.PRNGKey(8, device="cpu"))
    assert_state_equal(js, ts, "final state")
    assert_tree_equal(jtraj, traj, "traj")
    assert traj["done"].shape == (T, B) and traj["done"].any()
    # a second call continues from the returned state
    js, jtraj = jfn(None, js, jax.random.PRNGKey(9))
    ts, traj = fn(ts, rng.PRNGKey(9, device="cpu"))
    assert_state_equal(js, ts, "second call")
    assert_tree_equal(jtraj, traj, "second traj")


def test_example_actions():
    params = EnvParams.from_dict(JP.to_dict())
    env = VectorEnv(params, B, device="cpu")
    a = env.example_actions
    assert a.shape == (B, 2) and a.dtype == torch.int32
    assert a.device.type == "cpu" and not a.any()
    want = JVectorEnv(JP, B).example_actions
    assert a.shape == want.shape and str(want.dtype) == "int32"
