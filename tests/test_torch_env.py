"""The port's batched env engine against the JAX engine, on the parity
ladder of tests/test_parity.py at B = 8: reset, step, the autoreset
variants and the stagger. Every field is bit-equal to the jitted JAX
function, the float32 reward fields (rew, prestige, accum_reward,
last_reward) included: the port rounds the reward decay and the prestige
update once, as XLA's fused multiply-adds do (core/step.py::fma_f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import grid_gen as jgrid, step as jstep
from marlgrid_tpu_torch.core import grid_gen, rng, step as step_mod
from marlgrid_tpu_torch.core.state import (FIELDS, EnvParams,
                                           state_from_numpy, state_to_numpy)
from marlgrid_tpu_torch.vector import VectorEnv
from test_parity import LADDER

B = 8


def _t(key):
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def assert_state_equal(jstate, tstate, where=""):
    got = state_to_numpy(tstate)
    for f in FIELDS:
        want = np.asarray(getattr(jstate, f))
        assert got[f].dtype == want.dtype, (where, f)
        np.testing.assert_array_equal(got[f], want, err_msg=f"{where} {f}")


def _ported(p):
    """The ladder's JAX EnvParams as the port's (same fields)."""
    return EnvParams.from_dict(p.to_dict())


@pytest.mark.parametrize("jparams", LADDER)
def test_reset_and_trajectory(jparams):
    """Batched reset, then max_steps + 2 steps of numpy-seeded actions
    (through the done step and past it), each step's state, rew and done
    against ``jax.vmap(step.step)``."""
    params = _ported(jparams)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    js = jax.jit(jax.vmap(lambda k: jgrid.reset(jparams, k)))(keys)
    ts = grid_gen.reset(params, _t(keys))
    assert_state_equal(js, ts, "reset")
    acts = np.random.default_rng(5).integers(
        0, 7, size=(jparams.max_steps + 2, B, jparams.n_agents),
        dtype=np.int32)

    @jax.jit
    def run(s, acts):
        def body(s, a):
            s2, r, d = jax.vmap(lambda ss, aa: jstep.step(jparams, ss, aa))(
                s, a)
            return s2, (s2, r, d)
        return jax.lax.scan(body, s, acts)[1]

    jtraj, jrew, jdone = jax.tree.map(np.asarray, run(js, jnp.asarray(acts)))
    for t in range(acts.shape[0]):
        ts, rew, done = step_mod.step(params, ts, torch.as_tensor(acts[t]))
        assert_state_equal(jax.tree.map(lambda x: x[t], jtraj), ts, f"t={t}")
        np.testing.assert_array_equal(rew.numpy(), jrew[t])
        np.testing.assert_array_equal(done.numpy(), jdone[t])
    assert jdone[-1].all()


def test_params_dict_round_trip():
    for p in LADDER:
        jp = p.values[0]
        assert _ported(jp).to_dict() == jp.to_dict()
        assert EnvParams.from_dict(_ported(jp).to_dict()) == _ported(jp)


def test_select_tie_rule():
    """Several valid candidate draws: the first valid try wins; with none
    valid, the first free cell in y-major order."""
    params = EnvParams(width=6, height=5, n_agents=1)
    free = torch.zeros((3, 30), dtype=torch.bool)
    free[0, [2 * 5 + 3, 4 * 5 + 1, 1 * 5 + 2]] = True   # all three drawn
    free[1, [3 * 5 + 4, 4 * 5 + 2]] = True              # none drawn
    xs = torch.tensor([[3, 2, 4, 1], [1, 1, 1, 1], [1, 2, 3, 4]],
                      dtype=torch.int32)
    ys = torch.tensor([[1, 3, 1, 2], [1, 1, 1, 1], [1, 1, 1, 1]],
                      dtype=torch.int32)
    x, y, ok = grid_gen.select_from_mask(params, free, xs, ys)
    assert x.tolist() == [2, 4, 0] and y.tolist() == [3, 2, 0]
    assert ok.tolist() == [True, True, False]


@pytest.mark.parametrize("jparams", [LADDER[4], LADDER[5]])  # goal_cycle,
def test_autoreset_variants(jparams):                          # respawn
    """step_autoreset_batch, step_autoreset_with_fresh (one given board,
    env_offset), step_autoreset_with_fresh_batch (pool K=4, the port's
    ``fresh_pool`` rows against JAX's tiled and rotated pool, env_offset,
    salt) and stagger_step_counts over a run long enough for every env to
    finish at least once."""
    params = _ported(jparams)
    jkeys = jax.random.split(jax.random.PRNGKey(2), B)
    fk = jax.random.PRNGKey(9)

    @jax.jit
    def jinit(jkeys, fk):
        s = jax.vmap(lambda k: jgrid.reset(jparams, k))(jkeys)
        return (jstep.stagger_step_counts(s, jparams.max_steps),
                jstep.fresh_pool_tiled(jparams, fk, 4, B))

    js0, jfresh = jinit(jkeys, fk)
    ts0 = step_mod.stagger_step_counts(grid_gen.reset(params, _t(jkeys)),
                                       params.max_steps)
    assert_state_equal(js0, ts0, "stagger")
    tpool = step_mod.fresh_pool(params, _t(fk), 4)
    assert_state_equal(jfresh, step_mod.fresh_pool_rows(tpool, 0, 0, B),
                       "pool")
    acts = np.random.default_rng(1).integers(
        0, 7, size=(jparams.max_steps + 2, B, jparams.n_agents),
        dtype=np.int32)

    jone = jax.tree.map(lambda x: x[1], jfresh)       # one given board
    tone = tpool.map(lambda x: x[1:2])

    @jax.jit
    def jall(s1, s2, s3, a, t):
        return (jstep.step_autoreset_batch(jparams, s1, a),
                jstep.step_autoreset_with_fresh_batch(
                    jparams, s2, a, jstep.rotate_fresh_batch(jfresh, t),
                    env_offset=16, salt=t),
                jstep.step_autoreset_with_fresh(jparams, s3, a, jone,
                                                env_offset=3))

    j1 = j2 = j3 = js0
    t1 = t2 = t3 = ts0
    finished = np.zeros(B, bool)
    for t in range(acts.shape[0]):
        (j1, *jr1), (j2, *jr2), (j3, *jr3) = jall(
            j1, j2, j3, jnp.asarray(acts[t]), t)
        a = torch.as_tensor(acts[t])
        t1, *tr1 = step_mod.step_autoreset_batch(params, t1, a)
        t2, *tr2 = step_mod.step_autoreset_with_fresh_batch(
            params, t2, a, step_mod.fresh_pool_rows(tpool, t, 0, B),
            env_offset=16, salt=t)
        t3, *tr3 = step_mod.step_autoreset_with_fresh(params, t3, a, tone,
                                                      env_offset=3)
        for k, (js_, ts_, jr, tr) in enumerate(((j1, t1, jr1, tr1),
                                                (j2, t2, jr2, tr2),
                                                (j3, t3, jr3, tr3))):
            assert_state_equal(js_, ts_, f"variant {k} t={t}")
            (jrew, jdone, jinfo), (rew, done, info) = jr, tr
            np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
            np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
            for name in ("episode_length", "episode_cycles"):
                np.testing.assert_array_equal(info[name].numpy(),
                                              np.asarray(jinfo[name]))
            np.testing.assert_array_equal(info["episode_return"].numpy(),
                                          np.asarray(jinfo["episode_return"]))
        finished |= done.numpy()
    assert finished.all()


def test_vector_env_and_state_round_trip():
    jparams = LADDER[2].values[0]
    params = _ported(jparams)
    env = VectorEnv(params, B, device="cpu")
    state, obs = env.reset(rng.PRNGKey(4, device="cpu"))
    js = jax.jit(jax.vmap(lambda k: jgrid.reset(jparams, k)))(
        jax.random.split(jax.random.PRNGKey(4), B))
    assert_state_equal(js, state, "VectorEnv.reset")
    assert obs.shape == (B, 3, 7, 7, 3) and obs.dtype == torch.int32
    back = state_from_numpy(state_to_numpy(state), "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    acts = np.random.default_rng(0).integers(0, 7, (B, 3), dtype=np.int32)
    state2, obs2, rew, done, info = env.step(state, torch.as_tensor(acts))
    js2, jr, jd, _ = jax.jit(
        lambda s, a: jstep.step_autoreset_batch(jparams, s, a))(
            js, jnp.asarray(acts))
    assert_state_equal(js2, state2, "VectorEnv.step")


@pytest.mark.parametrize("K,D", [(4, 2), (32, 2), (16, 4)],
                         ids=["K-divides-share", "K-over-share",
                              "K-over-share-4"])
def test_fresh_pool_rows_of_a_rank(K, D):
    """A rank's rows of the global fresh pool (``fresh_pool`` +
    ``fresh_pool_rows``) are bit-equal to the same rows of JAX's
    ``rotate_fresh_batch(fresh_pool_tiled(..., K, B), t)`` over the global
    batch B = 32, at every rank of D and several t, whether K divides a
    rank's B / D envs or exceeds them."""
    jparams = LADDER[-1].values[0]
    params = _ported(jparams)
    Bg, fk = 32, jax.random.PRNGKey(5)
    jtiled = jax.jit(lambda k: jstep.fresh_pool_tiled(jparams, k, K, Bg))(fk)
    pool = step_mod.fresh_pool(params, _t(fk), K)
    assert pool.batch_size == K
    B = Bg // D
    for t in (0, 1, 7, 40):
        jrot = jstep.rotate_fresh_batch(jtiled, t)
        for r in range(D):
            assert_state_equal(
                jax.tree.map(lambda x: x[r * B:(r + 1) * B], jrot),
                step_mod.fresh_pool_rows(pool, t, r * B, B), f"t={t} r={r}")
