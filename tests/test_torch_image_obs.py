"""The port's 'image' observations against the JAX package, on the CPU:
``all_obs_image_b`` bit-equal to JAX's fallback (``force_xla=True``) and to
its sprite kernel in interpret mode, across the four builtin scenarios of
``tests/test_sprite_kernel.py`` after random steps with prestige spread over
every level, in the standard, ``bminor`` and s2d layouts, with hidden types
and a view offset, with an observer subset on a shared painted board; K3's
plain version against JAX's ``compose_image_b(interpret=True)`` on the same
ids; the prestige levels and the level-painted board; and ``VectorEnv``'s
image and rich observations against JAX's ``VectorEnv``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu import rendering as jrendering
from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import EnvState as JEnvState
from marlgrid_tpu.core.state import default_agent_colors
from marlgrid_tpu.ops import sprite as jsprite
from marlgrid_tpu.vector import VectorEnv as JVectorEnv
from marlgrid_tpu_torch.core import grid_gen, obs as obs_mod, rng
from marlgrid_tpu_torch.core import step as step_mod
from marlgrid_tpu_torch.core.state import EnvParams, state_to_numpy
from marlgrid_tpu_torch.ops import sprite
from marlgrid_tpu_torch.vector import VectorEnv

B = 8

# tests/test_sprite_kernel.py's builtin scenarios, plus a doorkey with a
# hidden type (keys) and a view offset
CONFIGS = {
    "empty": dict(width=9, height=9, n_agents=1, scenario="empty",
                  view_size=5),
    "cluttered": dict(width=15, height=15, n_agents=3, scenario="cluttered",
                      n_clutter=25),
    "doorkey": dict(width=11, height=11, n_agents=2, scenario="doorkey"),
    "goal_cycle": dict(width=13, height=13, n_agents=4,
                       scenario="goal_cycle", n_bonus_tiles=3),
    "doorkey-hidden-offset": dict(width=11, height=11, n_agents=2,
                                  scenario="doorkey", view_offset=1,
                                  hide_item_types=(4,)),
}


def _jparams(cfg):
    return JEnvParams(observation_style="image", max_steps=100,
                      agent_colors=default_agent_colors(cfg["n_agents"]),
                      **cfg)


def _states(params, seed=3, n_steps=6):
    """Port states after random steps (doors and pickups; reset and step
    are bit-equal to JAX, test_torch_env.py), with prestige spread over
    every level (the scale is 2 and there are 8 levels)."""
    s = grid_gen.reset(params, rng.split(rng.PRNGKey(seed, device="cpu"), B))
    rs = np.random.default_rng(seed)
    for a in torch.as_tensor(rs.integers(0, 7, (n_steps, B,
                                                params.n_agents))):
        s = step_mod.step(params, s, a)[0]
    lvl = rs.permutation(B * params.n_agents) % 8
    s.prestige = torch.as_tensor(
        (2 * lvl + rs.uniform(0, 2, lvl.shape)).astype(np.float32)
        .reshape(B, params.n_agents))
    return s


def _jstate(ts):
    return JEnvState(**{f: jnp.asarray(v)
                        for f, v in state_to_numpy(ts).items()})


def _luts(jparams):
    T = jparams.view_tile_size
    return (jnp.asarray(jrendering.base_lut(T)),
            jnp.asarray(jrendering.agent_lut(T)))


LAYOUTS = (dict(), dict(bminor=True), dict(s2d=True),
           dict(bminor=True, s2d=True))


def _jax_images(jparams, js):
    """JAX's fallback render in every layout and its Pallas kernel
    (interpret mode) in the standard and the bminor s2d layouts, from one
    jitted program."""
    luts = _luts(jparams)

    @jax.jit
    def run(s):
        out = [jobs.all_obs_image_b(jparams, s, *luts, force_xla=True, **kw)
               for kw in LAYOUTS]
        out += [jobs.all_obs_image_b(jparams, s, *luts, sprite_interpret=True,
                                     **kw) for kw in (LAYOUTS[0], LAYOUTS[3])]
        return out

    return [np.asarray(x) for x in run(js)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_all_obs_image_b_matches_jax(name):
    jparams = _jparams(CONFIGS[name])
    params = EnvParams.from_dict(jparams.to_dict())
    ts = _states(params)
    assert len(set(obs_mod.prestige_level(params, ts.prestige)
                   .flatten().tolist())) == min(8, B * params.n_agents)
    want = _jax_images(jparams, _jstate(ts))
    got = [obs_mod.all_obs_image_b(params, ts, **kw) for kw in LAYOUTS]
    for kw, w, g in zip(LAYOUTS, want, got):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(kw))
    # the TPU kernel itself, in interpret mode
    np.testing.assert_array_equal(got[0].numpy(), want[4])
    np.testing.assert_array_equal(
        obs_mod.all_agent_obs_b(params, ts, bminor=True, s2d=True).numpy(),
        want[5])


def test_observer_subset_on_a_shared_board():
    """Observers 1 and 3 of goal_cycle render against one board painted
    with the prestige levels: JAX's result, and the full render's columns."""
    jparams = _jparams(CONFIGS["goal_cycle"])
    params = EnvParams.from_dict(jparams.to_dict())
    ts = _states(params, seed=5)
    js = _jstate(ts)
    obs_ids = (1, 3)
    packed = obs_mod.pack_grid_with_agents(params, ts, with_lvl=True)
    luts = _luts(jparams)

    @jax.jit
    def run(s):
        jpacked = jobs.pack_grid_with_agents(jparams, s, with_lvl=True)
        return jpacked, jobs.all_obs_image_b(jparams, s, *luts,
                                             force_xla=True,
                                             observers=obs_ids,
                                             packed=jpacked)

    jpacked, want = run(js)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpacked).astype(np.int32))
    got = obs_mod.all_obs_image_b(params, ts, observers=obs_ids,
                                  packed=packed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), obs_mod.all_obs_image_b(params, ts)[:, list(obs_ids)])


def _jax_ids(jparams, js):
    """The ids JAX's ``all_obs_image_b`` hands its sprite kernel."""
    vt, vc, vst, any_agent, acolor, reldir, alvl = jobs.all_view_cells_b(
        jparams, js, with_dim=True)
    base_id = jobs.base_appearance(*jobs.apply_hidden(jparams, vt, vc, vst))
    agent_id = jnp.where(any_agent, 1 + acolor * 4 + reldir, 0)
    vis = jobs.process_vis_b(jobs.transparency_b(vt, vst),
                             jparams.view_size, jparams.view_offset)
    return (jnp.where(vis, base_id, jobs.N_BASE_APPEAR),
            jnp.where(vis, agent_id, 0), alvl)


def test_compose_plain_matches_jax_kernel():
    """K3's plain version and JAX's Pallas kernel (interpret mode) on the
    same ids, in the three layouts."""
    jparams = _jparams(CONFIGS["goal_cycle"])
    params = EnvParams.from_dict(jparams.to_dict())
    js = _jstate(_states(params, seed=7))
    layouts = (dict(), dict(nb_layout=True), dict(s2d=True))

    @jax.jit
    def run(s):
        ids = _jax_ids(jparams, s)
        return ids, [jsprite.compose_image_b(jparams, *ids, interpret=True,
                                             **kw) for kw in layouts]

    ids, want = run(js)
    tids = [torch.as_tensor(np.asarray(a).astype(np.int32)) for a in ids]
    assert int(tids[0].max()) == obs_mod.N_BASE_APPEAR
    for kw, w in zip(layouts, want):
        got = sprite.compose_image_b(params, *tids, **kw)
        assert sprite.compose_image_b.launches == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                      err_msg=str(kw))


def test_compose_checks_its_inputs():
    params = EnvParams(view_size=5, view_tile_size=6, n_agents=1,
                       observation_style="image")
    ids = torch.zeros((1, 5, 5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="s2d"):
        sprite.compose_image_b(params, ids, ids, ids, s2d=True)
    with pytest.raises(ValueError, match=r"\(N, 5, 5, B\)"):
        sprite.compose_image_b(params, ids, ids, ids[..., :1])
    img = sprite.compose_image_b(params, ids, ids, ids)
    assert img.shape == (2, 1, 30, 30, 3) and not img.any()


@pytest.mark.parametrize("prestige", [0.0, 1.99, 2.0, 5.5, 13.9, 14.0, 99.0,
                                      -3.0])
def test_prestige_level_matches_jax(prestige):
    jparams = JEnvParams(n_agents=2, agent_colors=(0, 4),
                         agent_prestige_scales=(2.0, 0.7))
    params = EnvParams.from_dict(jparams.to_dict())
    p = np.full((3, 2), prestige, np.float32)
    np.testing.assert_array_equal(
        obs_mod.prestige_level(params, torch.as_tensor(p)).numpy(),
        np.asarray(jobs.prestige_level(jparams, jnp.asarray(p))))


def test_vector_env_matches_jax():
    """Rich observations (the image pov plus every observe_* field) over a
    few autoreset steps; the port's image-style env gives the same pov."""
    jparams = JEnvParams(width=9, height=9, n_agents=2, scenario="doorkey",
                         max_steps=5, observation_style="rich",
                         observe_rewards=True, observe_position=True,
                         observe_orientation=True, agent_colors=(0, 4))
    params = EnvParams.from_dict(jparams.to_dict())
    jenv = JVectorEnv(jparams, n_envs=4)
    env = VectorEnv(params, n_envs=4, device="cpu")
    image_env = VectorEnv(params.replace(observation_style="image"),
                          n_envs=4, device="cpu")
    key = jax.random.PRNGKey(2)
    js, jo = jenv.reset(key)
    ts, to = env.reset(torch.as_tensor(np.asarray(key).astype(np.int64)))
    acts = np.random.default_rng(0).integers(0, 7, (7, 4, 2))
    for t in range(len(acts) + 1):
        assert set(to) == set(jo) == {"pov", "reward", "position",
                                      "orientation"}
        for k in to:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"{k} at step {t}")
        np.testing.assert_array_equal(image_env.obs(ts).numpy(),
                                      to["pov"].numpy())
        if t < len(acts):
            js, jo, _, _, _ = jenv.step(js, jnp.asarray(acts[t], jnp.int32))
            ts, to, _, _, _ = env.step(ts, acts[t])
