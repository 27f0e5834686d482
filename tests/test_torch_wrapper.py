"""The port's host env (``marlgrid_tpu_torch/wrapper.py``) against the JAX
package's, on the CPU: with the same seed and a seeded numpy action
stream, the obs lists, rewards, done flags, ``encode()`` and ``render()``
arrays and the agents' mirrored position, direction and prestige are
bit-equal, over episode ends and resets; also the unbatched observation
helpers of ``core/obs.py`` and ``core/state.py::np_grid``.
"""
import types

import jax
import numpy as np
import pytest
import torch

from marlgrid_tpu import envs as jenvs, objects as jobjects
from marlgrid_tpu import rendering as jrendering, wrapper as jwrapper
from marlgrid_tpu.agents import GridAgentInterface as JAgent
from marlgrid_tpu.core import obs as jobs_mod
from marlgrid_tpu.core.state import np_grid as jnp_grid
from marlgrid_tpu_torch import envs, objects, wrapper
from marlgrid_tpu_torch.agents import GridAgentInterface
from marlgrid_tpu_torch.core import obs as obs_mod
from marlgrid_tpu_torch.core.state import np_grid


def assert_obs_equal(jo, to, where):
    assert len(jo) == len(to), where
    for i, (a, b) in enumerate(zip(jo, to)):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                if k == "pov":
                    assert b[k].dtype == np.asarray(a[k]).dtype
                    np.testing.assert_array_equal(b[k], a[k],
                                                  err_msg=f"{where} {i} pov")
                else:
                    assert a[k] == b[k], (where, i, k, a[k], b[k])
                    assert type(a[k]) is type(b[k]), (where, k)
        else:
            assert b.dtype == np.asarray(a).dtype, (where, i)
            np.testing.assert_array_equal(b, a, err_msg=f"{where} agent {i}")


def jax_render(je, render_kw):
    """The JAX env's ``render``; on a board with bonus tiles, JAX's
    ``render_board`` on the board layers widened to int32, because the JAX
    function computes the sprite id in the state's uint8 and draws the
    bonus tile (id 261) black (ROADMAP Queue 3, a known fault of the
    reference), where the port draws its sprite."""
    if je.params.n_bonus_tiles == 0 or je.params.scenario != "goal_cycle":
        return je.render(**render_kw)
    assert not render_kw
    s = je.state
    wide = types.SimpleNamespace(**{f: np.asarray(getattr(s, f)) for f in (
        "agent_pos", "agent_dir", "active", "prestige")}, **{
        f: np.asarray(getattr(s, f)).astype(np.int32)
        for f in ("grid_type", "grid_color", "grid_state")})
    return jrendering.render_board(je.params, wide, 16,
                                   highlight_mask=je.agent_highlight_mask())


def assert_envs_equal(je, te, where, render_kw=None):
    np.testing.assert_array_equal(te.encode(), je.encode(),
                                  err_msg=f"{where} encode")
    for ja, ta in zip(je.agents, te.agents):
        assert (ja.pos, ja.dir, ja.active, ja.carrying) == \
            (ta.pos, ta.dir, ta.active, ta.carrying), where
        assert np.float32(ja.prestige) == np.float32(ta.prestige), where
    render_kw = render_kw or {}
    np.testing.assert_array_equal(te.render(**render_kw),
                                  jax_render(je, render_kw),
                                  err_msg=f"{where} render")


def run_pair(je, te, n_steps, seed=0, render_kw=None):
    """Drive both envs through ``n_steps`` steps of seeded actions,
    resetting after done; returns how many episodes ended."""
    acts = np.random.default_rng(seed).integers(
        0, 7, (n_steps, je.num_agents), dtype=np.int32)
    assert_obs_equal(je.reset(), te.reset(), "reset")
    assert_envs_equal(je, te, "reset", render_kw)
    ended = 0
    for t, a in enumerate(acts):
        jo, jr, jd, _ = je.step(a)
        to, tr, td, _ = te.step(a)
        assert_obs_equal(jo, to, f"t={t}")
        assert tr.dtype == np.float32
        np.testing.assert_array_equal(tr, np.asarray(jr), err_msg=f"t={t}")
        assert td is jd, t
        assert_envs_equal(je, te, f"t={t}", render_kw)
        if jd:
            ended += 1
            assert_obs_equal(je.reset(), te.reset(), f"reset at t={t}")
    return ended


def pair(cls_name, agents_kw, **kw):
    """A JAX env and the port's of env class ``cls_name``, one
    GridAgentInterface per kwargs dict."""
    jcls = jenvs.ENV_CLASSES[cls_name]
    tcls = envs.ENV_CLASSES[cls_name]
    je = jcls(agents=[JAgent(**a) for a in agents_kw], **kw)
    te = tcls(agents=[GridAgentInterface(**a) for a in agents_kw],
              device="cpu", **kw)
    return je, te


STYLES = {
    "encode": [dict(color="red", view_size=5, observation_style="encode"),
               dict(color="blue", view_size=5, observation_style="encode"),
               dict(color="purple", view_size=5,
                    observation_style="encode")],
    "image": [dict(color="red", view_size=3, observation_style="image",
                   prestige_scale=0.5),
              dict(color="blue", view_size=3, observation_style="image",
                   prestige_scale=0.5)],
    "rich": [dict(color="red", view_size=3, observation_style="rich",
                  observe_rewards=True, observe_position=True,
                  observe_orientation=True),
             dict(color="green", view_size=3, observation_style="rich",
                  observe_rewards=True, observe_orientation=True)],
    # a hetero-view population: two observation groups of two styles
    "hetero": [dict(color="red", view_size=5, observation_style="encode"),
               dict(color="blue", view_size=3, observation_style="image"),
               dict(color="purple", view_size=5,
                    observation_style="encode")],
}


@pytest.mark.parametrize("style", list(STYLES))
def test_episode_bit_equal(style):
    """goal_cycle 9x9 (pays bonuses: prestige moves), two episodes and a
    third begun, every observation style and a hetero population."""
    je, te = pair("goal_cycle", STYLES[style], grid_size=9, max_steps=10,
                  n_clutter=3, n_bonus_tiles=2, seed=4, reward_decay=True)
    assert run_pair(je, te, 24, seed=1) >= 2


def test_render_agent_views_and_highlight():
    """render with each agent's pov strip (tile 8, the view tile size:
    JAX's strip takes sprite tables of that size) and without the
    highlight; ``__str__``."""
    je, te = pair("cluttered", STYLES["encode"], grid_size=9, max_steps=6,
                  n_clutter=4, seed=2)
    run_pair(je, te, 4, seed=2, render_kw=dict(
        tile_size=8, show_agent_views=True))
    np.testing.assert_array_equal(te.render(highlight=False),
                                  je.render(highlight=False))
    assert str(te) == str(je)


def test_place_obj_agent_and_goal_rewards():
    """``place_obj`` (a WorldObj, a raw triple), ``place_agent`` and a
    ``Goal(reward=2.5)`` paid through ``goal_rewards``, on one host RNG
    stream: the same cells, then bit-equal steps."""
    kw = dict(grid_size=7, max_steps=30, goal_rewards=(1.0, 2.5), seed=3)
    agents = [dict(color="red", view_size=5, observation_style="encode"),
              dict(color="blue", view_size=5, observation_style="encode")]
    je, te = pair("empty", agents, **kw)
    je.reset()
    te.reset()
    for jo, to in ((jobjects.Goal(reward=2.5), objects.Goal(reward=2.5)),
                   (jobjects.Key("red"), objects.Key("red")),
                   ((jobjects.Ball().type_code, 4, 0),
                    (objects.Ball().type_code, 4, 0))):
        assert je.place_obj(jo, top=(1, 1), size=(5, 5)) == \
            te.place_obj(to, top=(1, 1), size=(5, 5))
    assert je.place_agent(1, dir=2) == te.place_agent(1, dir=2)
    assert je.place_agent(0) == te.place_agent(0)
    assert_envs_equal(je, te, "placed")
    with pytest.raises(ValueError, match="goal_rewards"):
        te.place_obj(objects.Goal(reward=7.0))
    with pytest.raises(ValueError, match="goal state"):
        te.place_obj((objects.Goal().type_code, 3, 5))
    acts = np.random.default_rng(5).integers(0, 7, (30, 2), dtype=np.int32)
    for t, a in enumerate(acts):
        jo, jr, jd, _ = je.step(a)
        to, tr, td, _ = te.step(a)
        assert_obs_equal(jo, to, f"t={t}")
        np.testing.assert_array_equal(tr, np.asarray(jr))
        assert td is jd
        if jd:
            break
    assert_envs_equal(je, te, "end")


def test_place_goal_pays_its_reward():
    """An agent one step from a placed ``Goal(reward=2.5)`` collects 2.5
    (times the decay) in both envs."""
    agents = [dict(color="red", view_size=3, observation_style="encode")]
    je, te = pair("empty", agents, grid_size=5, max_steps=10,
                  goal_rewards=(1.0, 2.5), reward_decay=False, seed=0)
    for e, obj in ((je, jobjects), (te, objects)):
        e.reset()
        e.place_agent(0, top=(1, 1), size=(1, 1), dir=0)
        # clear the scenario's goal out of the way, then place ours ahead
        enc = e.encode()
        for x, y in zip(*np.nonzero(enc[..., 0] == obj.Goal().type_code)):
            e._set_cell_host(int(x), int(y), (0, 0, 0))
        assert e.place_obj(obj.Goal(reward=2.5), top=(2, 1),
                           size=(1, 1)) == (2, 1)
    _, jr, jd, _ = je.step([2])
    _, tr, td, _ = te.step([2])
    assert float(tr[0]) == float(np.asarray(jr)[0]) == 2.5
    assert td is jd


def test_reset_on_cycle_gymnasium_five_tuple():
    """``GymnasiumMultiGridEnv`` with ``reset_on_cycle`` on goal_cycle:
    obs tuples, rewards, terminated and truncated equal JAX's."""
    agents = [dict(color="red", view_size=3, observation_style="encode"),
              dict(color="blue", view_size=3, observation_style="encode")]
    kw = dict(grid_size=5, max_steps=40, n_clutter=0, n_bonus_tiles=2,
              reset_on_cycle=True, scenario="goal_cycle", seed=7)

    class J(jwrapper.GymnasiumMultiGridEnv):
        scenario = "goal_cycle"

    class T(wrapper.GymnasiumMultiGridEnv):
        scenario = "goal_cycle"

    kw.pop("scenario")
    je = J(agents=[JAgent(**a) for a in agents], **kw)
    te = T(agents=[GridAgentInterface(**a) for a in agents], device="cpu",
           **kw)
    jo, ji = je.reset(seed=7)
    to, ti = te.reset(seed=7)
    assert isinstance(to, tuple) and ti == ji == {}
    assert_obs_equal(jo, to, "reset")
    acts = np.random.default_rng(0).integers(0, 3, (200, 2), dtype=np.int32)
    kinds = set()
    for t, a in enumerate(acts):
        jres = je.step(a)
        tres = te.step(a)
        assert len(tres) == 5
        assert_obs_equal(jres[0], tres[0], f"t={t}")
        np.testing.assert_array_equal(tres[1], np.asarray(jres[1]))
        assert tres[2:4] == jres[2:4], t
        if jres[2] or jres[3]:
            kinds.add(jres[2:4])
            je.reset()
            te.reset()
    assert (True, False) in kinds            # a cycle ended an episode


def test_unbatched_obs_helpers_and_np_grid():
    """The unbatched observation helpers on the host env's state against
    the JAX functions on the JAX env's: view coords, view cells (with the
    prestige dim factor), transparency and occlusion, encode and image
    obs, np_grid."""
    je, te = pair("goal_cycle", STYLES["image"], grid_size=9, max_steps=30,
                  n_clutter=6, seed=5)
    run_pair(je, te, 12, seed=3)
    jp, tp = je.params, te.params
    js, ts = je.state, te.state

    def eq(a, b, what):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=what)

    for a, b in zip(jobs_mod.all_view_world_coords(jp, js),
                    obs_mod.all_view_world_coords(tp, ts)):
        eq(a, b, "world coords")
    jc = jobs_mod.all_view_cells(jp, js, with_dim=True)
    tc = obs_mod.all_view_cells(tp, ts, with_dim=True)
    assert len(jc) == len(tc) == 7
    for k, (a, b) in enumerate(zip(jc, tc)):
        eq(a, b, f"view cell {k}")
    for k, (a, b) in enumerate(zip(jobs_mod.view_cells(jp, js, 1),
                                   obs_mod.view_cells(tp, ts, 1))):
        eq(a, b, f"view_cells agent 1, {k}")
    jt = jobs_mod.transparency(jc[0], jc[2])
    tt = obs_mod.transparency(tc[0], tc[2])
    eq(jt, tt, "transparency")
    eq(jobs_mod.process_vis(jt, jp.view_size, jp.view_offset),
       obs_mod.process_vis(tt, tp.view_size, tp.view_offset), "vis")
    # a random transparency grid with extra leading dims
    g = np.random.default_rng(0).random((2, 3, 5, 5)) < 0.7
    eq(jobs_mod.process_vis(jax.numpy.asarray(g), 5, 1),
       obs_mod.process_vis(torch.as_tensor(g), 5, 1), "vis (2, 3, 5, 5)")
    enc_p = tp.replace(observation_style="encode")
    eq(jobs_mod.all_obs_encode(jp.replace(observation_style="encode"), js),
       obs_mod.all_obs_encode(enc_p, ts), "all_obs_encode")
    eq(jobs_mod.agent_obs_encode(jp, js, 0),
       obs_mod.agent_obs_encode(tp, ts, 0), "agent_obs_encode")
    bl = jax.numpy.asarray(jrendering.base_lut(jp.view_tile_size))
    al = jax.numpy.asarray(jrendering.agent_lut(jp.view_tile_size))
    eq(jobs_mod.all_obs_image(jp, js, bl, al),
       obs_mod.all_obs_image(tp, ts), "all_obs_image")
    eq(jobs_mod.all_agent_obs(jp, js, bl, al),
       obs_mod.all_agent_obs(tp, ts), "all_agent_obs")
    eq(jnp_grid(js, jp), np_grid(ts, tp), "np_grid")
    eq(jnp_grid(js), np_grid(ts), "np_grid flat")


def test_env_params_for_and_defaults():
    tp = wrapper.env_params_for("cluttered", 11, 3, n_clutter=4)
    jp = jwrapper.env_params_for("cluttered", 11, 3, n_clutter=4)
    assert tp.to_dict() == jp.to_dict()
    te = wrapper.MultiGridEnv(params=tp, device="cpu")
    assert te.device.type == "cpu" and len(te.agents) == 3
    assert [a.color for a in te.agents] == \
        [a.color for a in jwrapper.MultiGridEnv(params=jp).agents]
