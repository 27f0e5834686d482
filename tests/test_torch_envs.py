"""The port's env registry, objects, agent spaces and tools against the JAX
package's, on the CPU: ``make`` and ``env_from_config`` give the JAX env's
params for every default id, the port's gymnasium ids and JAX's live in
one registry, object encodings and ``encode_obj_cell`` agree,
``register_scenario`` takes ``WorldObj`` events (bit-equal resets), the
spaces equal JAX's, and ``GridRecorder`` writes a gif.
"""
import jax
import numpy as np
import pytest
import torch

from marlgrid_tpu import envs as jenvs, objects as jobjects
from marlgrid_tpu.agents import GridAgentInterface as JAgent
from marlgrid_tpu.agents import IndependentLearners as JLearners
from marlgrid_tpu.core import grid_gen as jgrid
from marlgrid_tpu.core.state import EnvParams as JParams, default_agent_colors
from marlgrid_tpu_torch import envs, objects, rendering
from marlgrid_tpu_torch.agents import GridAgentInterface, IndependentLearners
from marlgrid_tpu_torch.core import constants as C, grid_gen
from marlgrid_tpu_torch.core.state import EnvParams, state_to_numpy
from marlgrid_tpu_torch.utils.metrics import Throughput
from marlgrid_tpu_torch.utils.video import GridRecorder, export_frames

DEFAULT_IDS = sorted(jenvs.REGISTRY)


def test_registry_has_the_reference_ids():
    assert set(jenvs.REGISTRY) <= set(envs.REGISTRY)
    assert "MarlGrid-3AgentCluttered15x15-v0" in envs.REGISTRY
    assert len(DEFAULT_IDS) >= 6


@pytest.mark.parametrize("env_id", DEFAULT_IDS)
def test_make_matches_jax(env_id):
    """``make(id)`` (and through its gymnasium id) builds the JAX env's
    params, agents and class."""
    je = jenvs.make(env_id, seed=3)
    te = envs.make(env_id, seed=3, device="cpu")
    assert te.params.to_dict() == je.params.to_dict()
    assert type(te).__name__ == type(je).__name__
    assert [vars(a).get("view_size") for a in te.agents] == \
        [vars(a).get("view_size") for a in je.agents]
    assert [a.color for a in te.agents] == [a.color for a in je.agents]
    tg = envs.make(envs.gymnasium_id(env_id), seed=3, device="cpu")
    assert tg.params == te.params


CONFIGS = [
    dict(env_class="ClutteredMultiGrid", n_agents=3, grid_size=11,
         max_steps=50, n_clutter=5, view_size=5, observation_style="encode"),
    dict(env_class="goal_cycle", n_agents=2, grid_size=9, seed=4,
         n_bonus_tiles=2, prestige_beta=0.9, observation_style="rich",
         observe_rewards=True),
    dict(env_class="doorkey", n_agents=2, grid_size=11, view_offset=1,
         see_through_walls=True),
    dict(env_class="EmptyMultiGrid", n_agents=1, grid_size=7,
         spawn_delay=2),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_env_from_config_matches_jax(cfg):
    je = jenvs.env_from_config(dict(cfg))
    te = envs.env_from_config(dict(cfg), device="cpu")
    assert te.params.to_dict() == je.params.to_dict()
    assert type(te).__name__ == type(je).__name__
    to, jo = te.reset()[0], je.reset()[0]
    if isinstance(jo, dict):
        assert to.keys() == jo.keys()
        to, jo = to["pov"], jo["pov"]
    np.testing.assert_array_equal(to, jo)


def test_gymnasium_ids_coexist():
    """Both packages' ids are in gymnasium's registry in one process; each
    makes its own package's env."""
    import gymnasium

    from marlgrid_tpu import wrapper as jwrapper
    from marlgrid_tpu_torch import wrapper

    for env_id in DEFAULT_IDS:
        assert env_id in gymnasium.registry
        assert envs.gymnasium_id(env_id) in gymnasium.registry
        assert envs.gymnasium_id(env_id) != env_id
    te = gymnasium.make("MarlGridTorch-3AgentCluttered15x15-v0", seed=4,
                        device="cpu", render_mode="rgb_array")
    je = gymnasium.make("MarlGrid-3AgentCluttered15x15-v0", seed=4)
    te, je = te.unwrapped, je.unwrapped
    assert isinstance(te, wrapper.MultiGridEnv)
    assert isinstance(je, jwrapper.MultiGridEnv)
    assert te.render_mode == "rgb_array"
    for a, b in zip(te.reset(), je.reset()):
        np.testing.assert_array_equal(a, b)


def test_objects_encodings_match_jax():
    samples = [
        ("Wall", (), {}), ("Floor", (), {}), ("Goal", (), {}),
        ("Lava", (), {}), ("Door", ("blue",), dict(state=C.DOOR_LOCKED)),
        ("Door", ("red",), {}), ("Key", ("yellow",), {}), ("Ball", (), {}),
        ("BonusTile", (), dict(bonus_id=2)), ("GridAgent", ("green",),
                                              dict(direction=3)),
    ]
    for name, args, kw in samples:
        t = getattr(objects, name)(*args, **kw)
        j = getattr(jobjects, name)(*args, **kw)
        assert t.encode() == j.encode(), name
        assert t.str_render() == j.str_render(), name
        assert (t.can_overlap(), t.can_pickup(), t.can_contain(),
                t.see_behind()) == (j.can_overlap(), j.can_pickup(),
                                    j.can_contain(), j.see_behind()), name
        back = objects.from_encoding(*j.encode())
        jback = jobjects.from_encoding(*j.encode())
        assert type(back).__name__ == type(jback).__name__, name
        assert back.encode() == jback.encode() and back == t
        np.testing.assert_array_equal(t.render(8), j.render(8))
    box = objects.Box("grey", contains=objects.Ball("purple"))
    jbox = jobjects.Box("grey", contains=jobjects.Ball("purple"))
    assert box.encode() == jbox.encode()
    assert box.contains.encode() == jbox.contains.encode()
    assert objects.from_encoding(C.EMPTY) is None
    assert {k: v.tolist() for k, v in objects.COLORS.items()} == \
        {k: v.tolist() for k, v in jobjects.COLORS.items()}
    assert issubclass(objects.BulkObj, objects.WorldObj)


def test_encode_obj_cell_matches_jax():
    """Per-object rewards through ``encode_obj_cell``: the same triples and
    the same refusals as the JAX function."""
    kw = dict(goal_rewards=(1.0, 2.5), bonus_rewards=(1.0, 2.0),
              bonus_penalties=(0.5, 0.25), n_bonus_tiles=2)
    jp, tp = JParams(**kw), EnvParams(**kw)
    cases = [lambda O: O.Goal(), lambda O: O.Goal(reward=2.5),
             lambda O: O.Goal(reward=1.0), lambda O: O.BonusTile(1),
             lambda O: O.BonusTile(1, reward=2.0, penalty=0.25),
             lambda O: O.Key("red"), lambda O: O.Goal(reward=3.0),
             lambda O: O.BonusTile(0, reward=9.0)]
    for make_obj in cases:
        try:
            want = jgrid.encode_obj_cell(make_obj(jobjects), jp)
        except ValueError:
            with pytest.raises(ValueError):
                grid_gen.encode_obj_cell(make_obj(objects), tp)
            continue
        assert grid_gen.encode_obj_cell(make_obj(objects), tp) == want
        assert grid_gen.normalize_event(make_obj(objects), tp) == \
            want + (None,)
    mask = np.ones((9, 9), bool)
    ev = grid_gen.normalize_event((objects.Lava(), mask), tp)
    assert ev[:3] == (C.LAVA, C.COLOR_TO_IDX["orange"], 0) and ev[3] is mask
    assert grid_gen.normalize_event(None) is None
    assert grid_gen.normalize_event((1, 2, 3, None)) == (1, 2, 3, None)


def _events(O):
    """A custom scenario: 4 lava tiles on the left half, a pink bonus tile
    anywhere, a goal; WorldObj events and (WorldObj, mask) pairs."""
    def build(params, layers, split_x, door_y):
        left = np.zeros((params.width, params.height), bool)
        left[: params.width // 2] = True
        events = [(O.Lava(), left) for _ in range(4)]
        events += [O.BonusTile(0), None, O.Goal()]
        return layers, events, None
    return build


jgrid.register_scenario("lava_objects", _events(jobjects), 7)
grid_gen.register_scenario("lava_objects", _events(objects), 7)


def test_register_scenario_with_worldobj_events():
    jp = JParams(width=11, height=11, n_agents=2, scenario="lava_objects",
                 observation_style="encode", n_bonus_tiles=1,
                 agent_colors=default_agent_colors(2))
    tp = EnvParams.from_dict(jp.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(6), 8)
    js = jax.jit(jax.vmap(lambda k: jgrid.reset(jp, k)))(keys)
    ts = grid_gen.reset(tp, torch.as_tensor(np.asarray(keys).astype(
        np.int64)))
    got = state_to_numpy(ts)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    gt = got["grid_type"].reshape(8, 11, 11)
    assert ((gt == C.LAVA).sum((1, 2)) == 4).all()
    assert (gt[:, 5:] != C.LAVA).all()


@pytest.mark.parametrize("style", ["image", "encode", "rich"])
def test_spaces_match_jax(style):
    kw = dict(view_size=5, view_tile_size=4, observation_style=style,
              observe_rewards=True, observe_position=True,
              observe_orientation=True)
    t, j = GridAgentInterface(**kw), JAgent(**kw)
    assert t.observation_space == j.observation_space
    assert t.action_space == j.action_space
    tl = IndependentLearners(t, GridAgentInterface(view_size=3))
    jl = JLearners(j, JAgent(view_size=3))
    assert tl.observation_space == jl.observation_space
    assert tl.action_space == jl.action_space
    assert t.actions == j.actions
    t.pos, t.dir = (3, 4), 2
    j.pos, j.dir = (3, 4), 2
    assert t.front_pos == j.front_pos == (2, 4)
    t.activate()
    assert t.active
    t.deactivate()
    assert not t.active


def test_independent_learners_episode_loop():
    calls = []

    class L:
        observation_space = action_space = None

        def __init__(self, i):
            self.i = i

        def action_step(self, obs):
            return self.i

        def save_step(self, *a):
            calls.append(("save", self.i))

        def start_episode(self):
            calls.append(("start", self.i))

        def end_episode(self):
            calls.append(("end", self.i))

    ls = IndependentLearners(L(0), L(1))
    with ls.episode():
        assert ls.action_step([None, None]) == [0, 1]
        ls.save_step([0, 0], [0, 1], [0.0, 1.0], False)
    assert calls == [("start", 0), ("start", 1), ("save", 0), ("save", 1),
                     ("end", 0), ("end", 1)]


def test_grid_recorder_writes_gif(tmp_path):
    env = envs.make("MarlGrid-2AgentEmpty9x9-v0", device="cpu",
                    max_steps=5)
    rec = GridRecorder(env, tile_size=8)
    rec.reset()
    done = False
    while not done:
        _, _, done, _ = rec.step([2, 1])
    assert len(rec.frames) == 6
    assert rec.frames[0].shape == (72, 72, 3)
    assert rec.num_agents == 2                    # passes attributes on
    out = rec.export_video(str(tmp_path / "ep.gif"))
    assert (tmp_path / "ep.gif").stat().st_size > 0 and out.endswith(".gif")
    out2 = export_frames(rec.frames[:2], str(tmp_path / "two.gif"))
    assert (tmp_path / "two.gif").stat().st_size > 0 and out2


def test_viewer_saves_frames_without_a_display(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    env = envs.make("MarlGrid-1AgentEmpty9x9-v0", device="cpu")
    env.reset()
    img = env.render(mode="human", tile_size=4)
    assert img.shape == (36, 36, 3)
    assert len(list(tmp_path.glob("*.png"))) == 1
    env.close()
    assert rendering.SimpleImageViewer().imshow(img).startswith(
        str(tmp_path))


def test_throughput_counts():
    t = Throughput()
    assert t.update(10) > 0
    t.reset()
    assert t._steps == 0
