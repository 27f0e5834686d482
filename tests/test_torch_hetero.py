"""Heterogeneous populations in the port against the JAX package, on the
CPU: ``obs_groups``, ``GridAgentInterface``/``agents_to_params_fields``, and
the hetero ``VectorEnv``'s per-group observations, bit-equal to JAX's
``VectorEnv`` over autoreset steps, on mixed view sizes (with per-agent view
offsets and see-through flags) and on a mixed encode/image/rich
population."""
import jax
import numpy as np
import pytest
import torch

from marlgrid_tpu.agents import GridAgentInterface as JAgent
from marlgrid_tpu.agents import agents_to_params_fields as j_fields
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import default_agent_colors
from marlgrid_tpu.vector import VectorEnv as JVectorEnv
from marlgrid_tpu.vector import obs_groups as j_obs_groups
from marlgrid_tpu_torch.agents import GridAgentInterface, \
    agents_to_params_fields
from marlgrid_tpu_torch.core.state import EnvParams
from marlgrid_tpu_torch.vector import VectorEnv, obs_groups

VIEWS = JEnvParams(width=11, height=11, n_agents=4, scenario="cluttered",
                   n_clutter=10, max_steps=6, observation_style="encode",
                   agent_view_sizes=(5, 7, 5, 7),
                   agent_view_offsets=(0, 1, 0, 1),
                   agent_see_through_walls=(False, True, False, True),
                   agent_colors=default_agent_colors(4))
MIXED = JEnvParams(width=9, height=9, n_agents=4, scenario="doorkey",
                   max_steps=5, observation_style="encode", view_size=5,
                   view_tile_size=4,
                   agent_obs_styles=("encode", "image", "rich", "encode"),
                   agent_view_sizes=(5, 5, 3, 7),
                   observe_rewards=True, observe_orientation=True,
                   agent_colors=default_agent_colors(4))
AGENTS = [
    dict(color="red", view_size=5, observation_style="encode",
         see_through_walls=True, prestige_beta=0.9),
    dict(color="blue", view_size=5, observation_style="encode",
         hide_item_types=("goal", 4), prestige_scale=1.0, spawn_delay=3),
    dict(color="purple", view_size=7, observation_style="rich",
         view_offset=1, observe_rewards=True, observe_position=True,
         observe_orientation=True, view_tile_size=4),
]


def _key(key):
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def test_agents_to_params_fields_matches_jax():
    got = agents_to_params_fields([GridAgentInterface(**kw) for kw in AGENTS])
    want = j_fields([JAgent(**kw) for kw in AGENTS])
    assert got == want
    assert got["agent_hide_item_types"] == ((), (7, 4), ())
    same = agents_to_params_fields([GridAgentInterface(view_size=5)] * 2)
    assert not EnvParams(**same).has_hetero_obs
    with pytest.raises(AssertionError, match="odd"):
        GridAgentInterface(view_size=4)
    with pytest.raises(KeyError):
        GridAgentInterface(color="mauve")


@pytest.mark.parametrize("jparams", [VIEWS, MIXED, JEnvParams(
    **j_fields([JAgent(**kw) for kw in AGENTS]))], ids=["views", "mixed",
                                                         "agents"])
def test_obs_groups_match_jax(jparams):
    params = EnvParams.from_dict(jparams.to_dict())
    got = [(idxs, gp.to_dict()) for idxs, gp in obs_groups(params)]
    want = [(idxs, gp.to_dict()) for idxs, gp in j_obs_groups(jparams)]
    assert got == want and len(got) >= 2


def _check_obs(to, jo, what):
    assert set(to) == set(jo), what
    for g in jo:
        if isinstance(jo[g], dict):
            assert set(to[g]) == set(jo[g]), what
            for k in jo[g]:
                np.testing.assert_array_equal(
                    to[g][k].numpy(), np.asarray(jo[g][k]),
                    err_msg=f"{what}, group {g} {k}")
        else:
            np.testing.assert_array_equal(to[g].numpy(), np.asarray(jo[g]),
                                          err_msg=f"{what}, group {g}")


@pytest.mark.parametrize("jparams", [VIEWS, MIXED], ids=["views", "mixed"])
def test_vector_env_hetero_matches_jax(jparams):
    """Per-group observations, bit for bit, over autoreset steps: encode
    groups rendered for their own observers on one shared painted board,
    image and rich groups (pov, reward, orientation) sliced from their
    config's full render."""
    params = EnvParams.from_dict(jparams.to_dict())
    B = 6
    jenv = JVectorEnv(jparams, n_envs=B)
    env = VectorEnv(params, n_envs=B, device="cpu")
    assert [i for i, _ in env.obs_groups] == [i for i, _ in jenv.obs_groups]
    key = jax.random.PRNGKey(4)
    js, jo = jenv.reset(key)
    ts, to = env.reset(_key(key))
    acts = np.random.default_rng(1).integers(0, 7, (8, B, params.n_agents))
    n_done = 0
    for t in range(len(acts) + 1):
        _check_obs(to, jo, f"step {t}")
        if t == len(acts):
            break
        js, jo, jrew, jdone, _ = jenv.step(js, acts[t])
        ts, to, rew, done, _ = env.step(ts, torch.as_tensor(acts[t]))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        n_done += int(done.sum())
    assert n_done > 0
    shapes = {g: tuple((o["pov"] if isinstance(o, dict) else o).shape)
              for g, o in to.items()}
    if jparams is VIEWS:
        assert shapes == {0: (B, 2, 5, 5, 3), 1: (B, 2, 7, 7, 3)}
    else:
        assert shapes == {0: (B, 1, 5, 5, 3), 1: (B, 1, 20, 20, 3),
                          2: (B, 1, 12, 12, 3), 3: (B, 1, 7, 7, 3)}
