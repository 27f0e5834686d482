"""The port's sprite tables and board render (``marlgrid_tpu_torch/
rendering.py``) against ``marlgrid_tpu.rendering``, on the CPU: the tables
equal at T = 8 and an odd T, and ``render_board`` equal on a reset state
with prestige dimming. On goal_cycle JAX's ``render_board`` computes the
appearance id in uint8 and wraps the bonus tile's id (261) to 5, drawing it
black; the port draws the bonus sprite there (ROADMAP Queue 3)."""
import jax
import numpy as np
import pytest
import torch

from marlgrid_tpu import rendering as jrendering
from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import EnvState as JEnvState
from marlgrid_tpu_torch import rendering
from marlgrid_tpu_torch.core import constants as C
from marlgrid_tpu_torch.core import grid_gen, obs as obs_mod, rng
from marlgrid_tpu_torch.core.state import EnvParams, state_to_numpy


@pytest.mark.parametrize("T", [8, 5])
def test_tables_match_jax(T):
    assert (obs_mod.NS, obs_mod.N_BASE_APPEAR, obs_mod.N_AGENT_APPEAR) == (
        jobs.NS, jobs.N_BASE_APPEAR, jobs.N_AGENT_APPEAR)
    np.testing.assert_array_equal(rendering.base_lut(T),
                                  jrendering.base_lut(T))
    np.testing.assert_array_equal(rendering.agent_lut(T),
                                  jrendering.agent_lut(T))


def _one_env(params, seed):
    """One env reset by the port (bit-equal to JAX's reset,
    test_torch_env.py) with prestige over several dim levels: the port's
    state without the batch dim, and JAX's."""
    ts = grid_gen.reset(params, rng.split(rng.PRNGKey(seed, device="cpu"), 1))
    ts.prestige = torch.linspace(0.5, 15.5, params.n_agents)[None]
    js = JEnvState(**{f: jax.numpy.asarray(v[0])
                      for f, v in state_to_numpy(ts).items()})
    return js, ts.map(lambda t: t[0])


@pytest.mark.parametrize("scenario,n", [("cluttered", 3), ("doorkey", 2)])
def test_render_board_matches_jax(scenario, n):
    jparams = JEnvParams(width=11, height=11, n_agents=n, scenario=scenario,
                         agent_colors=tuple(range(n)), n_clutter=12)
    params = EnvParams.from_dict(jparams.to_dict())
    js, ts = _one_env(params, 4)
    mask = np.random.default_rng(0).random((11, 11)) < 0.3
    for tile, hm in ((8, None), (16, mask)):
        np.testing.assert_array_equal(
            rendering.render_board(params, ts, tile, hm),
            jrendering.render_board(jparams, js, tile, hm))


def test_render_board_goal_cycle_bonus_tiles():
    jparams = JEnvParams(width=13, height=13, n_agents=4,
                         scenario="goal_cycle", agent_colors=(0, 4, 5, 1))
    params = EnvParams.from_dict(jparams.to_dict())
    js, ts = _one_env(params, 0)
    got = rendering.render_board(params, ts, 8)
    want = jrendering.render_board(jparams, js, 8)
    bonus = (ts.grid_type == C.BONUS).reshape(13, 13).numpy().T
    assert bonus.sum() == 3
    differs = (got != want).any(-1).reshape(13, 8, 13, 8).any((1, 3))
    np.testing.assert_array_equal(differs, bonus)
    sprite = rendering.base_lut(8)[(C.BONUS * C.N_COLORS
                                    + C.COLOR_TO_IDX["pink"]) * obs_mod.NS]
    for y, x in zip(*np.nonzero(bonus)):
        np.testing.assert_array_equal(
            got[y * 8:(y + 1) * 8, x * 8:(x + 1) * 8], sprite)
        assert not want[y * 8:(y + 1) * 8, x * 8:(x + 1) * 8].any()
