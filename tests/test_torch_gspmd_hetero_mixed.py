"""The port's mixed-style hetero trainer on the sharded default path
(``ppo_hetero_mixed.make_train_step_hetero_mixed(mesh=...)``) on two gloo
ranks against the JAX package's GSPMD ``make_train_step_hetero_mixed(
mesh=...)`` on two virtual CPU devices, as ``test_torch_gspmd_hetero.py``
holds the all-encode trainer, with its bars and helpers.

The case: goal_cycle 9x9 with max_steps 6 and three agents of three
styles, an encode agent with a 5x5 view, an image agent and a rich agent
(rewards and orientation) with 3x3 views of 4-pixel tiles (the cnn_s2d
torso), B = 16, T = 6, hidden 16, one epoch of 2 minibatches under Adam
(as ``test_torch_ppo_hetero_mixed.py`` holds the one-device step). Envs
reset inside the rollout and the pool (K = 16) is larger than a rank's 8
envs. The 6 (step, 16-env) blocks make minibatches of 3, which two ranks
split as 1 and 2: a rank re-renders the pixel groups of its own 2 blocks
from the gathered EnvState store, not of all 3.
"""
import pytest

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo_hetero_mixed as jmixed
from test_torch_gspmd_hetero import (CFG, check_against_jax,
                                     check_d2_against_d1, check_shares,
                                     make_case, run_case)

MIXED = JEnvParams(width=9, height=9, n_agents=3, scenario="goal_cycle",
                   max_steps=6, reward_decay=False, agent_colors=(0, 4, 5),
                   observation_style="encode", view_tile_size=4,
                   agent_obs_styles=("encode", "image", "rich"),
                   agent_view_sizes=(5, 3, 3), observe_rewards=True,
                   observe_orientation=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    c = make_case(MIXED, dict(CFG, n_epochs=1, channels=(4, 8)),
                  jmixed.init_state_hetero_mixed,
                  jmixed.make_train_step_hetero_mixed)
    return dict(run_case(tmp_path_factory.mktemp("gspmd_hetero_mixed"),
                         devices8, c), case=c)


def test_gspmd_hetero_mixed_step_matches_jax(results):
    check_against_jax(results["jax"], results["ranks"])


def test_gspmd_hetero_mixed_odd_shares(results):
    # one agent a group, 16 envs a block
    check_shares(results["ranks"], results["case"], (3, 3, 3), (16, 16, 16))


def test_gspmd_hetero_mixed_two_ranks_match_one(results):
    check_d2_against_d1(results["ranks"], results["d1"])
