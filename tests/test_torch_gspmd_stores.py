"""The port's sharded default path on the two other trajectory stores,
against the JAX package's GSPMD step on two virtual CPU devices, as
``test_torch_gspmd.py`` holds the feature-major store:

- ``rows``: encode obs with the 'cnn' torso (uint8 rows, one row a block:
  the 128 rows of 2 minibatches of 64, 32 per rank), B = 16, T = 4;
- ``states``: image obs with the 'cnn_s2d' torso, the pre-step EnvStates
  re-rendered in the update (two (step, 8-env) blocks a minibatch, one
  per rank), 7x7 with 3x3 views, B = 8, T = 4.

Env state and key bit-equal to JAX's after a step, gradients, metrics and
weights within ``test_torch_ppo.py``'s bounds, each rank's loss calls on
its half of each minibatch.
"""
import pytest

from test_torch_gspmd import RESETS, check_shares, run_cases
from test_torch_shard_map import check_against_jax

SMALL = dict(hidden=16, channels=(4, 8), n_epochs=1, n_minibatches=2)
CASES = {
    "rows": (RESETS, dict(n_envs=16, rollout_len=4, torso="cnn", **SMALL),
             {}, (64, 1)),
    "states": (dict(RESETS, width=7, height=7, view_size=3,
                    observation_style="image"),
               dict(n_envs=8, rollout_len=4, torso="cnn_s2d", **SMALL), {},
               (2, 16)),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    return run_cases(tmp_path_factory.mktemp("gspmd_stores"), devices8,
                     CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_gspmd_store_matches_jax(results, case):
    check_against_jax(results["jax"][case], results["ranks"][case])
    check_shares(results["ranks"][case], CASES[case])
