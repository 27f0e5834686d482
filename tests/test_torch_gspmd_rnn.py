"""The port's recurrent sharded default path
(``ppo_rnn.make_train_step_rnn(mesh=...)``, a GRU of hidden 16) on two
gloo ranks against the JAX package's GSPMD ``make_train_step_rnn(mesh=...)``
on two virtual CPU devices, as ``test_torch_gspmd.py`` holds the
feedforward step:

- ``bptt``: encode obs, truncated BPTT (``bptt_window=4`` of T = 8), B =
  32, 2 epochs of one minibatch of two (window, 32-env) sequence blocks;
- ``image``: image obs with the 'cnn_s2d' torso and carry leaves
  (B, N, H), which JAX trains only on this path, B = 32, T = 4, 2
  (step-window, 16-env) blocks a minibatch.

Both reset envs inside the rollout. The carry gathered from the ranks is
held against JAX's within 1e-5, and, on ``bptt``, the port's D = 2 after
two steps against its D = 1 (env state and key bit-equal, weights within
rtol 2e-4, atol 2e-5).
"""
import pytest

from test_torch_gspmd import (RESETS, check_d2_against_d1_with_resets,
                              check_shares, run_cases)
from test_torch_shard_map import check_against_jax

GRU = dict(rnn="gru", hidden=16, channels=(4, 8), n_minibatches=1)
CASES = {
    "bptt": (RESETS, dict(n_envs=32, rollout_len=8, bptt_window=4,
                          n_epochs=2, **GRU), dict(steps=2), (2, 4 * 2 * 32)),
    "image": (dict(RESETS, width=7, height=7, view_size=3,
                   observation_style="image"),
              dict(n_envs=32, rollout_len=4, n_epochs=1, torso="cnn_s2d",
                   **GRU), {}, (2, 4 * 16 * 2)),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    return run_cases(tmp_path_factory.mktemp("gspmd_rnn"), devices8, CASES,
                     "bptt")


@pytest.mark.parametrize("case", list(CASES))
def test_gspmd_rnn_step_matches_jax(results, case):
    check_against_jax(results["jax"][case], results["ranks"][case],
                      rnn=True)
    check_shares(results["ranks"][case], CASES[case])
    h = results["ranks"][case][0]["snaps"][0]["h"]
    B = CASES[case][1]["n_envs"]
    assert h.shape == ((2, B, 16) if case == "bptt" else (B, 2, 16))
    assert results["jax"][case]["metrics"]["n_episodes"] > 0


def test_gspmd_rnn_two_ranks_match_one_with_resets(results):
    check_d2_against_d1_with_resets(results["ranks"]["bptt"], results["d1"])
