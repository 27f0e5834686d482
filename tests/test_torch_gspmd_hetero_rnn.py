"""The port's hetero recurrent trainer on the sharded default path
(``ppo_hetero_rnn.make_train_step_hetero_rnn(mesh=...)``, a GRU of hidden
16 per group) on two gloo ranks against the JAX package's GSPMD
``make_train_step_hetero_rnn(mesh=...)`` on two virtual CPU devices, as
``test_torch_gspmd_hetero.py`` holds the feedforward trainer, with its
bars and helpers.

The case: goal_cycle 9x9 with max_steps 6, view sizes (5, 3, 5), B = 16,
T = 6, 2 epochs x 2 minibatches. Envs reset inside the rollout and the
pool (K = 16) is larger than a rank's 8 envs. The 16 envs make two chunks
of 8 whole sequences under one permutation shared by the groups, so a
minibatch is one chunk, which two ranks split as 0 and 1 (the first
rank's share a padding chunk at weight 0). The carry dict gathered from
the ranks is held against JAX's within 1e-5, also at D = 2 against the
port's D = 1 after two steps.
"""
import pytest

from marlgrid_tpu.parallel import ppo_hetero_rnn as jhrnn
from test_torch_gspmd_hetero import (CFG, VIEWS, check_against_jax,
                                     check_d2_against_d1, check_shares,
                                     make_case, run_case)


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    c = make_case(VIEWS, dict(CFG, rnn="gru"), jhrnn.init_state_hetero_rnn,
                  jhrnn.make_train_step_hetero_rnn)
    return dict(run_case(tmp_path_factory.mktemp("gspmd_hetero_rnn"),
                         devices8, c), case=c)


def test_gspmd_hetero_rnn_step_matches_jax(results):
    check_against_jax(results["jax"], results["ranks"])
    h = results["ranks"][0]["snaps"][0]["h"]
    assert {g: tuple(x.shape) for g, x in h.items()} == {
        0: (2, 16, 16), 1: (1, 16, 16)}


def test_gspmd_hetero_rnn_odd_shares(results):
    # one 8-env chunk a minibatch: T * n_g * 8 samples a group
    check_shares(results["ranks"], results["case"], (1, 1),
                 (6 * 2 * 8, 6 * 1 * 8))


def test_gspmd_hetero_rnn_two_ranks_match_one(results):
    check_d2_against_d1(results["ranks"], results["d1"])
