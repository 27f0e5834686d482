"""The port's evaluation CLI against the JAX package's for a GRU
checkpoint (the recurrent carry through the episode), greedy and with
``--sample``; see ``test_torch_evaluate.py`` for the method and the
near-tie rule."""
import pytest

from test_torch_evaluate import check_family, make_checkpoints


@pytest.fixture(scope="module")
def gru_ck(tmp_path_factory):
    return make_checkpoints(tmp_path_factory.mktemp("eval_gru"),
                            ["--rnn", "gru"])


def test_evaluate_gru_matches_jax(capsys, gru_ck):
    check_family(capsys, *gru_ck, ["--episodes", "2"])
