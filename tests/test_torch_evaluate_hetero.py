"""The port's evaluation CLI against the JAX package's for a hetero
population checkpoint (a 5x5 and a 3x3 view group, one policy each; the
sampled path folds the group index into the step's key), greedy and with
``--sample``; see ``test_torch_evaluate.py`` for the method and the
near-tie rule."""
import pytest

from test_torch_evaluate import check_family, make_checkpoints

SPEC = '[{"view_size":5},{"view_size":3},{"view_size":5}]'
ENV_ARGS = ["--scenario", "goal_cycle", "--grid-size", "7", "--agents",
            "3", "--max-steps", "10"]


@pytest.fixture(scope="module")
def hetero_ck(tmp_path_factory):
    return make_checkpoints(tmp_path_factory.mktemp("eval_hetero"),
                            ["--agent-config", SPEC], env_args=ENV_ARGS)


def test_evaluate_hetero_matches_jax(capsys, hetero_ck):
    check_family(capsys, *hetero_ck, ["--episodes", "2"])


MIXED = ('[{"view_size":5},{"view_size":5,"observation_style":"image"},'
         '{"view_size":5,"observation_style":"rich","observe_rewards":true}]')


@pytest.mark.parametrize("extra", [
    ["--agent-config", SPEC, "--rnn", "gru"],
    ["--agent-config", MIXED, "--obs", "encode"]],
    ids=["hetero-recurrent", "mixed-style"])
def test_evaluate_port_checkpoint_families(tmp_path, capsys, extra):
    """The two families the JAX comparison above leaves out, end to end in
    the port: its training CLI writes a checkpoint on the CPU (a hetero
    recurrent population: per-group weights and the carry dict; a mixed
    population: encode, image and rich groups, the pixel groups' s2d
    relabel on the host), and evaluate restores it from the path alone and
    prints the stats line."""
    import json

    from marlgrid_tpu_torch.parallel import evaluate, train

    ck = str(tmp_path / "ck")
    train.main(ENV_ARGS + ["--device", "cpu", "--envs", "4", "--rollout",
                           "4", "--iters", "1", "--epochs", "1",
                           "--minibatches", "1", "--hidden", "16",
                           "--checkpoint-dir", ck, "--checkpoint-every",
                           "1", *extra])
    capsys.readouterr()
    out = evaluate.main(["--checkpoint", ck, "--device", "cpu",
                         "--episodes", "1", "--max-steps", "4", "--sample"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["episodes"] == 1 and stats["mean_length"] == 4
    assert out["steps"] == 4 and out["seconds"] > 0
