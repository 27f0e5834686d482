"""The port's examples (``examples/torch_*.py``, the counterparts of the
JAX package's four scripts) run on the CPU at a tiny size, each through
its ``main(argv)`` with ``--device cpu``: the host loop of a registered
env and of a custom scenario to the end of an episode (the video written
into the test's directory when imageio is installed), the batched API's
steps, and a mixed-style hetero population's train steps."""
import math

import pytest

from test_torch_imports import EXAMPLES, load_example

EXAMPLE = {p.stem[len("torch_"):]: p for p in EXAMPLES}


@pytest.fixture(autouse=True)
def _tmp_video_dir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def test_random_rollout(tmp_path):
    total = load_example(EXAMPLE["random_rollout"]).main(
        ["--device", "cpu", "--max-steps", "12"])
    assert total.shape == (3,)


def test_custom_env():
    total = load_example(EXAMPLE["custom_env"]).main(
        ["--device", "cpu", "--max-steps", "12"])
    assert total.shape == (2,)


def test_batched_rollout():
    out = load_example(EXAMPLE["batched_rollout"]).main(
        ["--device", "cpu", "--envs", "16", "--iters", "2"])
    assert out["obs"] == (16, 3, 7, 7, 3) and out["finite"]


def test_hetero_population():
    losses = load_example(EXAMPLE["hetero_population"]).main(
        ["--device", "cpu", "--envs", "8", "--rollout", "4", "--iters", "1"])
    assert len(losses) == 1 and math.isfinite(losses[0])
