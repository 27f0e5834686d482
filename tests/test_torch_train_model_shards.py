"""The port's training CLI with ``--distributed --model-shards 2`` on two
gloo ranks (a (1, 2) ('data', 'model') mesh), on the CPU.

As in the JAX CLI, the mesh is ``make_mesh(n_model=2)``: the data axis is
world / 2 = 1 rank, the two ranks of the model group hold the same env
slice (here the whole batch), and the learner state is replicated, so the
two ranks repeat one another's work and log the same metrics, bit for bit,
on the sharded default path, with ``--shard-map``, with ``--rnn`` and with
``--agent-config``. Rank 0 checkpoints the global batch, which one process
resumes. A world size the model axis does not divide exits with JAX's
message (``test_torch_train.py``).
"""
import json

import numpy as np
import pytest

from marlgrid_tpu_torch.parallel import train
from test_torch_train import DIST, FIELDS, HETERO, VIEWS, _two_ranks


@pytest.mark.parametrize("flags,n_envs", [
    (DIST, 16),
    (DIST + ["--shard-map"], 16),
    (DIST + ["--rnn", "gru"], 16),
    (HETERO + ["--agent-config", VIEWS], 8),
], ids=["feedforward", "shard-map", "gru", "hetero"])
def test_cli_model_shards_two_ranks(tmp_path, flags, n_envs):
    from marlgrid_tpu_torch.utils import checkpoint

    ck = tmp_path / "ck"
    recs = _two_ranks(tmp_path, flags + [
        "--model-shards", "2", "--iters", "2", "--checkpoint-dir", str(ck),
        "--checkpoint-every", "2"], "ms")
    assert [r["step"] for r in recs[0]] == [0, 1]
    for a, b in zip(*recs):
        assert set(a) == FIELDS and np.isfinite(a["loss"])
        for k in FIELDS - {"time", "env_steps_per_s", "agent_steps_per_s"}:
            assert a[k] == b[k], k
    rollout = flags[flags.index("--rollout") + 1]
    assert recs[0][-1]["env_steps"] == 2 * n_envs * int(rollout)
    tree = checkpoint.restore(ck, map_location="cpu")
    assert all(v.shape[0] == n_envs for v in tree["env_state"].values())
    log = tmp_path / "r.jsonl"
    train.main(flags + ["--resume", str(ck), "--iters", "1", "--metrics",
                        str(log)])
    rec = json.loads(log.read_text().splitlines()[-1])
    assert np.isfinite(rec["loss"]) and rec["entropy"] > 0
