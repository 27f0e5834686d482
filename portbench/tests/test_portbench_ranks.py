"""A cell on more than one card: its ranks started from the one command
(``ranks.py``), the train loop over the port's data mesh (the CLI's
``--distributed`` default path) and the reference's unsharded step of the
global batch. Here two gloo ranks on the CPU at a tiny size: rank 0 in this
process, rank 1 in a child."""
import json
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, ranks

pytestmark = pytest.mark.usefixtures("cpu_as_card")

HERE = Path(__file__).resolve().parent
CELL = "train.goal_cycle_encode"
#: the global batch, 8 envs a rank; the three checked calls each follow
#: the reference's step of the global batch from the gathered start
TRAFFIC = {"envs": 16, "rollout": 8, "warmup_seconds": 0}


def test_two_ranks_one_line(bench_path):
    seed = 2 ** 33 + 7
    child = [sys.executable, str(HERE / "rank_child.py"), CELL, str(seed),
             json.dumps(TRAFFIC)]
    with ranks.started(2, lambda r, init: child + [str(r), init]) as init:
        r = harness.run_cell(bench_path, CELL, seed, 0.5, False,
                             time.perf_counter(), device="cpu",
                             traffic_over=TRAFFIC, rank=0, world=2,
                             init=init, log=lambda s: None)
    # two ranks sum the loss and the gradients in another order than one
    # rank, so the one-card cell's limits do not apply (a cell on more
    # than one card has its own); every gap stays under a tenth of what
    # the fp8 control reads at this size (loss 2.3e-3, grad 0.13, change
    # 0.014), and the start is exact
    gaps = {k: c["value"] for k, c in r["checks"].items()}
    assert gaps["start_mismatch"] == 0, gaps
    assert gaps["loss_gap"] < 2.3e-4 and gaps["grad_gap"] < 0.013 \
        and gaps["change_gap"] < 1.4e-3, gaps
    assert r["device"]["count"] == 2
    # every env transition of the global batch, once
    rate = r["metrics"]["train_env_steps_per_s"]["value"]
    assert rate > 0 and r["attempted"] >= 1


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1: exit code 3"):
        with ranks.started(2, lambda r, init: [
                sys.executable, "-c", "raise SystemExit(3)"]):
            pass
