"""A tiny CPU rehearsal of every cell: the program's loop, the window, the
metric readers and the reference's check, at a size a test run holds
(the kernels' plain versions stand in for the card's)."""
import json
import shutil
import time

import pytest

from portbench import harness

pytestmark = pytest.mark.usefixtures("cpu_as_card")

TINY = {"train.goal_cycle_encode": {"envs": 16, "rollout": 8},
        "rollout.goal_cycle_encode": {"envs": 32, "rollout": 8},
        "train.social_learning_image_gru": {"envs": 8, "rollout": 4}}
#: no warm-up at a tiny size on the CPU
NO_WARMUP = {"warmup_seconds": 0}


def rehearse(bench_path, cell, seed=2 ** 33 + 5):
    return harness.run_cell(bench_path, cell, seed, 0.5, False,
                            time.perf_counter(), device="cpu",
                            traffic_over=dict(TINY[cell], **NO_WARMUP),
                            log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_rehearsal(bench_path, cell):
    r = rehearse(bench_path, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    _, _, _, limits, ends, _ = harness.load(bench_path, cell)
    assert set(r["metrics"]) == {m["name"] for m in ends}
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(limits)
    for m in r["metrics"].values():
        assert m["value"] > 0


def test_a_cell_added_as_files_and_entries(bench_path, tmp_path):
    """A new configuration, loop, traffic mix and metric, found by their
    names: new files and new entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(bench_path.parent / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(bench_path.read_text())
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "goal_cycle_encode.json").read_text())
    conf.update(name="empty_encode", source="a test's own deployment")
    conf["args"].update(scenario="empty", grid_size=9, agents=2)
    (pb / "configs" / "empty_encode.json").write_text(json.dumps(conf))
    (pb / "loops" / "train_counted.py").write_text(
        "from .train import FAULTS, KIND, check, in_place\n"
        "from .train import Program as _Train\n\n\n"
        "class Program(_Train):\n"
        "    def values(self, out):\n"
        "        return dict(super().values(out), counted=1.0)\n")
    (pb / "traffic" / "train_tiny.json").write_text(json.dumps(
        {"loop": "train_counted", "envs": 8, "rollout": 8, "check_calls": 3,
         "trace_calls": 1}))
    (pb / "limits" / "train.empty_encode.json").write_text(
        (pb / "limits" / "train.goal_cycle_encode.json").read_text())
    (pb / "metrics" / "window_calls.py").write_text(
        "def read(ctx):\n    return len(ctx.calls)\n")
    bench["configs"].append(dict(name="empty_encode",
                                 source=conf["source"],
                                 file="portbench/configs/empty_encode.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="train.empty_encode",
                                   config="empty_encode",
                                   traffic="train_tiny", chips=1,
                                   why="a test"))
    bench["end_to_end"].append(dict(name="window_calls", unit="calls",
                                    better="higher", bound=0.25,
                                    source="host_clock"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "train.goal_cycle_encode" in m["workloads"]:
            m["workloads"].append("train.empty_encode")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell(root / "BENCHMARK.json", "train.empty_encode",
                         11, 0.5, False, time.perf_counter(), device="cpu",
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["window_calls"]["value"] == r["attempted"]
    assert "train_env_steps_per_s" in r["metrics"]
