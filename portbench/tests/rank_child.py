"""A rank other than 0 of a tiny run on the CPU (``test_portbench_ranks.py``
starts it through ``ranks.started``):

    python3 rank_child.py <cell> <seed> <traffic as JSON> <rank> <init>
"""
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:0] = [str(ROOT), str(HERE)]

from conftest import round_once_on_cpu  # noqa: E402
from portbench import harness  # noqa: E402

if __name__ == "__main__":
    cell, seed, traffic, rank, init = sys.argv[1:]
    round_once_on_cpu()
    harness.run_cell(ROOT / "BENCHMARK.json", cell, int(seed), 0.5, False,
                     time.perf_counter(), device="cpu",
                     traffic_over=json.loads(traffic), rank=int(rank),
                     world=2, init=init, log=lambda s: None)
