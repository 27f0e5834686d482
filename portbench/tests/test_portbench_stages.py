"""``portbench/stages.py``: the traced calls split at each graph launch and
put down to stages by the program's stage map, on a synthetic trace; and,
on the card (``-m card``), the stage map of a real capture against the
replays' traced ops and the eager call's labels, and every stage metric of
each cell on a traced run at a small size."""
import collections
import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness, stages, tracing

#: one replay's map: (path, count) runs and the nodes' names
MAP = [(("step",), 1), (("step", "rollout", "rollout.env_step"), 2),
       (("step", "rollout", "rollout.obs"), 1),
       (("step", "rollout", "rollout.policy"), 1),
       (("step", "rollout", "rollout.store"), 1),
       (("step", "update", "update.render"), 1),
       (("step", "update", "update.forward"), 1), (("step", "update"), 1),
       (("step",), 1)]
NAMES = ["memcpy", "void env_a(int)", "void env_b<4>(long*)", "void k1(int)",
         "void gemm(float*)", "void cat(int)", "void k3(int)",
         "void gemm(float*)", "void adam(float*)", "memset"]
#: the replay's traced ops: names and durations (ns)
OPS = [("Memcpy DtoD (Device -> Device)", 100), ("void env_a(int)", 1000),
       ("void env_b<4>(long*)", 2000), ("void k1(int)", 300),
       ("void gemm(float*)", 400), ("void cat(int)", 50),
       ("void k3(int)", 600),
       ("void gemm(float*)", 700), ("void adam(float*)", 800),
       ("Memset (Device)", 20)]
READS = [("Memcpy DtoH (Device -> Pageable)", 5)] * 2


class Ev:
    """A profiler event as ``tracing.Trace`` reads one."""

    def __init__(self, name, start, dur, kind):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k


def traced_call(t0, ops, launch=True):
    """One traced call: its graph launch on the host at ``t0`` and ``ops``
    on the device after it, one after another."""
    evs = [Ev("cudaGraphLaunch", t0, 10, "cuda_runtime")] if launch else []
    t = t0 + 20
    for name, dur in ops:
        kind = ("gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset"
                if name.startswith("Memset") else "kernel")
        evs.append(Ev(name, t, dur, kind))
        t += dur + 3
    return evs


@pytest.fixture
def live(monkeypatch):
    """The program's one live step holds ``MAP`` (and ``NAMES``)."""
    step = SimpleNamespace(stages=MAP, node_names=NAMES, first_s=2.5)
    monkeypatch.setattr(stages, "steps", lambda: [step])
    return step


def test_calls_split_at_each_launch_and_add_up(live):
    trace = tracing.Trace([traced_call(0, OPS + READS),
                           traced_call(10 ** 6, OPS + READS)])
    assert [len(c) for c in stages.calls(trace)] == [12, 12]
    got = {g: stages.ms(trace, g)
           for g in ("env", "obs", "policy", "update", "other")}
    assert got == pytest.approx({"env": 3e-3, "obs": 9e-4, "policy": 4e-4,
                                 "update": 1.5e-3, "other": 1.7e-4})
    # the five add up to the busy time, the metric reads left out
    reads = sum(d for _, d in READS) * 2 * 1e-9
    assert sum(got.values()) * 2 * 1e-3 == pytest.approx(
        trace.busy_s - reads)
    assert stages.ops("env") == 2 and stages.ops("other") == 3


@pytest.mark.parametrize("ops,why", [
    (OPS[:-1] + READS, "a call with fewer ops than the map"),
    (OPS + [("void stray(int)", 5)], "a trailing op that is no read"),
    (OPS[:3] + [("void other(int)", 300)] + OPS[4:] + READS,
     "a kernel the map names otherwise"),
    (OPS[:-1] + [("void k(int)", 20)] + READS, "a kernel where a memset is"),
])
def test_a_call_that_does_not_match_gives_none(live, ops, why):
    trace = tracing.Trace([traced_call(0, OPS + READS),
                           traced_call(10 ** 6, ops)])
    assert stages.per_call(trace) is None, why
    assert stages.ms(trace, "env") is None


def test_a_lost_record_is_aligned_by_name(monkeypatch):
    """A replay short of a map of 10,000 nodes by one record (CUPTI lost
    it) is aligned to the map by name: the lost node takes no time. Short
    by more than ``LOST`` of the map, or with a map without names: None."""
    step = SimpleNamespace(stages=MAP * 1000, node_names=NAMES * 1000)
    monkeypatch.setattr(stages, "steps", lambda: [step])
    ops = OPS * 1000
    lost = ops[:5001] + ops[5002:]           # an env_a op of the middle
    trace = tracing.Trace([traced_call(0, lost + READS)])
    assert stages.ms(trace, "env") == pytest.approx(3e-3 * 1000 - 1e-3)
    assert stages.ms(trace, "update") == pytest.approx(1.5e-3 * 1000)
    trace = tracing.Trace([traced_call(0, lost[:-10] + READS)])
    assert stages.per_call(trace) is None
    monkeypatch.setattr(step, "node_names", None)
    trace = tracing.Trace([traced_call(0, lost + READS)])
    assert stages.per_call(trace) is None


#: a block of like-named nodes across the env engine's end and the
#: observations' start, after ``MAP`` two thousand times over
EW = ("void ew(int)", 0)
BLOCK = [(("step", "rollout", "rollout.env_step"), 3),
         (("step", "rollout", "rollout.obs"), 3)]


@pytest.mark.parametrize("drop,ew_ns,want", [
    # the replay's first op (a second traced graph in one process lost it)
    ([0], 1, {"env": 6 + 3e-6, "other": 0.34 - 1e-4}),
    # two records far apart: each op still has one node
    ([5001, 8003], 1, {"env": 6 - 1e-3 + 3e-6, "obs": 1.8 - 3e-4 + 3e-6}),
    # one of six like-named nodes across a group boundary: the op that may
    # be either holds 1,000 ns, under UNSURE of the replay (about 12 ms)...
    ([20002], 1000, {"env": 6 + 3e-3, "obs": 1.8 + 2e-3}),
    # ... or 20,000 ns, over it: no reading
    ([20002], 20000, None),
])
def test_lost_records_are_lined_up_from_both_ends(monkeypatch, drop, ew_ns,
                                                  want):
    """Each op lies between the first node its name agrees with and the
    last; it goes to the first, and where those two are in different
    groups its time is uncertain, which may be at most ``UNSURE`` of the
    replay's."""
    step = SimpleNamespace(stages=MAP * 2000 + BLOCK,
                           node_names=NAMES * 2000 + [EW[0]] * 6)
    monkeypatch.setattr(stages, "steps", lambda: [step])
    ops = OPS * 2000 + [(EW[0], ew_ns)] * 6
    kept = [o for i, o in enumerate(ops) if i not in drop]
    trace = tracing.Trace([traced_call(0, kept + READS)])
    if want is None:
        assert stages.per_call(trace) is None
        return
    for g, v in want.items():
        assert stages.ms(trace, g) == pytest.approx(v), g


def test_without_names_counts_alone(live, monkeypatch):
    monkeypatch.setattr(live, "node_names", None)
    ops = OPS[:3] + [("void other(int)", 300)] + OPS[4:] + READS
    trace = tracing.Trace([traced_call(0, ops)])
    assert stages.ms(trace, "obs") == pytest.approx(9e-4)


@pytest.mark.parametrize("steps", [[], [SimpleNamespace(stages=None)],
                                   [SimpleNamespace(stages=MAP)] * 2])
def test_no_single_map_gives_none(monkeypatch, steps):
    """A program without stage maps (one from before them), or with two
    captured steps: silent."""
    monkeypatch.setattr(stages, "steps", lambda: steps)
    trace = tracing.Trace([traced_call(0, OPS + READS)])
    assert stages.ms(trace, "env") is None and stages.ops("env") is None


def test_the_readers(bench_path, live):
    trace = tracing.Trace([traced_call(0, OPS + READS)])
    ctx = SimpleNamespace(kind="train", trace=trace)
    read = {n: harness.reader(bench_path, n) for n in (
        "stage.env_ms.train", "stage.obs_ms.train", "stage.policy_ms.train",
        "stage.update_ms.train", "stage.other_ms.train",
        "stage.env_ops.train", "stage.env_ms.rollout",
        "setup.first_call_s", "setup.kernels_s")}
    assert read["stage.env_ms.train"](ctx) == pytest.approx(3e-3)
    assert read["stage.env_ops.train"](ctx) == 2
    assert read["stage.env_ms.rollout"](ctx) is None
    assert read["setup.first_call_s"](ctx) == 2.5
    assert read["setup.kernels_s"](ctx) >= 0


def _eager_ops_by_label(events):
    """{innermost label holding the launch: Counter of bare kernel names}
    of an eager call's Chrome-trace events."""
    labels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launch[e["args"]["correlation"]]
        held = [lb for lb in labels if lb[0] <= t <= lb[1]]
        name = min(held, key=lambda lb: lb[1] - lb[0])[2] if held else None
        out[name][_kind(e["cat"], e["name"])] += 1
    return out


def _kind(cat, name):
    """What an op is, as a graph node and a traced op can both say."""
    return {"gpu_memcpy": "memcpy", "gpu_memset": "memset"}.get(
        cat, tracing._function(name))


def _chrome(prof, tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


@pytest.mark.card
def test_stage_map_of_a_capture(card, tmp_path):
    """A small graphed step with two nested stages: the map's node count is
    each traced replay's op count, and each stage's nodes are, by name and
    number, the ops the eager first call launched under its label."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marlgrid_tpu_torch.parallel.graph import GraphedStep, captured
    from marlgrid_tpu_torch.utils import profiling
    from marlgrid_tpu_torch.utils.profiling import stage

    def fn(x, key):
        with stage("outer"):
            y = x * 2
            with stage("outer.inner"):
                y = torch.sin(y) + torch.cumsum(y, 0)
            z = y.sum()
        with stage("tail"):
            w = torch.sort(x).values
        return y + w, key + 1, {"z": z}

    step = GraphedStep(fn, "test.nested")
    x = torch.randn(4096, device=card)
    key = torch.zeros(2, dtype=torch.int64, device=card)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        x, key, m = step(x, key)
        torch.cuda.synchronize()
    eager = _eager_ops_by_label(_chrome(prof, tmp_path, "eager"))
    x, key, m = step(x, key)                     # the capture
    assert step in captured() and step.stages is not None
    with profile(activities=acts) as prof:
        for _ in range(2):
            x, key, m = step(x, key)
            float(m["z"])
        torch.cuda.synchronize()
    events = _chrome(prof, tmp_path, "replays")
    replays = list(profiling._replays(events).values())
    n = sum(c for _, c in step.stages)
    assert len(replays) == 2 and [len(r) for r in replays] == [n, n]
    mapped = collections.defaultdict(collections.Counter)
    for ops in replays:
        paths = profiling.match([e["name"] for e in ops],
                                {"stages": step.stages,
                                 "names": step.node_names})
        assert paths is not None
    it = iter(step.node_names)
    for path, count in step.stages:
        for _ in range(count):
            name = next(it)
            mapped[path[-1]][_kind({"memcpy": "gpu_memcpy",
                                    "memset": "gpu_memset"}.get(name),
                                   name)] += 1
    for label in ("outer", "outer.inner", "tail"):
        assert +mapped[label] == +eager[label], (label, mapped, eager)
    spans = profiling.stage_spans(events, [{"stages": step.stages,
                                           "names": step.node_names}])
    assert {s["args"]["stage"] for s in spans} == {
        "step", "step/outer", "step/outer/outer.inner", "step/tail"}
    assert len(spans) == 2 * 4


#: one traced run of a cell at a small size, in a process of its own as the
#: benchmark runs it; prints the result line with the map's node counts
CHILD = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from portbench import harness, stages
nodes, live_map = [], stages.live_map

def counted():
    m = live_map()
    nodes.append(None if m is None else len(m[0]))
    return m

stages.live_map = counted
r = harness.run_cell(Path(sys.argv[1]) / "BENCHMARK.json", sys.argv[2],
                     3_000_000_019, 2.0, True, time.perf_counter(),
                     device="cuda", traffic_over=json.loads(sys.argv[3]),
                     log=lambda s: print(s, file=sys.stderr))
print(json.dumps(dict(r, nodes=sorted(set(nodes), key=str))))
"""


@pytest.mark.card
@pytest.mark.parametrize("cell,traffic", [
    ("train.goal_cycle_encode", {"envs": 512, "rollout": 16}),
    ("rollout.goal_cycle_encode", {"envs": 2048, "rollout": 8}),
    ("train.social_learning_image_gru", {"envs": 256, "rollout": 8})])
def test_every_stage_metric_on_a_traced_run(bench_path, cell, traffic, card):
    """A traced run of each cell at a small size reports each stage metric
    its cell lists; the five ``stage.*_ms`` add up to the traced busy time
    less the metric reads, and the map with the reads is every traced op."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(bench_path.parent), cell,
         json.dumps(dict(traffic, warmup_seconds=0))],
        check=True, capture_output=True, text=True, timeout=600).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    _, _, traffic_file, _, _, layers = harness.load(bench_path, cell)
    want = {m["name"] for m in layers
            if m["name"].startswith(("stage.", "setup."))}
    got = r["metrics"]
    print(cell, {k: v["value"] for k, v in got.items()})
    assert want <= set(got), want - set(got)
    kind = cell.split(".")[0]
    five = sum(got[f"stage.{g}_ms.{kind}"]["value"]
               for g in ("env", "obs", "policy", "update", "other")
               if f"stage.{g}_ms.{kind}" in got)
    busy_ms = 1e3 * r["device"]["busy_s"] / traffic_file["trace_calls"]
    reads = {"train": 9, "rollout": 1}[kind]
    assert abs(five - busy_ms) < 0.005 * busy_ms, (five, busy_ms)
    assert r["nodes"] == [got[f"graph.device_ops.{kind}"]["value"] - reads]
    assert got[f"stage.env_ops.{kind}"]["value"] > 0
