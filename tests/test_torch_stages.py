"""The stage spans of ``utils/profiling.py`` on the CPU: ``stage`` outside a
capture is a ``record_function`` label; inside one it records the graph
nodes each stage added (here with a stand-in for ``csrc/graph_nodes.cu``,
which needs the card's driver); ``hotspots`` and ``stage_spans`` read a
trace of graph replays by stage through the map. The card's own checks are
``portbench/tests/test_portbench_stages.py`` (``-m card``)."""
import ctypes
import gzip
import json

import numpy as np
import pytest
import torch

from marlgrid_tpu_torch.utils import profiling
from marlgrid_tpu_torch.utils.profiling import recording, stage


def test_stage_outside_a_capture_is_a_label(tmp_path):
    """As a context manager and as a decorator, a stage is a label that
    the profiler sees and ``hotspots`` names, nested as written."""
    @stage("update.probe")
    def probe():
        return torch.ones(32, 32) @ torch.ones(32, 32)

    with profiling.trace(str(tmp_path)):
        with stage("rollout.probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            probe()
    names = [n for _, n in profiling.hotspots(str(tmp_path))]
    assert "rollout.probe" in names and "update.probe" in names


class FakeNodes:
    """``csrc/graph_nodes.cu``'s functions over a capture the test drives:
    ``add(k)`` captures k kernels named ``k<i>``."""

    def __init__(self):
        self.nodes, self.stage_of, self.current, self.marked = [], [], 0, 0

    def add(self, k):
        self.nodes += [f"void k{len(self.nodes) + i}(int)" for i in range(k)]

    def gn_open(self):
        return 1

    def gn_close(self, rec):
        pass

    def gn_mark(self, rec, stream, stage_id):
        self.stage_of += [self.current] * (len(self.nodes) - self.marked)
        self.marked, self.current = len(self.nodes), stage_id
        return 0

    def gn_finish(self, rec):
        return 0

    def gn_count(self, rec):
        return len(self.stage_of)

    def gn_nodes(self, rec, stage_ptr, name_ptr):
        for ptr, values in ((stage_ptr, self.stage_of),
                            (name_ptr, range(len(self.stage_of)))):
            a = np.asarray(values, np.int32)
            ctypes.memmove(ptr, a.ctypes.data, a.nbytes)

    def gn_name_count(self, rec):
        return len(self.stage_of)

    def gn_name(self, rec, i):
        return self.nodes[i].encode()


def test_recorder_puts_each_node_in_its_innermost_stage(monkeypatch):
    """Nodes go to the innermost open stage; a parent keeps the nodes
    outside its children; the map is runs of (path, count) in order."""
    fake = FakeNodes()
    monkeypatch.setattr(profiling, "_graph_nodes", lambda: fake)
    rec = profiling.StageRecorder(type("S", (), {"cuda_stream": 0})())
    with recording(rec):
        with stage("step"):
            fake.add(1)
            with stage("rollout"):
                fake.add(2)
                with stage("rollout.env_step"):
                    fake.add(3)
                fake.add(1)
            with stage("update"):
                with stage("update.forward"):
                    fake.add(2)
            fake.add(1)
        stages, names = rec.finish()
    assert stages == [(("step",), 1), (("step", "rollout"), 2),
                      (("step", "rollout", "rollout.env_step"), 3),
                      (("step", "rollout"), 1),
                      (("step", "update", "update.forward"), 2),
                      (("step",), 1)]
    assert names == fake.nodes and rec.error is None
    # outside the recording, a stage records nothing
    with stage("step"):
        fake.add(1)
    assert fake.gn_count(None) == 10


#: one replay's ops (name, µs): a memcpy, five kernels, a memset
OPS = [("Memcpy DtoD (Device -> Device)", 4), ("void a(int)", 10),
       ("void b<2>(float*)", 20), ("void b<2>(float*)", 30),
       ("void c(int)", 5), ("void d(int)", 7), ("Memset (Device)", 2)]
MAP = {"stages": [[["step"], 1], [["step", "rollout", "rollout.env_step"], 3],
                  [["step", "rollout"], 1],
                  [["step", "update", "update.forward"], 1], [["step"], 1]],
       "names": ["memcpy", "void a(int)", "void b<2>(float*)",
                 "void b<2>(float*)", "", "d(int)", "memset"]}


def _write_trace(tmp_path, stage_map):
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
               "ts": 100.0, "dur": 5.0, "args": {"correlation": 7}}]
    ts = 110.0
    for name, dur in OPS:
        events.append({"ph": "X", "cat": ("gpu_memcpy" if "Memcpy" in name
                                          else "gpu_memset" if "Memset" in
                                          name else "kernel"),
                       "name": name, "ts": ts, "dur": float(dur), "pid": 0,
                       "tid": 7, "args": {"correlation": 7}})
        ts += dur + 1
    base = tmp_path / "trace_1_2"
    with gzip.open(f"{base}.pt.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    with gzip.open(f"{base}.stages.json.gz", "wt") as fh:
        json.dump([stage_map], fh)
    return events


@pytest.mark.parametrize("stage_map,expected", [
    # innermost stage; a parent's self time (rollout's own op, the root's
    # memcpy and memset); nested scopes two deep
    (MAP, {"step": 0.006, "rollout.env_step": 0.060, "rollout": 0.005,
           "update.forward": 0.007}),
    # a map without names: counts alone
    (dict(MAP, names=None), {"step": 0.006, "rollout.env_step": 0.060,
                             "rollout": 0.005, "update.forward": 0.007}),
    # counts disagree: the kernel names, as without a map
    (dict(MAP, stages=MAP["stages"] + [[["step"], 1]], names=None),
     {"void b<2>(float*)": 0.050, "void a(int)": 0.010, "void d(int)": 0.007,
      "void c(int)": 0.005, "Memcpy DtoD (Device -> Device)": 0.004,
      "Memset (Device)": 0.002}),
    # names disagree (a kernel where the map has a memset): the same
    (dict(MAP, names=MAP["names"][:-1] + ["d(int)"]),
     {"void b<2>(float*)": 0.050, "void a(int)": 0.010, "void d(int)": 0.007,
      "void c(int)": 0.005, "Memcpy DtoD (Device -> Device)": 0.004,
      "Memset (Device)": 0.002}),
])
def test_hotspots_by_stage(tmp_path, stage_map, expected):
    _write_trace(tmp_path, stage_map)
    got = dict((n, ms) for ms, n in profiling.hotspots(str(tmp_path)))
    assert got == pytest.approx(expected)


def test_stage_spans_nest_over_the_replay():
    """One span per stage occurrence, from its first op's start to its last
    op's end, on the ops' row, at each depth of the path."""
    events = []
    ts = 110.0
    for name, dur in OPS:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": float(dur), "pid": 0, "tid": 7,
                       "args": {"correlation": 7}})
        ts += dur + 1
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": 100.0, "dur": 5.0, "args": {"correlation": 7}})
    spans = profiling.stage_spans(events, [dict(MAP, names=None)])
    got = sorted((s["args"]["stage"], s["ts"], s["ts"] + s["dur"])
                 for s in spans)
    assert got == [("step", 110.0, 194.0), ("step/rollout", 115.0, 183.0),
                   ("step/rollout/rollout.env_step", 115.0, 177.0),
                   ("step/update", 184.0, 191.0),
                   ("step/update/update.forward", 184.0, 191.0)]
    assert all((s["pid"], s["tid"], s["cat"]) == (0, 7, profiling.SPAN_CAT)
               for s in spans)
    # a map that does not match the replay adds none
    assert profiling.stage_spans(
        events, [dict(MAP, stages=MAP["stages"][1:], names=None)]) == []


#: a map of 10,000 nodes: ``MAP``'s seven nodes 1,428 times over, then
#: four like-named kernels across the end of ``rollout.env_step`` and the
#: start of ``update.forward``
BIG = {"stages": MAP["stages"] * 1428
       + [[["step", "rollout", "rollout.env_step"], 2],
          [["step", "update", "update.forward"], 2]],
       "names": MAP["names"] * 1428 + ["void e(int)"] * 4}
BIG_OPS = [n for n, _ in OPS] * 1428 + ["void e(int)"] * 4


@pytest.mark.parametrize("drop,e_us,want", [
    # nothing lost: every op at its node
    ([], 1, "exact"),
    # the first op lost: the rest one node on
    ([0], 1, {t: t + 1 for t in range(9995)}),
    # a kernel of the middle lost: the ops before it at their nodes, the
    # ops after it one node on
    ([5001], 1, {5000: 5000, 5001: 5002, 9995: 9996}),
    # one of the four like-named kernels: the op that may be either stage
    # holds 1 µs of about 111 ms, under UNSURE, and goes to its first node
    ([9997], 1, {9996: 9996, 9997: 9997, 9998: 9998}),
    # ... 200 µs, over UNSURE: no stage
    ([9997], 200, None),
    # more lost than LOST of the map: no stage
    (list(range(100, 1200, 100)), 1, None),
])
def test_match_lines_up_lost_records(drop, e_us, want):
    """A replay whose trace lost records is lined up with the map from both
    ends by name; each op goes to the first node it can be, unless the ops
    that could be in another stage hold more than ``UNSURE`` of the time."""
    paths = [tuple(p) for p, n in BIG["stages"] for _ in range(n)]
    durs = [d for _, d in OPS] * 1428 + [e_us] * 4
    keep = [t for t in range(len(BIG_OPS)) if t not in drop]
    got = profiling.match([BIG_OPS[t] for t in keep], BIG,
                          [durs[t] for t in keep])
    if want is None:
        assert got is None
    elif want == "exact":
        assert got == paths
    else:
        assert got is not None and len(got) == len(keep)
        for t, node in want.items():
            assert got[t] == paths[node], t
