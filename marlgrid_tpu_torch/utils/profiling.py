"""Tracing and profiling hooks (PyTorch port of ``marlgrid_tpu/utils/
profiling.py``).

Thin wrappers over ``torch.profiler``: the trainers' stage spans
(:func:`stage`: ``rollout.*``, ``update.*``), a context manager that writes a
Chrome/Perfetto trace into a directory, a kernel-time summary read back
from that trace, and a hotspot list that attributes device time to stages,
where the JAX package maps fusions to source lines through the compiled HLO.

A stage is a ``record_function`` label, and a captured CUDA graph
(``parallel/graph.py``) remembers which of its nodes each stage added
(:class:`StageRecorder`), so a trace of graph replays, which run no Python
and carry no labels, is still read by stage: :func:`stop` writes the stage
maps of the process's captured steps beside the trace and adds one span per
stage occurrence to the trace's device rows, and :func:`hotspots` puts each
replayed op down to its stage (:func:`match`, which also lines up a replay
whose trace lost a few records).

    with profiling.trace("prof"):
        run()
    profiling.hotspots("prof")   # [(ms, stage or kernel name), ...]

A trace is ``<out_dir>/trace_<pid>_<n>.pt.trace.json.gz``, its stage maps
``trace_<pid>_<n>.stages.json.gz``; the readers take the newest trace in
the directory.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import functools
import glob
import gzip
import itertools
import json
import os
import shutil
import threading
import time

from torch.profiler import record_function

#: the trace's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the trace's category of the stage spans :func:`stop` adds
SPAN_CAT = "gpu_user_annotation"
#: the share of a map's nodes a replay's trace may lack (CUPTI's lost
#: records) and still be lined up with the map (:func:`match`)
LOST = 1e-3
#: the share of a replay's device time that lost records may leave
#: uncertain between two stages before :func:`match` gives up
UNSURE = 1e-3
_TRACE = ".pt.trace.json"
_STAGES = ".stages.json.gz"

#: the :class:`StageRecorder` of the capture this thread runs, if any
_active = threading.local()


@contextlib.contextmanager
def stage(name: str):
    """The stage span ``name``: a ``record_function`` label, and inside a
    capture that :func:`recording` records, the graph nodes the span adds
    under its parent stage. Also a decorator."""
    rec = getattr(_active, "rec", None)
    with record_function(name):
        if rec is None:
            yield
            return
        rec.enter(name)
        try:
            yield
        finally:
            rec.exit()


@contextlib.contextmanager
def recording(rec: "StageRecorder"):
    """:func:`stage` spans in this thread record into ``rec``."""
    _active.rec = rec
    try:
        yield rec
    finally:
        _active.rec = None


#: gn_mark's own errors (the CUDA driver's CUresult codes are positive)
_ERRORS = {-1: "the CUDA driver's graph functions were not found",
           -2: "the stream is not capturing",
           -3: "the stream captures another graph"}


@functools.lru_cache(maxsize=None)
def _graph_nodes():
    """``csrc/graph_nodes.cu``'s library, its functions declared."""
    from ..ops import _build

    lib = _build.load("graph_nodes")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, res, args in (("gn_open", ptr, []), ("gn_close", None, [ptr]),
                          ("gn_mark", i32, [ptr, ptr, i32]),
                          ("gn_finish", i32, [ptr]),
                          ("gn_count", ctypes.c_int64, [ptr]),
                          ("gn_nodes", None, [ptr, ptr, ptr]),
                          ("gn_name_count", i32, [ptr]),
                          ("gn_name", ctypes.c_char_p, [ptr, i32])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


class StageRecorder:
    """Which graph nodes each :func:`stage` added to the capture on
    ``stream`` (``csrc/graph_nodes.cu``): each node goes to the innermost
    stage open when it was captured, named by its path from the root stage
    (``("step", "rollout", "rollout.env_step")``), or ``()`` outside every
    stage. :meth:`finish`, inside the capture, gives the map. ``error``:
    why there is none (the first call into the CUDA driver that failed), else
    None."""

    def __init__(self, stream):
        self._lib = _graph_nodes()
        self._rec = self._lib.gn_open()
        self._stream = stream.cuda_stream
        self._stack = [()]
        self._ids = {(): 0}
        self.error = None

    def _mark(self, path):
        if self.error is not None:
            return
        e = self._lib.gn_mark(self._rec, self._stream,
                              self._ids.setdefault(path, len(self._ids)))
        if e:
            self.error = f"gn_mark: {_ERRORS.get(e, f'CUresult {e}')}"

    def enter(self, name: str):
        self._stack.append(self._stack[-1] + (name,))
        self._mark(self._stack[-1])

    def exit(self):
        self._stack.pop()
        self._mark(self._stack[-1])

    def finish(self):
        """``(stages, names)``: the capture's device-work nodes (kernels,
        memcpys, memsets) in replay order as runs ``[(stage path, node
        count), ...]``, and each node's name (a kernel's demangled name,
        ``"memcpy"``, ``"memset"``, or ``""`` where the CUDA driver gave none);
        ``(None, None)`` after an error."""
        import numpy as np

        if self.error is not None:
            return None, None
        lib = self._lib
        e = lib.gn_finish(self._rec)
        if e:
            self.error = f"gn_finish: {_ERRORS.get(e, f'CUresult {e}')}"
            return None, None
        n = lib.gn_count(self._rec)
        stage_ids = np.empty(n, np.int32)
        name_ids = np.empty(n, np.int32)
        lib.gn_nodes(self._rec, stage_ids.ctypes.data, name_ids.ctypes.data)
        table = [lib.gn_name(self._rec, i).decode()
                 for i in range(lib.gn_name_count(self._rec))]
        paths = {i: p for p, i in self._ids.items()}
        cut = np.flatnonzero(np.diff(stage_ids)) + 1
        starts, ends = np.r_[0, cut], np.r_[cut, n]
        stages = [(paths[int(stage_ids[s])], int(e - s))
                  for s, e in zip(starts.tolist(), ends.tolist()) if e > s]
        names = [table[i] for i in name_ids.tolist()]
        return stages, names

    def close(self):
        self._lib.gn_close(self._rec)


def start(cuda: bool):
    """A started ``torch.profiler.profile``: CPU activity, and the card's
    with ``cuda``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stage_maps():
    """The stage map of every live captured step of the process:
    ``[{"name", "stages": [[path, count], ...], "names": [...]}]``."""
    from ..parallel import graph

    return [{"name": s.name, "stages": [[list(p), n] for p, n in s.stages],
             "names": s.node_names}
            for s in graph.captured() if s.stages is not None]


def stop(prof, out_dir=None):
    """Stop ``prof`` and, given ``out_dir``, export its trace there
    (gzipped Chrome JSON); returns the trace's path, or None. Where the
    process holds captured steps with stage maps, the maps go beside the
    trace and each graph replay the trace holds gets one span per stage
    occurrence on its device row (:func:`stage_spans`)."""
    prof.stop()
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}")
    path = base + _TRACE
    prof.export_chrome_trace(path)
    maps = _stage_maps()
    if maps:
        with open(path) as fh:
            data = json.load(fh)
        data["traceEvents"] += stage_spans(data["traceEvents"], maps)
        with gzip.open(path + ".gz", "wt") as fh:
            json.dump(data, fh)
        with gzip.open(base + _STAGES, "wt") as fh:
            json.dump(maps, fh)
    else:
        with open(path, "rb") as fin, gzip.open(path + ".gz", "wb") as fout:
            shutil.copyfileobj(fin, fout)
    os.remove(path)
    return path + ".gz"


@contextlib.contextmanager
def trace(out_dir: str):
    """``with profiling.trace('prof'): run()`` -> a trace in ``prof``, of
    the card's activity too when torch sees a card."""
    import torch

    prof = start(torch.cuda.is_available())
    try:
        yield prof
    finally:
        stop(prof, out_dir)


def _newest(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, f"*{_TRACE}.gz")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return files[-1]


def _events(path: str):
    with gzip.open(path) as fh:
        data = json.load(fh)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def _work(events):
    """The device work of a trace, or, for a trace without any (a CPU
    run), its CPU ops."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    return dev or [e for e in events if e.get("cat") == "cpu_op"]


def kernel_times(trace_dir: str):
    """Total device time per kernel name (µs, a Counter) from the newest
    trace in ``trace_dir``; for a trace of a CPU run, the CPU ops' time
    (which nest: an op's time includes the ops it calls)."""
    dur = collections.Counter()
    for e in _work(_events(_newest(trace_dir))):
        dur[e.get("name", "")] += e["dur"]
    return dur


def _function(name: str) -> str:
    """The bare function name of a demangled kernel name: ``void
    transpose_bk_kernel(int const*, ...)`` -> ``transpose_bk_kernel``;
    ``void compose_kernel<16>(...)`` -> ``compose_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


@functools.lru_cache(maxsize=None)
def _agrees(node: str, op: str) -> bool:
    """Whether the traced op named ``op`` can be the graph node named
    ``node`` (a :class:`StageRecorder` name)."""
    if node in ("memcpy", "memset"):
        # a graph's device-to-device copy may run as the CUDA driver's own
        # kernel ("memcpy32_post")
        return node in op.lower()
    if op.startswith(("Memcpy", "Memset")):
        return False
    return not node or _function(node) == _function(op)


def match(ops, stage_map, durs=None):
    """The stage path of each of ``ops`` (one graph replay's device ops'
    names, in start order) by the map ``{"stages", "names"}``, or None.
    Ops as many as the map's nodes must agree with their names. A replay
    short of the map by at most :data:`LOST` of its nodes (records the
    trace lost) is lined up from both ends by name: each op lies between
    the first node it can be and the last, and goes to the first; where
    those two bound another stage's node the op's stage is uncertain, and
    the uncertain ops may hold at most :data:`UNSURE` of the replay's time
    (``durs``, each op's; by default each op counts the same)."""
    paths = [tuple(p) for p, n in stage_map["stages"] for _ in range(n)]
    names = stage_map["names"]
    n, m = len(paths), len(ops)
    if m == n:
        if names is None or all(_agrees(a, b) for a, b in zip(names, ops)):
            return paths
        return None
    if names is None or m > n or n - m > LOST * n:
        return None
    first, i = [], 0
    for op in ops:
        while i < n and not _agrees(names[i], op):
            i += 1
        if i == n:
            return None
        first.append(i)
        i += 1
    last, i = [0] * m, n - 1
    for t in range(m - 1, -1, -1):
        while not _agrees(names[i], ops[t]):
            i -= 1
        last[t] = i
        i -= 1
    # changes[x]: how often the stage changes along the map's first x + 1
    # nodes
    changes = list(itertools.accumulate(
        (a != b for a, b in zip(paths, paths[1:])), initial=0))
    durs = [1] * m if durs is None else durs
    unsure = sum(d for d, f, la in zip(durs, first, last)
                 if changes[f] != changes[la])
    if unsure > UNSURE * sum(durs):
        return None
    return [paths[f] for f in first]


def _replays(events):
    """``{correlation: [device events in start order]}`` of each graph
    launch the trace holds."""
    graph_launches = {e["args"]["correlation"] for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "GraphLaunch" in e.get("name", "")
                      and "correlation" in e.get("args", {})}
    out = collections.defaultdict(list)
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and c in graph_launches:
            out[c].append(e)
    for ops in out.values():
        ops.sort(key=lambda e: e["ts"])
    return out


def _replay_paths(ops, maps):
    """The stage path of each op of a replay by the first map it matches,
    or None."""
    names = [e.get("name", "") for e in ops]
    durs = [e["dur"] for e in ops]
    for m in maps:
        paths = match(names, m, durs)
        if paths is not None:
            return paths
    return None


def stage_spans(events, maps):
    """One Chrome-trace span per stage occurrence in each graph replay of
    ``events`` that a stage map matches: from its first op's start to the
    end of its last, on the row of the replay's ops, a depth of nesting a
    level of the stage path."""
    spans = []
    for ops in _replays(events).values():
        paths = _replay_paths(ops, maps)
        if paths is None:
            continue
        for depth in range(1, max(map(len, paths)) + 1):
            i = 0
            while i < len(ops):
                key = paths[i][:depth]
                j = i
                while j < len(ops) and paths[j][:depth] == key:
                    j += 1
                if len(key) == depth:
                    end = max(e["ts"] + e["dur"] for e in ops[i:j])
                    spans.append({
                        "ph": "X", "cat": SPAN_CAT, "name": key[-1],
                        "pid": ops[i].get("pid"), "tid": ops[i].get("tid"),
                        "ts": ops[i]["ts"], "dur": end - ops[i]["ts"],
                        "args": {"stage": "/".join(key), "ops": j - i}})
                i = j
    return spans


def _read_maps(trace_path: str):
    path = trace_path[:-len(_TRACE + ".gz")] + _STAGES
    if not os.path.exists(path):
        return []
    with gzip.open(path, "rt") as fh:
        return json.load(fh)


def hotspots(trace_dir: str, top: int = 20):
    """Device time by stage, from the newest trace in ``trace_dir``: each
    op of a graph replay that a stage map beside the trace matches goes to
    its innermost stage (:func:`match`; a stage's own time is its ops
    outside every child stage); any other op to the ``record_function``
    label whose span on the host holds its launch (the innermost, if
    labels nest), or, launched outside every label, to its own name. For a
    trace of a CPU run, the labels' own host time. Returns [(milliseconds,
    name of the stage, label or kernel)] sorted descending, at most
    ``top``."""
    path = _newest(trace_dir)
    events = _events(path)
    labels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation")
    agg = collections.Counter()
    work = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not work:
        for st, en, name in labels:
            agg[name] += en - st
        return [(d / 1000.0, s) for s, d in agg.most_common(top)]
    maps = _read_maps(path)
    staged = set()
    for ops in _replays(events).values():
        paths = _replay_paths(ops, maps)
        if paths is None:
            continue
        for e, p in zip(ops, paths):
            agg[p[-1] if p else e.get("name", "")[:50]] += e["dur"]
            staged.add(id(e))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    starts = [s for s, _, _ in labels]
    # the latest end among the spans up to each one: no span before i can
    # hold t once this falls below t
    reach = list(itertools.accumulate((en for _, en, _ in labels), max))

    def label_of(t):
        """The innermost label holding t: of the spans that start at or
        before t and end at or after it, the one that starts last."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if labels[i][1] >= t:
                return labels[i][2]
            i -= 1
        return None

    for e in work:
        if id(e) in staged:
            continue
        t = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        agg[label_of(t) or e.get("name", "")[:50]] += e["dur"]
    return [(d / 1000.0, s) for s, d in agg.most_common(top)]
