"""Tracing and profiling hooks (PyTorch port of ``marlgrid_tpu/utils/
profiling.py``).

Thin wrappers over ``torch.profiler``: a context manager that writes a
Chrome/Perfetto trace into a directory, a kernel-time summary read back
from that trace, and a hotspot list that attributes device-kernel time to
the ``record_function`` label around each kernel's launch (the port's
``rollout.*`` / ``update.*`` stages), where the JAX package maps fusions to
source lines through the compiled HLO.

    with profiling.trace("prof"):
        run()
    profiling.hotspots("prof")   # [(ms, label or kernel name), ...]

A trace is ``<out_dir>/trace_<pid>_<n>.pt.trace.json.gz``; the readers take
the newest one in the directory.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import shutil
import time

#: the trace's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start(cuda: bool):
    """A started ``torch.profiler.profile``: CPU activity, and the card's
    with ``cuda``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop(prof, out_dir=None):
    """Stop ``prof`` and, given ``out_dir``, export its trace there
    (gzipped Chrome JSON); returns the trace's path, or None."""
    prof.stop()
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
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


def _events(trace_dir: str):
    files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with gzip.open(files[-1]) as fh:
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
    for e in _work(_events(trace_dir)):
        dur[e.get("name", "")] += e["dur"]
    return dur


def hotspots(trace_dir: str, top: int = 20):
    """Device time attributed to the ``record_function`` label whose span
    on the host holds each kernel's launch (the innermost, if labels
    nest); a kernel launched outside every label (a CUDA graph's replay,
    for one) keeps its own name. For a trace of a CPU run, the labels'
    own host time. Returns [(milliseconds, label or kernel name)] sorted
    descending, at most ``top``."""
    events = _events(trace_dir)
    labels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation")
    agg = collections.Counter()
    work = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not work:
        for st, en, name in labels:
            agg[name] += en - st
        return [(d / 1000.0, s) for s, d in agg.most_common(top)]
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
        t = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        agg[label_of(t) or e.get("name", "")[:50]] += e["dur"]
    return [(d / 1000.0, s) for s, d in agg.most_common(top)]
