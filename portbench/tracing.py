"""The traced run: a few calls of the timed path under ``torch.profiler``
(CUPTI on the card), read in memory from the profiler's events (no trace
file is written). The arithmetic follows the port's
``utils/profiling.py`` (device work is the trace's kernels, memcpys and
memsets), frozen here so that the yardstick cannot move with the program.
"""
from __future__ import annotations

import collections

#: the trace's activities that are device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host activities an idle gap is named after
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
#: the profiler's own bookkeeping (CUPTI's buffers): a device gap the host
#: spent in one of these is the profiler's, not the program's
PROFILER = ("Buffer Flush", "Activity Buffer Request", "Command Buffer Full")


def _activity(e) -> str:
    """An event's activity type; torch versions without ``activity_type``
    give device events as "kernel" and the rest as "cpu_op"."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    return "kernel" if e.device_type().name == "CUDA" else "cpu_op"


class Trace:
    """What the traced calls ran, each call traced in a profiler session of
    its own (``sessions``: the events of each): ``ops`` (name, start_ns,
    end_ns) of the device work, ``host`` (name, start_ns, end_ns) of the
    host's ops and of the profiler's own bookkeeping, ``calls`` traced, and
    on the device's clock ``busy_s`` (the union of the device work's
    intervals) and ``window_s``: each session's span from its first device
    op's start to its last one's end, summed, less the device gaps the
    host spent in the profiler's own bookkeeping (:data:`PROFILER`: a
    170k-op replay fills CUPTI's buffers, and their flushes hold the
    device for hundreds of milliseconds a call, which an untraced call
    does not). The host's time outside the spans is in neither."""

    def __init__(self, sessions):
        self.calls = len(sessions)
        self.ops, self.host, self.gaps = [], [], []
        busy = span = 0
        for events in sessions:
            ops = []
            for e in events:
                cat = _activity(e)
                item = (e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns())
                if cat in DEVICE_CATS:
                    ops.append(item)
                elif cat in HOST_CATS or cat == "overhead":
                    self.host.append(item)
            ops.sort(key=lambda x: x[1])
            if ops:
                span += max(e for _, _, e in ops) - ops[0][1]
            end = None
            for _, s, e in ops:
                if end is None or s > end:
                    if end is not None:
                        # (seconds, start_ns, end_ns) the device idled
                        self.gaps.append(((s - end) * 1e-9, end, s))
                    busy += e - s
                    end = e
                elif e > end:
                    busy += e - end
                    end = e
            self.ops += ops
        self.busy_s = busy * 1e-9
        self.profiler_s = sum(sec for sec, name in self._named_gaps()
                              if name in PROFILER)
        self.window_s = span * 1e-9 - self.profiler_s

    def _named_gaps(self):
        """``(seconds, what the host was doing)`` of every idle gap: the
        shortest host op holding the gap's middle."""
        import numpy as np

        if not self.gaps:
            return []
        mids = np.array([(s + e) // 2 for _, s, e in self.gaps])
        order = np.argsort(mids, kind="stable")
        mids = mids[order]
        held = np.full(len(mids), -1)
        # longest first, so that the shortest op holding a middle wins
        for i in sorted(range(len(self.host)),
                        key=lambda i: self.host[i][1] - self.host[i][2]):
            _, s, e = self.host[i]
            lo = np.searchsorted(mids, s, side="left")
            hi = np.searchsorted(mids, e, side="right")
            held[order[lo:hi]] = i
        return [(sec, self.host[h][0] if h >= 0 else "host outside any op")
                for (sec, _, _), h in zip(self.gaps, held.tolist())]

    def idle_share(self) -> float:
        """1 - busy / window on the device's clock: the share of the traced
        calls' spans (each from its first device op's start to its last
        one's end), less the gaps the profiler's bookkeeping held, in which
        no device work ran."""
        return 1.0 - self.busy_s / self.window_s

    def by_name(self):
        """Device seconds per op name (a Counter)."""
        secs = collections.Counter()
        for n, s, e in self.ops:
            secs[n] += (e - s) * 1e-9
        return secs

    def kernel_s(self, base: str):
        """Device seconds and launches of the kernels whose name holds the
        function name ``base`` (a demangled name is its signature)."""
        secs, count = 0.0, 0
        for n, s, e in self.ops:
            if _function(n) == base:
                secs += (e - s) * 1e-9
                count += 1
        return secs, count

    def breakdown(self, top: int = 10):
        """``device_ops``: the names that took most device time;
        ``idle_gaps``: the gaps between device work, summed by what the
        host was doing in each (the shortest host op holding the gap's
        middle)."""
        ops = [[n[:120], s] for n, s in self.by_name().most_common(top)]
        idle = collections.Counter()
        for sec, name in self._named_gaps():
            idle[name[:120]] += sec
        return {"device_ops": ops,
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def _function(name: str) -> str:
    """The bare function name of a demangled kernel name: ``void
    transpose_bk_kernel(int const*, ...)`` -> ``transpose_bk_kernel``;
    ``void compose_kernel<16>(...)`` -> ``compose_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def trace_calls(call, n: int) -> Trace:
    """Run ``call`` ``n`` times, each in a profiler session of its own (host
    and card, the call then a synchronize), so that the profiler's buffers
    start empty for every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sessions = []
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        sessions.append(prof.profiler.kineto_results.events())
    return Trace(sessions)
