"""Device time by stage in the traced calls: each graph replay's traced ops
put down to the program's ``rollout.*`` / ``update.*`` stages by the stage
map its capture kept (``parallel/graph.py::GraphedStep.stages``: the graph's
device-work nodes in replay order as runs of ``(stage path, node count)``,
and ``node_names``). The matching follows the port's
``utils/profiling.py::match``, frozen here so that the yardstick cannot move
with the program, and goes one step further where the profiler lost records.

A call is the traced device ops from one ``cudaGraphLaunch`` host event to
the next, in start order: the replay's ops, then the call's device-to-host
reads of its metrics (``Memcpy DtoH``). Where the replay's ops are the
map's N nodes, they are the nodes in the map's order, and their names must
line up with the map's. CUPTI loses an activity record now and then in a
replay of 170k nodes (the encode train cell's traced calls read 169,921 and
169,922 ops on the parent and on the program with the stage map alike; a
second graph traced in one process lost each replay's first kernel, and
the first traced replay of a process that had captured many graphs 12 of
30,385): a replay short of the map by at most :data:`LOST` of its nodes is
aligned to the map from both ends by name (:func:`assign`). The earliest alignment
puts each op at the first node its name agrees with, the latest at the
last; the op's true node lies between the two. An op whose two nodes are
in one group is put down to that group; one whose two nodes bound another
group's node is uncertain, and where the uncertain ops hold more than
:data:`UNSURE` of the replay's device time the call gives no reading
(None). Else each op goes to its earliest node, so at most that share of
the time sits in a wrong group, and a lost node takes no time (the trace's
busy time lacks it too). A call with more ops than the map, fewer beyond
``LOST``, ops whose names do not line up, or a short call where the map has
no names gives no reading either, as a roofline share is silent where its
launches disagree. So does a program without stage maps (one from before
them).

Each node belongs to its innermost stage; a stage's path names its
parents. The groups the metrics read, by the stages on a node's path:
``env`` (``rollout.env_step``, ``rollout.fresh_pool``), ``obs``
(``rollout.obs``, ``update.render``), ``policy`` (``rollout.policy``,
``rollout.sample``), ``update`` (the rest of ``update``), and ``other``:
the rest of the step (the root ``step``'s own nodes: the carry copies and
the episode tallies; ``rollout``'s own and ``rollout.store``).
"""
from __future__ import annotations

import bisect
import collections
import functools
import itertools

from .tracing import _function

GROUPS = (("env", ("rollout.env_step", "rollout.fresh_pool")),
          ("obs", ("rollout.obs", "update.render")),
          ("policy", ("rollout.policy", "rollout.sample")),
          ("update", ("update",)))
#: the name of a traced device-to-host copy (the metric reads)
READ = "Memcpy DtoH"
#: the share of the map's nodes a replay's trace may lack (lost records)
LOST = 1e-3
#: the share of a replay's device time that a lost record may leave
#: uncertain between two groups
UNSURE = 1e-3


def group(path) -> str:
    """The group of a node on the stage path ``path``."""
    for name, stages in GROUPS:
        if any(s in stages for s in path):
            return name
    return "other"


def steps():
    """The program's live captured steps (``graph.captured()``), or [] for
    a program without them."""
    try:
        from marlgrid_tpu_torch.parallel import graph
    except ImportError:
        return []
    captured = getattr(graph, "captured", None)
    return [] if captured is None else captured()


def live_map():
    """``(paths, names)`` of the one live captured step: the stage path of
    each node in replay order, and the nodes' names (or None); None unless
    exactly one step holds a map."""
    mapped = [s for s in steps() if getattr(s, "stages", None) is not None]
    if len(mapped) != 1:
        return None
    paths = [tuple(p) for p, n in mapped[0].stages for _ in range(n)]
    return paths, mapped[0].node_names


@functools.lru_cache(maxsize=None)
def _agrees(node: str, op: str) -> bool:
    """Whether the traced op named ``op`` can be the node named ``node``
    (``"memcpy"``, ``"memset"``, a kernel's demangled name, or ``""`` for
    a kernel the CUDA driver gave no name for)."""
    if node in ("memcpy", "memset"):
        # a graph's device-to-device copy may run as the CUDA driver's own
        # kernel ("memcpy32_post")
        return node in op.lower()
    if op.startswith(("Memcpy", "Memset")):
        return False
    return not node or _function(node) == _function(op)


def calls(trace):
    """The traced ops (name, start_ns, end_ns) of each call, in start order:
    from one ``cudaGraphLaunch`` host event to the next."""
    launches = sorted(s for n, s, _ in trace.host if "GraphLaunch" in n)
    out = [[] for _ in launches]
    for op in trace.ops:
        i = bisect.bisect_right(launches, op[1]) - 1
        if i >= 0:
            out[i].append(op)
    for ops in out:
        ops.sort(key=lambda o: o[1])
    return out


def assign(groups, names, replay):
    """The group of each op of ``replay`` (one call's traced ops without
    its trailing reads) by the map's ``groups`` and ``names``, or None
    (module docstring)."""
    n, m = len(groups), len(replay)
    if m == n:
        if names is None or all(_agrees(a, o[0])
                                for a, o in zip(names, replay)):
            return groups
        return None
    if names is None or m > n or n - m > LOST * n:
        return None
    first, i = [], 0
    for o in replay:
        while i < n and not _agrees(names[i], o[0]):
            i += 1
        if i == n:
            return None
        first.append(i)
        i += 1
    last, i = [0] * m, n - 1
    for t in range(m - 1, -1, -1):
        while not _agrees(names[i], replay[t][0]):
            i -= 1
        last[t] = i
        i -= 1
    # changes[x]: how often the group changes along the map's first x + 1
    # nodes
    changes = list(itertools.accumulate(
        (a != b for a, b in zip(groups, groups[1:])), initial=0))
    unsure = sum(e - s for (_, s, e), f, la in zip(replay, first, last)
                 if changes[f] != changes[la])
    if unsure > UNSURE * sum(e - s for _, s, e in replay):
        return None
    return [groups[f] for f in first]


@functools.lru_cache(maxsize=1)
def per_call(trace):
    """``[{group: device seconds}]`` of each traced call's replay, or None
    where any call does not match the live map (module docstring)."""
    m = live_map()
    cs = calls(trace)
    if m is None or not cs:
        return None
    paths, names = m
    groups = [group(p) for p in paths]
    out = []
    for ops in cs:
        k = len(ops)
        while k and ops[k - 1][0].startswith(READ):
            k -= 1
        got = assign(groups, names, ops[:k])
        if got is None:
            return None
        secs = collections.Counter()
        for g, (_, s, e) in zip(got, ops):
            secs[g] += (e - s) * 1e-9
        out.append(secs)
    return out


def ms(trace, name: str):
    """Mean device milliseconds a traced call's replay spent in group
    ``name``, or None."""
    cs = None if trace is None else per_call(trace)
    if cs is None:
        return None
    return 1e3 * sum(c[name] for c in cs) / len(cs)


def ops(name: str):
    """The live map's nodes in group ``name``, or None."""
    m = live_map()
    if m is None:
        return None
    return sum(group(p) == name for p in m[0])
