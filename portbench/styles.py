"""Device time and nodes by observation style in a mixed population's
traced calls: the nodes whose stage path holds one of the program's style
stages (``rollout.obs.pixels``, ``rollout.policy.pixels``,
``update.forward.pixels``, and ``update.render``, which re-renders the
pixel groups alone; or the ``.encode`` stages), put down by the stage map
as ``stages.py`` puts its groups down (``live_map``, ``calls``,
``assign``). The shared board's paint, the sampling, the env engine, the
union's loss and the backward are in neither style. A program without the
style stages gives no reading.
"""
from __future__ import annotations

import functools

from . import stages

STYLES = ("pixels", "encode")


def style(path) -> str:
    """The style of a node on the stage path ``path``, or ``"rest"``."""
    for s in path:
        if s == "update.render" or s.endswith(".pixels"):
            return "pixels"
        if s.endswith(".encode"):
            return "encode"
    return "rest"


def _map():
    """``(styles, names)`` of the live map's nodes, or None where there is
    no map or no node carries a style stage."""
    m = stages.live_map()
    if m is None:
        return None
    paths, names = m
    if not any(s.endswith((".pixels", ".encode")) for p in set(paths)
               for s in p):
        return None
    return [style(p) for p in paths], names


@functools.lru_cache(maxsize=1)
def per_call(trace):
    """``[{style: device seconds}]`` of each traced call's replay, or None
    where any call does not match the live map (``stages.assign``)."""
    m = _map()
    cs = stages.calls(trace)
    if m is None or not cs:
        return None
    groups, names = m
    out = []
    for ops in cs:
        k = len(ops)
        while k and ops[k - 1][0].startswith(stages.READ):
            k -= 1
        got = stages.assign(groups, names, ops[:k])
        if got is None:
            return None
        secs = dict.fromkeys(STYLES + ("rest",), 0.0)
        for g, (_, s, e) in zip(got, ops):
            secs[g] += (e - s) * 1e-9
        out.append(secs)
    return out


def ms(trace, name: str):
    """Mean device milliseconds a traced call's replay spent in style
    ``name``, or None."""
    cs = None if trace is None else per_call(trace)
    if cs is None:
        return None
    return 1e3 * sum(c[name] for c in cs) / len(cs)


def ops(name: str):
    """The live map's nodes in style ``name``, or None."""
    m = _map()
    return None if m is None else sum(s == name for s in m[0])
