"""Acting only: ``ppo.make_rollout`` (policy forward, sampling, env step,
observations, fresh boards) wrapped in ``graph.GraphedStep`` as the train
step wraps it (the first call eager, the second captures and replays),
each call's episode count read to a float after it.

The check: the reference follows the program's first calls and one window
call drawn from the seed step by step with the program's own actions
(``reference/follow.py::follow_rollout``).
"""
from __future__ import annotations

import random

import torch

from . import common

KIND = "rollout"
#: what the reference follows of an acting call
TRAJ = ("obs", "act", "logp", "val", "rew", "done")
#: the window's calls among which the check keeps one
SAMPLED_CALLS = 8
#: the faults ``calibrate.py`` plants in the reference put in the
#: program's place
FAULTS = ("token",)


def _clone_state(state):
    return state.map(lambda t: t.clone())


class Program(common.Program):
    kind = KIND

    def __init__(self, config, traffic, seed, device, mesh=None):
        from marlgrid_tpu_torch.parallel import ppo
        from marlgrid_tpu_torch.parallel.graph import GraphedStep

        if mesh is not None:
            raise ValueError("the acting loop runs on one card")
        super().__init__(config, traffic, seed, device, mesh)
        if self.cfg.rnn:
            raise ValueError("the acting loop is feedforward (a recurrent "
                             "one would be a loop module of its own)")
        rollout = ppo.make_rollout(self.ep, self.cfg, self.net,
                                   device=device)

        def act(env_state, key):
            env_state, key, traj, last_value = rollout(env_state, key)
            out = dict(traj, last_value=last_value,
                       n_episodes=traj["done"].float().sum())
            return env_state, key, out

        self.step = GraphedStep(act, "ppo.make_rollout", "global")
        self.sample = random.Random(seed).randrange(SAMPLED_CALLS)
        self._kept = {"weights": self.weights, "trajs": []}
        self.window_done = False

    def values(self, out):
        return {"n_episodes": float(out["n_episodes"])}

    def _traj(self):
        return {k: self.out[k].clone() for k in TRAJ}

    def setup(self, n: int):
        """The first ``n`` calls, keeping their trajectories and the state
        and key after the last. Returns the second call's host seconds."""
        import time

        capture_s = None
        for i in range(n):
            if i == 1:
                common.sync(self.dev)
                t0 = time.perf_counter()
            self.call()
            if i == 1:
                common.sync(self.dev)
                capture_s = time.perf_counter() - t0
            self._kept["trajs"].append(self._traj())
        self._kept["end"] = (_clone_state(self.state), self.key.clone())
        return capture_s

    def watch(self, i: int, after: bool):
        """Keep the start, trajectory and end of window call
        ``self.sample``; the window may close once it is kept."""
        if i != self.sample:
            return
        if not after:
            self._start = (_clone_state(self.state), self.key.clone())
            return
        self._kept["sampled"] = dict(
            start=self._start, traj=self._traj(),
            end=(_clone_state(self.state), self.key.clone()))
        self.window_done = True

    def kept(self):
        return self._kept


def check(config, traffic, seed, dev, kept):
    """The reference follows the first calls from the run's start and the
    sampled window call from its start: ``env_mismatch`` (envs whose
    observation, reward, done or end state differ) and the widest
    ``sample_gap``, ``logp_gap`` and ``value_gap``."""
    from .. import inputs
    from ..reference import follow

    ep, cfg = follow.build(config, traffic, seed)
    key = inputs.make_key(seed, dev)
    with follow.plain_float32():
        net, _, _ = follow.make_net(ep, cfg, kept["weights"], dev)
        state, key = follow.start(ep, cfg, key, follow.stagger(config), dev)
        runs = [(state, key, kept["trajs"], kept["end"])]
        s = kept.get("sampled")
        if s is not None:
            runs.append((follow.ref_state(s["start"][0]), s["start"][1],
                         [s["traj"]], s["end"]))
        out = dict(env_mismatch=0, sample_gap=0.0, logp_gap=0.0,
                   value_gap=0.0)
        for state, key, trajs, (end_state, end_key) in runs:
            for traj in trajs:
                state, key, r = follow.follow_rollout(ep, cfg, net, state,
                                                      key, traj, dev)
                out["env_mismatch"] += r.pop("env_mismatch")
                for k, v in r.items():
                    out[k] = max(out[k], v)
            out["env_mismatch"] += (follow.state_mismatch(state, end_state)
                                    + int(not torch.equal(key, end_key)))
    return out


def in_place(config, traffic, seed, dev, weights, quant=None, fault=None):
    """The reference (fp8 with ``quant``; with ``fault="token"`` one action
    of the first call altered where it was drawn) put in the program's
    place for the first calls, checked as a run checks them."""
    from .. import inputs
    from ..reference import follow

    ep, cfg = follow.build(config, traffic, seed)
    key = inputs.make_key(seed, dev)
    with follow.plain_float32():
        net, _, _ = follow.make_net(ep, cfg, weights, dev, quant)
        state, k = follow.start(ep, cfg, key, follow.stagger(config), dev)
        trajs = []
        with torch.no_grad():
            for _ in range(traffic["check_calls"]):
                state, k, traj = follow.rollout_call(ep, cfg, net, state, k,
                                                     dev)
                trajs.append({n: traj[n].clone() for n in TRAJ})
    if fault == "token":
        rnd = random.Random(seed)
        t = rnd.randrange(cfg.rollout_len)
        n = rnd.randrange(ep.n_agents)
        b = rnd.randrange(cfg.n_envs)
        a = trajs[0]["act"]
        a[t, n, b] = (a[t, n, b] + 1) % 7
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    del net
    return check(config, traffic, seed, dev,
                 dict(weights=weights, trajs=trajs, end=(state, k)))
