"""The train CLI's loop (``python -m marlgrid_tpu_torch.parallel.train``):
``train.build``, ``train.init``, ``train.make_step`` (one CUDA graph of the
whole step a call: the first call eager, the second captures and replays,
every later one replays), each call's metrics read to floats after it, as
the CLI does at its default ``--log-every 1``. Under a mesh, the CLI's
``--distributed`` sharded default path (``make_step(mesh=...)``), which
computes the unsharded step of the global batch.

The check: each of the program's first calls against one reference step
from the state that call started from, and the first start against the
run's inputs (``reference/follow.py::train_readings``,
``start_mismatch``).
"""
from __future__ import annotations

import contextlib
import time

from . import common

KIND = "train"


class Program(common.Program):
    kind = KIND

    def __init__(self, config, traffic, seed, device, mesh=None):
        from marlgrid_tpu_torch.parallel import train

        super().__init__(config, traffic, seed, device, mesh)
        self.step = train.make_step(self.ep, self.cfg, self.net, self.opt,
                                    device, **self.shards)
        self._kept = {"weights": self.weights, "starts": [], "losses": [],
                      "adam": [],
                      "beta1": self.opt.param_groups[0]["betas"][0]}

    def values(self, out):
        return {k: float(v) for k, v in out.items()}

    def setup(self, n: int):
        """The first ``n`` calls, keeping what each starts from, its loss
        and Adam's state after it, and the weights after the last. Returns
        the second call's host seconds (the capture and its first
        replay)."""
        from ..reference import follow

        named = list(self.net.named_parameters())
        capture_s = None
        for i in range(n):
            state, h = self.whole()
            self._kept["starts"].append(follow.snapshot(
                self.net, self.opt, state, self.key, h))
            if i == 1:
                common.sync(self.dev)
                t0 = time.perf_counter()
            _, _, values = self.call()
            if i == 1:
                common.sync(self.dev)
                capture_s = time.perf_counter() - t0
            self._kept["losses"].append(values["loss"])
            self._kept["adam"].append(follow.adam_state(self.opt, named))
        self._kept["final"] = {k: p.detach().clone() for k, p in named}
        return capture_s

    def kept(self):
        return self._kept


def _readings(config, traffic, seed, dev, kept):
    """The reference's step from each call's start against the call, and
    the first start against the run's inputs."""
    from .. import inputs
    from ..reference import follow

    ep, cfg = follow.build(config, traffic, seed)
    with follow.plain_float32():
        ref = follow.follow_calls(ep, cfg, kept["starts"], dev)
    out = follow.train_readings(kept, ref)
    out["start_mismatch"] = follow.start_mismatch(
        ep, cfg, kept, kept["weights"], inputs.make_key(seed, dev),
        follow.stagger(config), dev)
    return out


def check(config, traffic, seed, dev, kept):
    """The program's first calls, each against one reference step from the
    state it started from (the program's weights, Adam state, env state,
    key and carry); the first start against the run's inputs and the start
    the reference makes of them. A reference run from the inputs alone
    drifts from the program within a few calls where a bf16 logit near a
    tie samples another action, so each call is followed from its own
    start, as the acting cell follows each step."""
    return _readings(config, traffic, seed, dev, kept)


def in_place(config, traffic, seed, dev, weights, quant=None, fault=None):
    """The reference (fp8 with ``quant``, with a planted ``fault``) put in
    the program's place for the first calls, checked as a run checks the
    program."""
    from .. import inputs
    from ..reference import follow

    ep, cfg = follow.build(config, traffic, seed)
    with follow.plain_float32():
        with (follow.planted(fault) if fault else contextlib.nullcontext()):
            mine = follow.run_calls(ep, cfg, weights,
                                    inputs.make_key(seed, dev),
                                    follow.stagger(config), dev,
                                    n=traffic["check_calls"], quant=quant)
    mine["weights"] = weights
    return _readings(config, traffic, seed, dev, mine)


#: the faults ``calibrate.py`` plants in the reference put in the
#: program's place
FAULTS = ("half_batch",)
