"""The train CLI's loop for a mixed-style population (``--agent-config``
with encode and pixel agents, ``parallel/ppo_hetero_mixed.py``): built as
the train loop builds the program (``train.build``, ``train.init``,
``train.make_step``: one CUDA graph of the whole step a call, its metrics
read to floats after it), checked against the mixed trainer's plain
reference (``reference/mixed.py``), which ``reference/cli.py`` does not
follow.

``shape`` adds ``groups``: each observation group's ``style`` ('encode'
or 'pixels'), agent count ``N``, ``view``, ``tile`` and ``torso``, for the
readers of one style's work (:func:`group_shape`).

The run's weights are ``inputs.make_weights`` over the groups' parameter
names (``0.torso0.w0``, ...): the embed tables' names carry the group's
index, so they take the scale of any other matrix (one over the root of
their width), not of their rows.

Calibration: ``calibrate.py --controls 0 --faults 0`` reads the program
through this loop; the control and the planted faults come from
:func:`main`, the reference put in the program's place with
:func:`weights` (``calibrate.py::weights`` builds the shared-policy
reference, which refuses ``--agent-config``):

    python3 -m portbench.loops.train_mixed \
        --workload train.goal_cycle_mixed_styles --controls 3 --faults 3
"""
from __future__ import annotations

import contextlib

from . import train

KIND = "train"
#: the faults :func:`in_place` plants in the reference
FAULTS = ("half_batch",)


class Program(train.Program):
    def __init__(self, config, traffic, seed, device, mesh=None):
        from marlgrid_tpu_torch.parallel import ppo_hetero_mixed

        super().__init__(config, traffic, seed, device, mesh)
        groups = ppo_hetero_mixed.mixed_groups(self.ep)
        self.shape["groups"] = [
            dict(style="encode" if gp.observation_style == "encode"
                 else "pixels", N=len(idxs), view=gp.view_size,
                 tile=gp.view_tile_size,
                 torso=ppo_hetero_mixed.group_cfg(self.cfg, gp).torso)
            for idxs, gp in groups]


def group_shape(shape: dict, group: dict) -> dict:
    """The cell's ``shape`` as one group's (``roofline.py`` and
    ``flops.py`` read it): its agents, view, tile and torso, and ``obs``
    'encode' or 'image'; the encode groups keep the full vocabulary."""
    return dict(shape, N=group["N"], view=group["view"], tile=group["tile"],
                torso=group["torso"], cw=0,
                obs="encode" if group["style"] == "encode" else "image")


def check(config, traffic, seed, dev, kept):
    """Each kept call against one step of the mixed reference from the
    state it started from, and the first start against the run's inputs
    (``reference/mixed.py::readings``)."""
    from ..reference import mixed

    return mixed.readings(config, traffic, seed, dev, kept)


def weights(config, traffic, seed, dev):
    """The run's inputs as the program's nets name them (the reference's
    nets have the same names)."""
    import torch

    from .. import inputs
    from ..reference import mixed
    from ..reference.mgref.parallel import ppo_hetero_mixed

    ep, cfg = mixed.build(config, traffic, seed)
    shell, _ = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device=dev)
    return inputs.make_weights(
        [(n, tuple(p.shape)) for n, p in shell.named_parameters()], seed, dev)


def in_place(config, traffic, seed, dev, weights, quant=None, fault=None):
    """The mixed reference (fp8 with ``quant``, with a planted ``fault``)
    put in the program's place for the first calls, checked as a run
    checks the program."""
    from .. import inputs
    from ..reference import follow, mixed

    ep, cfg = mixed.build(config, traffic, seed)
    with follow.plain_float32():
        with (mixed.planted(fault) if fault else contextlib.nullcontext()):
            mine = mixed.run_calls(ep, cfg, weights,
                                   inputs.make_key(seed, dev),
                                   follow.stagger(config), dev,
                                   n=traffic["check_calls"], quant=quant)
    mine["weights"] = weights
    return mixed.readings(config, traffic, seed, dev, mine)


def main(argv=None):
    """The control and each of :data:`FAULTS` on ``--controls`` and
    ``--faults`` seeds from ``--first-seed`` (``calibrate.py``'s), one JSON
    line each on standard output (and in ``--out``)."""
    import argparse
    import gc
    import json
    import time
    from pathlib import Path

    import torch

    from .. import calibrate, harness
    from ..reference import follow

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=calibrate.FIRST_SEED)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    _, config, traffic, *_ = harness.load(
        Path(__file__).resolve().parents[2] / "BENCHMARK.json",
        args.workload)
    plan = ([("control", i) for i in range(args.controls)]
            + [(f, i) for f in FAULTS for i in range(args.faults)])
    for what, i in plan:
        seed = args.first_seed + i
        t0 = time.perf_counter()
        w = weights(config, traffic, seed, dev)
        r = (in_place(config, traffic, seed, dev, w, quant=follow.fp8)
             if what == "control"
             else in_place(config, traffic, seed, dev, w, fault=what))
        line = json.dumps(dict(workload=args.workload, what=what, seed=seed,
                               seconds=time.perf_counter() - t0, **r))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
