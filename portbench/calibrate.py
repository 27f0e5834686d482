"""The readings a cell's limits are set from, on the card at the cell's own
size, many seeds in one process:

- ``program``: the program's first calls of the cell's loop (the eager
  call, the capture, a replay), checked as a run checks them;
- ``control``: the reference put in the program's place with every operand
  of the policy's products rounded to fp8 (the precision below the
  configuration's bf16);
- each of the loop's ``FAULTS``: ``half_batch`` (train), the reference in
  the program's place with its loss over half of each minibatch; ``token``
  (acting), its trajectory with one action altered where it was drawn.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        [--controls 3] [--faults 3] [--out chiprun_out/calib.jsonl]

Each reading is one JSON line on standard output (and in ``--out``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, inputs, loops  # noqa: E402
from portbench.reference import follow  # noqa: E402

FIRST_SEED = 3_000_000_000


def program(config, traffic, seed, dev):
    """The program's readings on ``seed``: its first calls, checked as a
    run checks them."""
    mod = loops.load(traffic["loop"])
    prog = mod.Program(config, traffic, seed, dev)
    prog.setup(traffic["check_calls"])
    kept = prog.kept()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return mod.check(config, traffic, seed, dev, kept)


def weights(config, traffic, seed, dev):
    """The run's inputs as the program's net names them (the reference's
    net has the same names)."""
    from portbench.reference.mgref.parallel import ppo, ppo_rnn

    ep, cfg = follow.build(config, traffic, seed)
    gen = torch.Generator().manual_seed(0)
    shell = (ppo_rnn.init_state_rnn(ep, cfg, gen, device=dev)[0] if cfg.rnn
             else ppo.init_state(ep, cfg, gen, device=dev)[0])
    return inputs.make_weights(
        [(n, tuple(p.shape)) for n, p in shell.named_parameters()], seed, dev)


def in_place(config, traffic, seed, dev, quant=None, fault=None):
    """The reference (fp8 with ``quant``, with a planted ``fault``) put in
    the program's place, read as a run reads the program."""
    return loops.load(traffic["loop"]).in_place(
        config, traffic, seed, dev, weights(config, traffic, seed, dev),
        quant=quant, fault=fault)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=FIRST_SEED)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA card")
    dev = torch.device("cuda")
    _, config, traffic, *_ = harness.load(ROOT / "BENCHMARK.json",
                                          args.workload)
    from marlgrid_tpu_torch.ops import _build
    _build.build_all()
    out = open(args.out, "a") if args.out else None
    plan = ([("program", i) for i in range(args.seeds)]
            + [("control", i) for i in range(args.controls)]
            + [(fault, i) for fault in loops.load(traffic["loop"]).FAULTS
               for i in range(args.faults)])
    for what, i in plan:
        seed = args.first_seed + i
        t0 = time.perf_counter()
        if what == "program":
            r = program(config, traffic, seed, dev)
        elif what == "control":
            r = in_place(config, traffic, seed, dev, quant=follow.fp8)
        else:
            r = in_place(config, traffic, seed, dev, fault=what)
        line = json.dumps(dict(workload=args.workload, what=what, seed=seed,
                               seconds=time.perf_counter() - t0, **r))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
