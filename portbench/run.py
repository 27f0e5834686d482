"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. The cell's
configuration, traffic, limits and metric readers are found by the names
in ``BENCHMARK.json`` (see ``portbench/README.md``). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit.
The same numbers close standard error. Without as many cards as the cell
asks for, or with ``jax``, ``jaxlib``, ``flax`` or ``marlgrid_tpu`` loaded
once the window has closed, it exits non-zero and prints no result. A cell
on more than one card starts its other ranks itself (``ranks.py``), after
the kernels are built.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by ranks.py for ranks 1 and up
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, ranks

    bench_path = ROOT / "BENCHMARK.json"
    cell = harness.load(bench_path, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def run(rank, world, init):
        return harness.run_cell(
            bench_path, args.workload, args.seed, args.seconds,
            bool(args.trace), T_START, rank=rank, world=world, init=init,
            log=lambda s: print(s, file=sys.stderr, flush=True))

    world = int(cell["chips"])
    if args.rank:
        run(args.rank, args.world, args.init)
        return 0
    if world > 1:
        from marlgrid_tpu_torch.ops import _build
        _build.build_all()              # once, before the ranks start
        own = [sys.executable, str(Path(__file__).resolve()),
               *(argv if argv is not None else sys.argv[1:])]
        with ranks.started(world, lambda r, init: own + [
                "--rank", str(r), "--world", str(world),
                "--init", init]) as init:
            result = run(0, world, init)
    else:
        result = run(0, 1, None)
    bad = harness.banned_modules()
    if bad:
        print(f"portbench: modules loaded that no run may hold: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
