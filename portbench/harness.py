"""One run of one cell: find its configuration, traffic, loop, limits and
metric readers by the names in ``BENCHMARK.json``, set the program up,
measure the window, trace a few calls (``--trace 1``), check what the timed
path produced against the plain reference, and return the result line.

Set-up is the program's build, its first ``check_calls`` calls of the
cell's own loop (the eager first call, the capturing second call and one
replay) and then calls for the traffic's ``warmup_seconds``: on the card a
node-heavy graph's replays can run about a fifth slower for the first
seconds of a process, up to 20 s after the capture. The loop keeps what the
reference follows of those calls (and of a window call, where it asks). The
reference runs after the window and after the peak memory is read, once the
program is freed.

On more than one card every rank runs this (``ranks.py`` starts them): the
ranks join one process group, the loop runs over the port's data mesh,
rank 0's clock opens and closes the window for all, and rank 0 gathers the
ranks' numbers, runs the check and returns the line.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import loops, roofline, tracing
from .loops.common import sync

#: top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "marlgrid_tpu")
#: the keys a configuration file may have; the harness refuses others
CONFIG_KEYS = {"name", "source", "deployment", "args", "dtype", "assumed",
               "reduced", "chips"}


def banned_modules(names=None):
    """The banned top-level names among ``names`` (default: the loaded
    modules), each module's name cut at its first dot and compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or, without the key, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(bench_path: Path, name: str):
    """``(cell, config, traffic, limits, end_to_end, per_layer)`` of the
    cell ``name``: its configuration file, and, beside ``BENCHMARK.json``,
    ``portbench/traffic/<traffic>.json``, ``portbench/limits/<name>.json``,
    and the metrics it reports."""
    here = bench_path.parent / "portbench"
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path} (known: "
                       f"{', '.join(sorted(cells))})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(bench_path.parent / configs[cell["config"]]["file"])
    if set(config) - CONFIG_KEYS:
        raise ValueError(f"{configs[cell['config']]['file']}: keys the "
                         f"harness does not read: "
                         f"{sorted(set(config) - CONFIG_KEYS)}")
    traffic = _json(here / "traffic" / f"{cell['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, reported)]
    return cell, config, traffic, limits, e2e, per_layer


def reader(bench_path: Path, name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py`` beside
    ``BENCHMARK.json``."""
    path = bench_path.parent / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ranks:
    """The run's ranks: ``world`` of them, this one ``rank``; ``agree``
    gives rank 0's decision to every rank and ``gather`` every rank's
    object to all, over a gloo group of the harness's own (one card: both
    are local)."""

    def __init__(self, world: int = 1, rank: int = 0):
        self.world, self.rank, self.group = world, rank, None
        if world > 1:
            import torch.distributed as dist

            self.group = dist.new_group(backend="gloo")

    def agree(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.group is None:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def window(prog, seconds: float, ranks: Ranks, dev):
    """Calls until ``seconds`` have passed on rank 0's clock and the loop
    lets the window close, each timed; returns ``(calls, failed,
    window_s)``: ``(enqueued_s, done_s)`` a call, the calls whose values
    were not finite, and the window's wall seconds."""
    calls, failed = [], 0
    t0 = time.perf_counter()
    while True:
        prog.watch(len(calls), False)
        enq, done, values = prog.call()
        prog.watch(len(calls), True)
        calls.append((enq, done))
        failed += not prog.finite(values)
        if ranks.agree(time.perf_counter() - t0 >= seconds
                       and prog.window_done):
            break
    sync(dev)
    return calls, failed, time.perf_counter() - t0


def run_cell(bench_path: Path, name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda", traffic_over=None,
             log=print, rank=0, world=1, init=None):
    """One run of cell ``name``; returns the result line's object (None on
    a rank other than 0). ``log`` takes the lines that go to standard
    error. ``traffic_over`` (tests only) replaces entries of the traffic
    file, to run at a tiny size. ``world`` > 1: this is rank ``rank`` of
    that many, joining the process group at the URL ``init``."""
    cell, config, traffic, limits, e2e, per_layer = load(bench_path, name)
    traffic = dict(traffic, **(traffic_over or {}))
    mod = loops.load(traffic["loop"],
                     bench_path.parent / "portbench" / "loops")
    mesh = None
    if world > 1:
        from marlgrid_tpu_torch.parallel import mesh as mesh_mod

        dev = mesh_mod.init_distributed(device, init, world, rank)
        ranks = Ranks(world, rank)
        mesh = mesh_mod.make_mesh(device=dev)
    else:
        dev, ranks = torch.device(device), Ranks()
    try:
        return _run(bench_path, cell, config, traffic, limits, e2e, per_layer,
                    mod, mesh, ranks, seed, seconds, trace, t_start, dev, log)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _run(bench_path, cell, config, traffic, limits, e2e, per_layer, mod,
         mesh, ranks, seed, seconds, trace, t_start, dev, log):
    cuda = dev.type == "cuda"
    if cuda:
        from marlgrid_tpu_torch.ops import _build
        _build.build_all()
    from marlgrid_tpu_torch.ops import kernel_wrappers

    prog = mod.Program(config, traffic, seed, dev, mesh)
    capture_s = prog.setup(traffic["check_calls"])
    warm = time.perf_counter()
    while not ranks.agree(time.perf_counter() - warm
                          >= traffic.get("warmup_seconds", 0)):
        prog.call()
    peak_setup = torch.cuda.max_memory_reserved(dev) if cuda else 0
    wrappers = kernel_wrappers()
    before = {n: fn.launches for n, fn in wrappers.items()}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    calls, failed, window_s = window(prog, seconds, ranks, dev)
    launches = {n: (fn.launches - before[n]) / len(calls)
                for n, fn in wrappers.items()}
    traced = (tracing.trace_calls(prog.call, traffic["trace_calls"])
              if trace else None)
    peak_window = torch.cuda.max_memory_reserved(dev) if cuda else 0
    # every rank's peak, and its traced busy and window seconds
    per_rank = ranks.gather((max(peak_setup, peak_window), peak_window,
                             None if traced is None
                             else (traced.busy_s, traced.window_s)))
    ctx = SimpleNamespace(
        kind=prog.kind, calls=calls, window_s=window_s, world=ranks.world,
        env_steps_per_call=prog.steps_per_call, setup_s=setup_s,
        capture_s=capture_s, trace=traced, launches=launches,
        peak_window_bytes=max(r[1] for r in per_rank), shape=prog.shape)
    if cuda:
        device_line = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": max(r[0] for r in per_rank)}
    else:
        device_line = {"platform": "cpu", "kind": "cpu",
                       "count": ranks.world, "memory_peak_bytes": 0}
    if traced is not None:
        device_line.update(
            busy_s=sum(r[2][0] for r in per_rank) / ranks.world,
            window_s=sum(r[2][1] for r in per_rank) / ranks.world)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = reader(bench_path, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kept, kind = prog.kept(), prog.kind
    del prog, wrappers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks.rank != 0:
        ranks.agree(True)                   # wait for rank 0's check
        return None
    readings = mod.check(config, traffic, seed, dev, kept)
    ranks.agree(True)
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log(f"window: {len(calls)} calls in {window_s:.3f} s "
        f"({failed} with values not finite); setup {setup_s:.3f} s")
    if kind == "train":
        log(f"train_step_ms_p90 from {len(calls)} calls")
    for k, v in readings.items():
        if k not in checks:
            log(f"reading {k} {v!r}")
    if traced is not None:
        log(f"traced {traced.calls} calls: busy {traced.busy_s!r} s of "
            f"{traced.window_s!r} s on the device's clock, "
            f"{len(traced.ops)} device ops")
        for k, work in roofline.calls(ctx.shape).items():
            secs, n = traced.kernel_s(roofline.KERNELS[k][0])
            log(f"{k}: {sum(c for _, c in work)} calls a call by the shapes,"
                f" {launches.get(roofline.WRAPPERS[k], 0)!r} counted, {n} "
                f"traced in {secs!r} s")
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_line}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result
