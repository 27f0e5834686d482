#!/usr/bin/env python3
"""Smoke run of the PyTorch port (marlgrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--json PATH]

Needs one CUDA card (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports nothing of JAX. Phases, each raising on failure:

1. build every kernel from marlgrid_tpu_torch/csrc/ (one nvcc per source,
   in parallel) and print the build seconds and ptxas' report;
2. K1 (transpose_bk) against its plain version, bit-exact;
2b. the threefry2x32 hash (``ops/threefry.py``) against the plain hash of
   the same draw, bit-equal, at every caller shape of ``core/rng.py`` at
   the benchmark's widths (fold_in of an int, of a datum per key and of
   one key by B ids; split of one key or of B keys; random bits over the
   iota and over a rank's part of a draw; strided key views), eagerly and
   replayed in one CUDA graph, then timed beside its bound; the train
   phase prints its launches per eager step, which the other phases'
   launch checks leave out;
3. K2f (onehot_embed forward) against its plain version computed in
   float32 and rounded to bf16, within 1 bf16 ulp, at the rollout's and
   the update's shapes with both vocabularies and at odd shapes (R = 3,
   S = 100 and 4097, H = 24 and 136), two launches bit-equal; K2b (its weight
   gradient) against its plain version at the update's shape, both fed the
   same bf16 dout, within 1e-3 of max |dW|, deterministic, and reached
   through the embed's autograd Function; K3 (compose_image_b, the sprite
   composite) against its plain version, bit-exact, on the ids of real
   views (goal_cycle at the rollout's shape, cluttered, doorkey with hidden
   keys and a view offset; prestige over all 8 levels) in the standard,
   (N, B) and s2d layouts, and on random ids in its other variants;
   K5f (onehot_embed2, the plane-major embed, float32 out; K2f's
   tensor-core kernel over three tables) against its plain version at the
   same shapes as K2f within 1e-5 of max |out|, two launches bit-equal,
   and K5b (its three tables' gradients; K2b's tensor-core kernel with a
   reduce into the three tables) at the update's shape and at K2b's odd
   shapes within 1e-3 of max |dW_p|, deterministic, through its autograd
   Function; the four embed kernels and K6 also at a hetero 5x5 view
   group's rollout and update shapes (25 cells, the full vocabulary);
3b. the host path's shapes: K1 at B = 1, K2f and K5f at S in {1, 2, 4}
   samples of R in {1, 2, 4} rows, K3 at B = 1 with 16- and 8-pixel tiles,
   each against its plain version, and timed there;
4. the env engine and the observations (encode and image) on the card
   against the same code on the CPU (which the tests hold bit-equal to the
   JAX package), the mlp and cnn_s2d policies' logits on the card against
   the CPU's, and a small float32 train step of each path (feedforward
   encode and image; recurrent: GRU encode on the plane-major embed, LSTM
   encode, GRU image): the card's rollout and update against the CPU's
   update of the same trajectory from the same weights; then the same for
   one step of each heterogeneous population (all-encode views 7/5/7/5,
   with a GRU on the plane-major embed, and encode + image groups, the
   image group held to the float32 image step's bounds), and of the row
   store (float32: the encode 'cnn' torso, and image obs with
   ``recompute_image_obs=False``); and the device
   ops and time that the single-rounding reward decay and prestige update
   (``core/step.py::fma_f32``) cost beside the per-op formulas;
5. the rollout path: a PPO rollout at the train default's full width
   (goal_cycle 13x13, 4 agents, 7x7 encode, B = 4096, T = 64, hidden 128,
   board pool 256, stagger, the compact embed palettes) through
   ``make_rollout``, with the launch counts read around it; then the K4
   probe (``transpose_traj``) on its trajectory, bit-exact against the
   plain version there and, in uint8 and int32, on a hetero 5x5 group's
   trajectory, odd shapes, a B off the 16-byte vector, a data pointer off
   16-byte alignment, 75,000 planes and wide F, two launches bit-equal;
   timed at the encode and 5x5 trajectories and the encode shape in int32;
6. the train path: the eager ``make_train_step(..., jit=False)`` at the
   same width (2 epochs x 4 minibatches), two train steps, with the
   launch counts of K1, K2f, K2b and K3 read around each (65 / 73 / 8 / 0)
   and train env-steps/s; then the training CLI at its defaults but
   T = 32 (depth, as every CLI phase) with ``--steps-per-call 2``
   (graphed: ``ppo.multi_step``), two calls with a checkpoint and one
   resumed from it (its 2 steps: 66 / 82 / 16), and a
   checkpoint the CLI wrote on the CPU (tiny) resumed on the card;
7. the image train path at the same width (``--obs image``: 7x7 views of
   8-pixel tiles, the cnn_s2d torso, re-rendered minibatches): one rollout
   (65 launches each of K1 and K3) and two eager train steps (73 each,
   K2f and K2b none), with train env-steps/s, each step's mean episode
   return and the peak device memory; then the CLI with ``--obs image``
   (graphed), two iterations with a checkpoint and one resumed from it;
8. the recurrent train paths at the same width: ``--rnn gru`` with the
   plane-major embed (``MARLGRID_TPU_EMBED_V2=1``), two eager train steps
   with 65 / 73 / 8 launches of K1 / K5f / K5b and none of K2f, K2b, K3 per
   step, and ``--rnn gru --obs image``, two steps with 73 each of K1 and
   K3; each with train env-steps/s, its losses and its peak device memory;
   then the ``--rnn gru`` CLI (graphed), two iterations with a checkpoint
   (the carry included) and one resumed from it;
8b. the heterogeneous populations at the same width (``--agent-config``,
   the JAX perf gate's specs, no palettes): views 7/5/7/5 (K1 130, K2f
   146, K2b 16 per step: two groups), the same with ``--rnn gru`` on the
   plane-major embed (K1 130, K5f 146, K5b 16) and encode + image agents
   at T = 32 (K1 74, K2f 41, K2b 8, K3 41), two eager train steps each
   with train env-steps/s and peak memory, and each embed kernel held
   against its plain version on the first step's own codes, tables and
   output gradients; then the ``--agent-config`` CLI (graphed) with a
   resume;
8a. the row store at the same width: ``--torso cnn`` (channels (32, 64))
   and image obs with ``recompute_image_obs=False`` (cnn_s2d), one
   rollout each (K1 65, K3 65 on image rows, every other kernel none; the
   stored (T, B*N, F) uint8 rows and their bytes) and two eager train steps
   with the same launches per step, train env-steps/s and peak memory;
   then the ``--torso cnn`` CLI (graphed) with a resume, its checkpoint
   kept for 8d; then the CLI's ``--profile-dir`` (B = 1024, T = 8, 5
   calls, calls 2-4 graph replays: one trace and its stage map, read back,
   its hotspots naming the ``rollout.`` and ``update.`` stages with at
   least 95 % of the device time by stage) and ``--debug-nans`` (B = 1024,
   3 calls);
8e. the data axis across processes: two ``--shard-map`` ranks on the one
   card (``torch.multiprocessing`` spawn, gloo over the card's tensors,
   eager; NCCL refuses two ranks on one GPU) against one rank with no
   group, the JAX package's equivalence case at B = 64 (cluttered 9x9, 2
   agents, T = 4, float32, 1 epoch x 1 minibatch, no stagger, two steps):
   env state and key bit-equal, weights within rtol 2e-4 / atol 2e-5, the
   loss within rtol 2e-3, launches per rank the unsharded step's; then
   ``torchrun --standalone --nproc-per-node 1 ... train --distributed
   --shard-map`` at the CLI defaults but T = 32 (one NCCL rank, graphed)
   with a
   checkpoint of the global batch, one iteration resumed from it without
   ``--distributed`` (the unsharded step's launches), and the checkpoint
   kept for 8d. In the same spawn the sharded default path's step
   (``ppo.make_train_step(mesh=...)``) on two ranks against one with
   resets inside the rollout (empty 9x9, max_steps 10 with the stagger,
   B = 64, T = 8, 2 epochs x 2 minibatches: each rank takes half of every
   minibatch), with the same bars but for the weights, held in norm
   (``GSPMD_RANKS_TOL``), and the same pair again with the embed in
   float32 by K2f's and K2b's plain versions, its weights held within
   rtol 2e-4 / atol 2e-5 (the witness that the bf16 embed is what parts
   them); the same two pairs for the all-encode hetero trainer
   (``make_train_step_hetero(mesh=...)``, views 7/5/7/5 on goal_cycle
   9x9, the same B, T and minibatches); after the spawn, ``torchrun ...
   train --distributed`` without ``--shard-map`` (the sharded default
   path, one NCCL rank, graphed), two iterations, and the same with
   ``--agent-config`` (views 7/5/7/5, T = 32), on the card beside the
   first torchrun run (their rates marked as measured on a shared card),
   and ``torchrun --nproc-per-node 2 ... --agent-config --device cpu``
   (two gloo ranks on the host, B = 64: NCCL refuses two ranks on one
   card), both ranks logging the same metrics, and ``torchrun
   --nproc-per-node 2 ... --model-shards 2 --device cpu`` (a (1, 2) mesh
   of gloo ranks on the host: the model axis's two ranks log the same
   metrics); before the torchrun runs, the tensor-parallel feedforward
   step (``tensor_parallel.TensorParallelActorCritic`` in
   ``ppo.make_train_step(mesh=...)``) over gloo ranks on the host (B = 64,
   the resets case): (1, 2) in bf16 and in float32 and (2, 2) in float32,
   against the unsharded step from the same weights (env state and key
   bit-equal; float32 weights within rtol 2e-4 / atol 2e-5; bf16 no
   further from the unsharded bf16 step than that is from float32's);
8c. the host API (``wrapper.MultiGridEnv`` through ``envs.make`` and
   ``envs.env_from_config``): a cluttered 15x15 image env, a goal-cycle
   encode env and a doorkey image env, one episode each to done bit-equal
   card vs CPU (obs, rewards, done, ``encode()``, ``render()`` and the
   agent views at 16-pixel tiles), and the card's wall per step; then the
   port's four examples (``examples/torch_*.py``) at a short depth, in
   four processes on the card at once;
8d. evaluation: ``parallel/evaluate.py --episodes 1 --max-steps 100`` on
   the checkpoints of the encode, ``--rnn gru`` (plane-major),
   ``--agent-config``, ``--torso cnn`` and ``--distributed --shard-map``
   CLI phases, with the
   launches of K1 and K2f (K5f; none for 'cnn') per step, the stats line,
   the wall per step and the card's logits against the plain CPU forward;
9. torch.profiler over a short rollout, one eager train step, one image
   train step, one recurrent train step and one step of each all-encode
   hetero path (feedforward and recurrent), each at T = 16, by stage;
9b. graphs: each train step as one CUDA graph (``parallel/graph.py``)
   against its eager step from one start, at full width for encode, the
   encode row store (``--torso cnn``), recurrent encode and hetero
   recurrent, at B = 1024 for image, the mixed
   population and ``--overlap`` (T = 32, depth): an
   eager run of two steps (its second under
   ``torch.cuda.set_sync_debug_mode('error')``), ``jit=True`` two calls
   and ``multi_step`` with k = 2 once (then replays for the rates);
   env state, key, weights, Adam's state, carry and metrics bit-equal to
   the eager run's, launches per replayed step equal to the eager step's;
   eager and graphed train env-steps/s, the capture's seconds, peak
   memory, and the busy and idle time of one profiled replay beside phase
   9's eager step;
9c. the ``--shard-map`` steps (feedforward, and GRU on the plane-major
   embed) at full width on an NCCL group of world size 1 (every
   collective runs on NCCL), through 9b's eager, graphed and
   ``multi_step`` runs over the group's mesh at T = 16 (no profiled
   replay): launches per step equal to the unsharded step's, replays
   bit-equal to the eager steps, the ``all_reduce`` calls of an eager
   step and of the capture counted (one graph node each, none from the
   host on a replay); then on the same group the sharded default path's
   steps (``mesh=``, the same two paths, full width, T = 32): the
   unsharded eager step and the mesh step's eager call and capture from
   one start, env state and key bit-equal to the unsharded step's after
   one step, weights within rtol 2e-4 / atol 2e-5, one ``all_gather``
   and 25 ``all_reduce`` calls a step captured, replays' wall, peak
   memory, and the busy time and device ops of one profiled replay beside
   9b's unsharded graphed replay; and ``multi_step`` (k = 2) of the raw
   mesh step, bit-equal to two eager steps, its collectives captured;
   then the same for the three hetero populations' ``mesh=`` steps
   (``make_train_step_hetero*``, 8b's populations at B = 4096, T = 16),
   each beside its own unsharded graphed step from the same start (its
   replay's busy time and memory rise), ``multi_step`` on the all-encode
   one; then the 'model' axis on the same group (n_model = 1: its
   collectives run on a group of one rank and are captured): the
   tensor-parallel feedforward step at full width, T = 32, graphed beside
   the unsharded graphed step from the same start (env state and key
   bit-equal, weights within rtol 2e-4 / atol 2e-5, the collectives a
   step by axis, K2f and K2b launches, busy time and memory), and one
   eager step each of the unsharded, plain ``mesh=`` and tensor-parallel
   steps at T = 16 (the last two bit-equal); then
   ``__graft_entry_torch__``: ``entry()`` card vs CPU and
   ``dryrun_multichip(1)``, seven finite losses;
10. the env-only phase at bench.py's config (cluttered 15x15, 3 agents,
   25 clutter, B = 32768, T = 16 random actions, board pool 256), with
   encode and with image observations;
10b. ``VectorEnv.rollout_fn`` at the same config (B = 32768, T = 16, a
   random policy), shared-board and independent resets: the graphed
   rollout (one CUDA graph) bit-equal to the eager one from the same
   start, and its env-steps/s beside the eager rate;
10c. the timer check: K1 at (4096, 196) timed with the card's hold sized
   on an idle host while the host is loaded (the unchecked timer, which
   read K1 at 76.88-85.49 us in five runs), by the checked ``time_ms``
   and in one CUDA graph of 50 launches;
11. the kernels' times with CUDA events at the rollout's and the update's
   shapes (K3 also at the image env-only shape; K2f, K5f and K5b also at
   a hetero 5x5 group's update shape with the full vocabulary, on the
   hetero phases' own inputs), beside their bound (for the one-hot
   products the least over the routes: bytes, float32 adds, the dense
   bf16 product), their plain version's and one PyTorch call's time (K2f,
   K5f, K2b and K5b also beside torch.mm of their one-hot matrix, the
   tensor-core yardstick); then the K6 probe (K2f's tensor-core kernel
   whole, 'full', or one half alone: the builder warps, 'build', or the
   mma warps, 'gemm') against its plain versions and timed beside K2f,
   with the palette and the full vocabulary: the split of K2f's time
   between its two halves.

The last lines of standard output are the card's name and power limit, a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense

#: the perf gate's heterogeneous populations (tests/test_perf_gate.py)
HETERO_SPEC = ('[{"view_size":7},{"view_size":5},{"view_size":7},'
               '{"view_size":5}]')
MIXED_SPEC = ('[{"view_size":7},{"view_size":7,"observation_style":"image"},'
              '{"view_size":7},{"view_size":7,"observation_style":"image"}]')
#: the three hetero train paths: (train CLI flags, plane-major embed)
HETERO_PATHS = {
    "hetero": (("--agent-config", HETERO_SPEC), False),
    "hetero-rnn": (("--agent-config", HETERO_SPEC, "--rnn", "gru"), True),
    "hetero-mixed": (("--agent-config", MIXED_SPEC, "--rollout", "32"),
                     False),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


#: what :func:`time_ms` saw: its timed runs, the runs it repeated because
#: the card's hold ended before the host had queued the timed launches,
#: the longest hold it took (ms), and the functions it timed that wait on
#: the card themselves (unchecked: no hold can outlast their queueing)
TIMER = dict(runs=0, retried=0, max_hold_ms=0.0, waiting=0)


def _hold(ms: float):
    """Hold the card for about ``ms`` (at least; >= 2 GHz cycles per ns
    overestimates the clock, so it only lasts longer)."""
    torch.cuda._sleep(int(ms * 1e-3 * 2e9) + 1000)


def time_ms(fn, iters=50, warmup=5, checked=True):
    """(device ms, host ms) per call of ``fn``, means over ``iters`` calls.

    Device time: CUDA events around ``iters`` back-to-back calls that the
    host queued while the card was held busy by ``torch.cuda._sleep``, so
    the host's launch cost (Python, checks, ctypes) does not show in it.
    The hold is sized at twice the host's idle queueing time; once the
    launches are queued, the start event must still be pending (the card
    still inside the hold). If it is not, the card ran ahead of the host
    and the events timed the host's pace: the run is repeated once with a
    hold four times longer (:data:`TIMER` counts them). A function that
    waits on the card itself (some plain versions: a host copy, a
    data-dependent shape) ends any hold before its calls are queued; it is
    seen so first (one call behind a hold returns after the hold has
    ended), or by running dry again behind the longer hold, and its
    reading is then that of an unchecked run: the card's time with the
    host's gaps. ``checked=False``: one run, unchecked (the
    timer before that repair, kept for the timer check phase). Host time:
    wall clock per call with the card idle, synchronized at the end: what
    a caller pays per call when the kernel is this small.
    """
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if checked:
        _hold(10 * host_ms + 1.0)
        start.record()
        fn()
        waits = start.query()
        sync()
        if waits:
            TIMER["waiting"] += 1
            checked = False
    hold = 2 * host_ms * iters
    for _ in range(2):
        _hold(hold)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        sync()
        if not checked:
            break
        TIMER["runs"] += 1
        TIMER["max_hold_ms"] = max(TIMER["max_hold_ms"], hold)
        if held:
            break
        TIMER["retried"] += 1
        hold *= 4
    else:
        TIMER["waiting"] += 1
    return start.elapsed_time(end) / iters, host_ms


def graph_ms(fn, iters=50, replays=5):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, ``replays`` replays each timed with CUDA events (no host between
    the launches), the median. A cross-check of :func:`time_ms` for
    kernels whose wrapper launches from the host thread (ctypes), which a
    graph captures."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        g.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


class _HostSlows:
    """``fn`` whose caller, the host, slows after its first ``fast``
    calls: each later call first spins ``delay_ms`` on the host. What a
    host that is slower while the timed launches are queued than while
    :func:`time_ms` sized the card's hold looks like to the timer."""

    def __init__(self, fn, fast: int, delay_ms: float):
        self.fn, self.fast, self.delay_s, self.calls = fn, fast, \
            delay_ms * 1e-3, 0

    def __call__(self):
        self.calls += 1
        if self.calls > self.fast:
            until = time.perf_counter() + self.delay_s
            while time.perf_counter() < until:
                pass
        return self.fn()


def phase_timer_check(card, iters=50, warmup=5, delay_ms=0.08):
    """Why K1's device time once read 76.88-85.49 us in five runs and
    3.71-3.90 us in others. K1 at (4096, 196) int32, ``iters``
    launches, by (1) the unchecked timer (the one before the repair: a
    hold sized from the host's queueing time while the card is idle); (2)
    the same when the host queues the timed launches ``delay_ms`` slower a
    call than it did while the hold was sized (:class:`_HostSlows`), with
    the start event's state once they are queued (complete: the hold ended
    first, and the events timed the host's pace); (3) the checked
    :func:`time_ms` on that slowing host, which sees this and repeats with
    a longer hold; (4) :func:`graph_ms`, no host in the timed run. Fails
    if (3) reads more than 2x (4), or if (2) did not run dry."""
    from marlgrid_tpu_torch.ops import transpose as T

    x = torch.randint(0, 2 ** 20, (4096, 196), dtype=torch.int32,
                      device="cuda")

    def k1():
        return T.transpose_bk(x)

    out = dict(graph_ms=graph_ms(k1, iters))
    idle = [time_ms(k1, iters, warmup, checked=False) for _ in range(3)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slowed, dry = [], []
    for _ in range(3):
        # the old timer: its hold sized on the host's own pace, then the
        # host slows while it queues the timed launches
        fn = _HostSlows(k1, warmup + iters, delay_ms)
        for _ in range(warmup):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        host_ms = (time.perf_counter() - t0) / iters * 1e3
        _hold(2 * host_ms * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        dry.append(bool(start.query()))
        sync()
        slowed.append(start.elapsed_time(end) / iters)
    before = TIMER["retried"]
    checked = [time_ms(_HostSlows(k1, warmup + iters, delay_ms), iters,
                       warmup)[0] for _ in range(3)]
    retried = TIMER["retried"] - before
    out.update(unchecked_ms=[t for t, _ in idle],
               host_ms=[h for _, h in idle], slowed_ms=slowed, ran_dry=dry,
               checked_slowed_ms=checked, retried=retried,
               delay_ms=delay_ms)

    def us(xs):
        return ", ".join(f"{v * 1e3:.2f}" for v in xs)

    print(f"[timer] K1 (4096, 196) int32, {iters} launches: the unchecked "
          f"timer {us(out['unchecked_ms'])} us (host {us(out['host_ms'])} "
          f"us per call, card idle); with the host {delay_ms * 1e3:.0f} us "
          f"a call slower while it queues the timed launches than while the "
          f"hold was sized: {us(slowed)} us, the hold over before the last "
          f"launch was queued: {dry}; the checked timer on that host "
          f"{us(checked)} us ({retried} runs repeated with a longer hold); "
          f"one CUDA graph of the launches {out['graph_ms'] * 1e3:.2f} us "
          f"per launch [{card}]")
    if not (all(dry) and max(checked) <= 2 * out["graph_ms"]):
        raise AssertionError(f"timer check: the slowed unchecked runs ran "
                             f"dry {dry}; the checked timer read "
                             f"{us(checked)} us, the graph "
                             f"{out['graph_ms'] * 1e3:.2f} us")
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def kernel_wrappers():
    """Name -> wrapper of every kernel of the port; each wrapper counts its
    launches in ``.launches``."""
    from marlgrid_tpu_torch.ops import kernel_wrappers as wrappers

    return wrappers()


#: the hash kernel (ops/threefry.py), which every sampler of the env engine
#: and the policy launches: the phases' launch checks leave it out, and
#: :func:`phase_threefry` holds it
HASH = "threefry2x32"


def want_counts(**launches):
    """The launch counts a phase expects: ``launches`` by kernel name, and
    0 for every other kernel of the port but the hash."""
    want = dict.fromkeys(kernel_wrappers(), 0)
    del want[HASH]
    want.update(launches)
    return want


@contextlib.contextmanager
def embed_v2(on: bool):
    """``MARLGRID_TPU_EMBED_V2`` set (the plane-major embed, K5f/K5b) or
    unset (K2f/K2b) while the nets of a phase are built, then restored."""
    from marlgrid_tpu_torch.models.actor_critic import EMBED_V2_VAR

    old = os.environ.pop(EMBED_V2_VAR, None)
    if on:
        os.environ[EMBED_V2_VAR] = "1"
    try:
        yield
    finally:
        os.environ.pop(EMBED_V2_VAR, None)
        if old is not None:
            os.environ[EMBED_V2_VAR] = old


def zero_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    """Launches of every kernel of the port but the hash."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()
            if name != HASH}


def hash_launches() -> int:
    return kernel_wrappers()[HASH].launches


def phase_build():
    from marlgrid_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[build] {len(report)} kernels in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name, r in report.items():
        print(f"[build] {name}: nvcc {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")


def phase_transpose():
    from marlgrid_tpu_torch.ops import transpose as T

    worst = 0
    for shape in ((4096, 196), (32768, 147), (1000, 147)):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                          device="cuda")
        y = T.transpose_bk(x)
        sync()
        ref = T.transpose_bk_plain(x)
        if not torch.equal(y, ref):
            raise AssertionError(f"K1 differs from x.t() at {shape}")
        worst = max(worst, int((y.long() - ref.long()).abs().max()))
        print(f"[K1] {shape}: bit-exact")
    return float(worst)


def _codes(R, cells, S, gen):
    """Codes across and beyond both vocabularies: types up to 15, colors up
    to 12, states up to 200 (box-packed states clip at 19)."""
    parts = [torch.randint(0, hi, (R, cells, S), generator=gen)
             for hi in (16, 13, 201)]
    return torch.cat(parts, 1).to(torch.uint8).cuda()


#: the embed phases' extra cases, (R, cells, S): a hetero population's 5x5
#: view group (25 cells, the full vocabulary: hetero runs have no palettes)
#: of two agents at the rollout's shape (R = 2, S = 4096) and the update's
#: (R = 1024 blocks of S = 128: 2 agents x 64 steps x 32 env chunks over 4
#: minibatches); phase_hetero also holds each embed kernel on the inputs of
#: a real step of each hetero path
HETERO_ROLLOUT = (2, 25, 4096)
HETERO_UPDATE = (1024, 25, 128)


#: the forward embeds' odd shapes, (R, cells, S, H, vocabulary): S not a
#: multiple of the kernel's 128-sample tile (100) or of 16 (4097), H not a
#: multiple of its 16-unit groups (24: one 32-unit group, half of it
#: padding; 136: the last group of 8 units, or of 8 of 32 at the full
#: vocabulary), R = 3
ODD_FWD = ((3, 49, 100, 24, "full"),
           (3, 49, 4097, 136, "goal_cycle palette"),
           (3, 25, 100, 136, "goal_cycle palette"),
           (3, 25, 4097, 24, "full"))


def _fwd_cases(palettes):
    """(R, cells, S, H, name, palettes) of the forward embeds' checks: the
    rollout's shape (R = 4, S = 4096) and the update's (R = 2048 rows of
    S = 128) with the full vocabularies and the goal_cycle palette, a
    hetero 5x5 group's rollout and update shapes, and ``ODD_FWD``."""
    pal = {"full": None, "goal_cycle palette": palettes}
    return ([(R, 49, S, 128, name, pal[name])
             for R, S in ((4, 4096), (2048, 128)) for name in pal]
            + [(*HETERO_ROLLOUT, 128, "full", None),
               (*HETERO_UPDATE, 128, "full", None)]
            + [(R, cells, S, H, name, pal[name])
               for R, cells, S, H, name in ODD_FWD])


def phase_embed(palettes):
    """K2f at every shape of :func:`_fwd_cases`, against its plain version
    in float32 rounded to bf16, within 1 bf16 ulp; two calls give the same
    bits."""
    from marlgrid_tpu_torch.ops import embed as E

    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for R, cells, S, H, name, pal in _fwd_cases(palettes):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        w = (torch.randn(cells, sum(widths), H, generator=gen) * 0.05).to(
            torch.bfloat16).cuda()
        what = f"{name} (R={R}, F={3 * cells}, S={S}, H={H})"
        with torch.no_grad():
            out = E.onehot_embed(x, w, widths, values)
            again = E.onehot_embed(x, w, widths, values)
        sync()
        ref = E.onehot_embed_plain(x, w.float(), widths, values,
                                   torch.float32).to(torch.bfloat16)
        worst = max(worst, _hold_k2f(out, ref, what))
        if not torch.equal(out, again):
            raise AssertionError(f"K2f {what} differs between two launches")
        print(f"[K2f] {what}: two launches bit-equal")
    return worst


def _hold_k2f(out, ref, what):
    """K2f's output within 1 bf16 ulp of its plain version's float32 sum
    ``ref`` rounded to bf16; returns max |err|."""
    err = (out.float() - ref.float()).abs()
    # 1 bf16 ulp of the reference; 2**-20 absolute covers the float32
    # summation-order error where the sum cancels to near zero
    bad = err > bf16_ulp(ref) + 2.0 ** -20
    if out.shape != ref.shape or out.dtype != torch.bfloat16 or bad.any():
        raise AssertionError(
            f"K2f {what} beyond 1 bf16 ulp at {int(bad.sum())} of "
            f"{bad.numel()} values (max abs err {float(err.max())}), or "
            f"{tuple(out.shape)} {out.dtype}")
    print(f"[K2f] {what}: max abs err {float(err.max()):.3e}, within 1 bf16 "
          f"ulp")
    return float(err.max())


def phase_embed_bwd(palettes):
    """K2b at the update's shape (R = 2048 blocks of S = 128 samples, H =
    128), with the full vocabularies and the goal_cycle palette, and at a
    hetero 5x5 group's (``HETERO_UPDATE``), against its plain version on
    the card (:func:`_hold_k2b`); then at two odd shapes that take the
    kernel's other paths (S not a multiple of 16: codes read byte by byte;
    H = 20: 4-byte copies of dout into a 32-unit tile; H = 200: two
    128-unit tiles, the second padded). The embed's autograd Function
    returns K2b's gradient."""
    from marlgrid_tpu_torch.ops import embed as E

    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    for R, cells, S, H, name, pal in (
            (2048, 49, 128, 128, "full", None),
            (2048, 49, 128, 128, "goal_cycle palette", palettes),
            (*HETERO_UPDATE, 128, "full", None),
            (48, 49, 100, 20, "full", None),
            (64, 25, 48, 200, "goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        dout = torch.randn(R, S, H, generator=gen).to(torch.bfloat16).cuda()
        what = f"{name} (R={R}, F={3 * cells}, S={S}, H={H})"
        dw, err = _hold_k2b(x, dout, widths, values, what)
        w = (torch.randn(cells, sum(widths), H, generator=gen) * 0.05).cuda()
        w.requires_grad_(True)
        n0 = E.onehot_embed_bwd.launches
        (g,) = torch.autograd.grad(E.onehot_embed(x, w, widths, values), w,
                                   dout)
        if E.onehot_embed_bwd.launches != n0 + 1 or not torch.equal(g, dw):
            raise AssertionError(f"K2b {what}: the autograd Function did "
                                 f"not return K2b's gradient")
        worst = max(worst, err)
    return worst


def _hold_k2b(x, dout, widths, values, what):
    """K2b against its plain version on the same codes and bf16 ``dout``:
    both sum in float32 and only the order of the sums over up to 262,144
    samples differs, so max |err| <= 1e-3 * max |dW|; two launches give the
    same bits. Returns (dW, max |err|)."""
    from marlgrid_tpu_torch.ops import embed as E

    dw = E.onehot_embed_bwd(x, dout, widths, values)
    again = E.onehot_embed_bwd(x, dout, widths, values)
    sync()
    ref = E.onehot_embed_bwd_plain(x, dout, widths, values)
    err = float((dw - ref).abs().max())
    scale = float(ref.abs().max())
    if dw.shape != ref.shape or dw.dtype != torch.float32 \
            or not err <= 1e-3 * scale:
        raise AssertionError(
            f"K2b {what}: max abs err {err} beyond 1e-3 of max |dW| "
            f"{scale}, or shape {tuple(dw.shape)} {dw.dtype}")
    if not torch.equal(dw, again):
        raise AssertionError(f"K2b {what} differs between two launches")
    print(f"[K2b] {what}: max abs err {err:.3e} of max |dW| {scale:.3e} "
          f"(tolerance 1e-3 of it), deterministic")
    return dw, err


def _tables2(cells, widths, H, gen):
    """Three random float32 per-plane tables (cells, n_p, H) on the card."""
    return [(torch.randn(cells, n, H, generator=gen) * 0.05).cuda()
            for n in widths]


def phase_embed2(palettes):
    """K5f against its plain version on the card (:func:`_hold_k5f`) at
    every shape of :func:`_fwd_cases`, on codes with state codes above 19
    and codes outside each vocabulary; two calls give the same bits."""
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    gen = torch.Generator().manual_seed(3)
    worst = 0.0
    for R, cells, S, H, name, pal in _fwd_cases(palettes):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        ws = _tables2(cells, widths, H, gen)
        what = f"{name} (R={R}, F={3 * cells}, S={S}, H={H})"
        with torch.no_grad():
            out = E2.onehot_embed2(x, *ws, widths, values)
            again = E2.onehot_embed2(x, *ws, widths, values)
        sync()
        worst = max(worst, _hold_k5f(
            out, E2.onehot_embed2_plain(x, *ws, widths, values), what))
        if not torch.equal(out, again):
            raise AssertionError(f"K5f {what} differs between two launches")
        print(f"[K5f] {what}: two launches bit-equal")
    return worst


def _hold_k5f(out, ref, what):
    """K5f's output against its plain version's ``ref``: both read the
    tables as bf16 and sum in float32 without rounding the output; only the
    order of the sums differs, so max |err| <= 1e-5 * max |out|. Returns
    max |err|."""
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if out.shape != ref.shape or out.dtype != torch.float32 or \
            not err <= 1e-5 * scale:
        raise AssertionError(
            f"K5f {what}: max abs err {err} beyond 1e-5 of max |out| "
            f"{scale}, or {tuple(out.shape)} {out.dtype}")
    print(f"[K5f] {what}: max abs err {err:.3e} of max |out| {scale:.3e} "
          f"(tolerance 1e-5 of it)")
    return err


def phase_embed2_bwd(palettes):
    """K5b at the update's shape (R = 2048, S = 128, H = 128), with the
    full vocabularies and the goal_cycle palette, and at a hetero 5x5
    group's (``HETERO_UPDATE``), against its plain version on the card
    (:func:`_hold_k5b`); then at K2b's two odd shapes (its kernel's other
    paths, :func:`phase_embed_bwd`). The embed2 autograd Function returns
    K5b's gradients."""
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    for R, cells, S, H, name, pal in (
            (2048, 49, 128, 128, "full", None),
            (2048, 49, 128, 128, "goal_cycle palette", palettes),
            (*HETERO_UPDATE, 128, "full", None),
            (48, 49, 100, 20, "full", None),
            (64, 25, 48, 200, "goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        dout = torch.randn(R, S, H, generator=gen).to(torch.bfloat16).cuda()
        what = f"{name} (R={R}, F={3 * cells}, S={S}, H={H})"
        dws, err = _hold_k5b(x, dout, widths, values, what)
        ws = [w.requires_grad_(True) for w in _tables2(cells, widths, H, gen)]
        n0 = E2.onehot_embed2_bwd.launches
        gs = torch.autograd.grad(E2.onehot_embed2(x, *ws, widths, values),
                                 ws, dout.float())
        if E2.onehot_embed2_bwd.launches != n0 + 1 or not all(
                torch.equal(g, dw) for g, dw in zip(gs, dws)):
            raise AssertionError(f"K5b {what}: the autograd Function did "
                                 f"not return K5b's gradients")
        worst = max(worst, err)
    return worst


def _hold_k5b(x, dout, widths, values, what):
    """K5b against its plain version on the same codes and bf16 ``dout``,
    per table within 1e-3 of max |dW_p| (float32 sums over up to 262,144
    samples in another order); two launches give the same bits. Returns
    (the three dW_p, max |err|)."""
    from marlgrid_tpu_torch.ops import embed2 as E2

    dws = E2.onehot_embed2_bwd(x, dout, widths, values)
    again = E2.onehot_embed2_bwd(x, dout, widths, values)
    sync()
    refs = E2.onehot_embed2_bwd_plain(x, dout, widths, values)
    errs = []
    for p, (dw, ref) in enumerate(zip(dws, refs)):
        err = float((dw - ref).abs().max())
        scale = float(ref.abs().max())
        if dw.shape != ref.shape or dw.dtype != torch.float32 or \
                not err <= 1e-3 * scale:
            raise AssertionError(
                f"K5b {what} table {p}: max abs err {err} beyond 1e-3 of max "
                f"|dW| {scale}, or {tuple(dw.shape)} {dw.dtype}")
        if not torch.equal(dw, again[p]):
            raise AssertionError(f"K5b {what} table {p} differs between two "
                                 f"launches")
        errs.append((err, scale))
    print(f"[K5b] {what}: max abs err per table "
          f"{', '.join(f'{e:.3e} of {m:.3e}' for e, m in errs)} (tolerance "
          f"1e-3 of max |dW_p|), deterministic")
    return dws, max(e for e, _ in errs)


def _spread_prestige(ep, state):
    """Prestige that puts agent j of env b at level (b*N + j) % 8: every
    dim level shows in the views."""
    B, N = state.prestige.shape
    lvl = torch.arange(B * N, device=state.prestige.device).reshape(B, N) % 8
    scale = torch.tensor(ep.prestige_scale_tuple(), dtype=torch.float32,
                         device=state.prestige.device)
    state.prestige = (lvl.float() + 0.5) * scale
    return state


def max_byte_err(out, ref):
    """max |out - ref| over two uint8 tensors of one shape, in slices of
    256 Mi bytes (the update's render is 2.47 GB)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"shape/dtype {tuple(out.shape)} {out.dtype}, "
                             f"want {tuple(ref.shape)} {ref.dtype}")
    return max(int((x.short() - y.short()).abs().max())
               for x, y in zip(out.reshape(-1).split(1 << 28),
                               ref.reshape(-1).split(1 << 28)))


def phase_sprite(seed):
    """K3 against its plain version on the card, bit-exact (max err 0), on
    the ids of real views: goal_cycle at the rollout's shape (B = 4096,
    N = 4), a cluttered 15x15 and a doorkey with hidden keys and a view
    offset, after random steps with prestige over all 8 levels, in the
    standard, (N, B), s2d and (N, B) s2d layouts (16-byte s2d pieces,
    8-byte standard granules); then random ids at T = 16 (tables read
    through the read-only cache), T = 4 (s2d pieces, and single-byte
    granules in 16-byte stores) and T = 5 (single-byte granules and
    stores), the kernel's other variants."""
    from marlgrid_tpu_torch.core import constants as C
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.ops import sprite

    def ep_of(n, **kw):
        return EnvParams(n_agents=n, max_steps=250, observation_style="image",
                         agent_colors=default_agent_colors(n), **kw)

    configs = (
        ("goal_cycle 13x13", ep_of(4, width=13, height=13,
                                   scenario="goal_cycle"), 4096),
        ("cluttered 15x15", ep_of(3, width=15, height=15,
                                  scenario="cluttered", n_clutter=25), 1024),
        ("doorkey 11x11, keys hidden, view offset 1",
         ep_of(2, width=11, height=11, scenario="doorkey", view_offset=1,
               hide_item_types=(C.KEY,)), 1024))
    layouts = (dict(), dict(nb_layout=True), dict(s2d=True),
               dict(nb_layout=True, s2d=True))

    worst = 0

    def check(ep, ids, kws, what):
        nonlocal worst
        for kw in kws:
            n0 = sprite.compose_image_b.launches
            out = sprite.compose_image_b(ep, *ids, **kw)
            sync()
            if sprite.compose_image_b.launches != n0 + 1:
                raise AssertionError("K3 was not launched")
            ref = sprite.compose_image_b_plain(ep, *ids, **kw)
            err = max_byte_err(out, ref)
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(
                    f"K3 differs from its plain version: {what} {kw}: "
                    f"{int((out != ref).sum())} bytes, max abs err {err}")
        print(f"[K3] {what}: bit-exact in {len(kws)} layouts "
              f"({tuple(out.shape)})")

    for what, ep, B in configs:
        key = rng.PRNGKey(seed, device="cuda")
        s = grid_gen.reset(ep, rng.split(key, B))
        acts = rng.randint(rng.fold_in(key, 3), (8, B, ep.n_agents), 0, 7)
        for t in range(8):
            s = step.step(ep, s, acts[t])[0]
        ids = obs.image_ids(ep, _spread_prestige(ep, s))
        levels = sorted(torch.unique(ids[2][ids[1] > 0]).tolist())
        if B == 4096 and levels != list(range(8)):
            raise AssertionError(f"{what}: levels {levels} in the views")
        check(ep, ids, layouts, f"{what}, B={B}, N={ep.n_agents}, seen "
                                f"levels {levels}")
    gen = torch.Generator().manual_seed(seed)
    for T, vs in ((16, 7), (4, 5), (5, 5)):
        ep = ep_of(3, view_size=vs, view_tile_size=T)
        shape = (3, vs, vs, 257)
        ids = [torch.randint(0, hi, shape, generator=gen, dtype=torch.int32)
               .cuda() for hi in (obs.N_BASE_APPEAR + 1, obs.N_AGENT_APPEAR,
                                  C.N_PRESTIGE_LEVELS)]
        check(ep, ids, layouts if T % 4 == 0 else layouts[:2],
              f"random ids, T={T}, vs={vs}")
    return float(worst)


def phase_reference(seed):
    """The card against the CPU on a small input: env states and encode obs
    bit-equal over an autoreset run; logits within bf16 tolerance."""
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                               default_agent_colors)
    from marlgrid_tpu_torch.models import ActorCritic
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=15, height=15, n_agents=3, scenario="cluttered",
                   n_clutter=25, max_steps=30, observation_style="encode",
                   agent_colors=default_agent_colors(3))
    B, T = 64, 40
    runs = {}
    for dev in ("cpu", "cuda"):
        key = rng.PRNGKey(seed, device=dev)
        s = grid_gen.reset(ep, rng.split(key, B))
        pool = step.fresh_pool(ep, rng.fold_in(key, 7), 8)
        acts = rng.randint(rng.fold_in(key, 3), (T, B, 3), 0, 7)
        states, views = [], []
        for t in range(T):
            s, _, _, _ = step.step_autoreset_with_fresh_batch(
                ep, s, acts[t], step.fresh_pool_rows(pool, t, 0, B), salt=t)
            states.append(s)
            views.append(obs.all_obs_encode_b(ep, s, bminor=True))
        runs[dev] = (states, views)
    n_done = 0
    for t in range(T):
        sc, sg = runs["cpu"][0][t], runs["cuda"][0][t]
        for f in FIELDS:
            if not torch.equal(getattr(sc, f), getattr(sg, f).cpu()):
                raise AssertionError(f"env state {f} differs at step {t}")
        if not torch.equal(runs["cpu"][1][t], runs["cuda"][1][t].cpu()):
            raise AssertionError(f"encode obs differ at step {t}")
        n_done += int((sg.step_count == 0).sum())
    print(f"[reference] env states and obs bit-equal card vs CPU over "
          f"{T} steps x {B} envs ({n_done} resets)")

    cfg = ppo.PPOConfig(hidden=128,
                        embed_palettes=obs.encode_palettes(ep))
    net_c = ActorCritic(cfg, 7, torch.Generator().manual_seed(seed),
                        device="cpu")
    net_g = ActorCritic(cfg, 7, device="cuda")
    net_g.load_state_dict(net_c.state_dict())
    x = runs["cpu"][1][-1].permute(1, 0, 2, 3, 4).reshape(3, 147, B)
    with torch.no_grad():
        lc, vc = net_c(x.to(torch.uint8))
        lg, vg = net_g(x.to(torch.uint8).cuda())
    err = max(float((lc - lg.cpu()).abs().max()),
              float((vc - vg.cpu()).abs().max()))
    # bf16 activations: the kernel sums in float32 and rounds once where
    # the CPU's plain version rounds each plane's bf16 product; three bf16
    # layers follow
    if not err < 5e-2:
        raise AssertionError(f"logits/values card vs CPU differ by {err}")
    print(f"[reference] logits and values card vs CPU: max abs err "
          f"{err:.3e} (bf16, tolerance 5e-2)")
    reference_train(seed, "encode")
    reference_train(seed, "encode", "gru", plane_major=True)
    reference_train(seed, "encode", "lstm")
    reference_image(seed)


def _train_config(kind, rnn="", rows=False):
    """The reference train step's small config (goal_cycle 13x13, 4
    agents, B = 16, T = 8, hidden 32, float32, 2 epochs x 4 minibatches):
    'encode' with the mlp torso and palettes, or 'image' with cnn_s2d;
    feedforward, or recurrent with ``rnn`` 'gru' or 'lstm'. ``rows``: the
    row store, 'encode' with the 'cnn' torso (channels (32, 64)) or
    'image' with ``recompute_image_obs=False``."""
    from marlgrid_tpu_torch.core import obs
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   max_steps=12, reward_decay=False, observation_style=kind,
                   agent_colors=default_agent_colors(4))
    small = dict(n_envs=16, rollout_len=8, hidden=32, board_pool=4,
                 dtype=torch.float32, rnn=rnn)
    if kind == "encode" and rows:
        return ep, ppo.PPOConfig(**small, torso="cnn")
    if kind == "encode":
        return ep, ppo.PPOConfig(**small,
                                 embed_palettes=obs.encode_palettes(ep))
    return ep, ppo.PPOConfig(**small, torso="cnn_s2d",
                             recompute_image_obs=not rows)


#: the reference train step's tolerances (see reference_train), per path
TRAIN_TOL = {
    # K2f reads the table and writes its output in bf16 and K2b reads dout
    # in bf16, where the CPU stays in float32. A hidden unit whose input
    # sits within that rounding of zero takes the other side of its ReLU,
    # which changes a whole dout entry: on an H100 the first minibatch's
    # embed gradient differed by 4 % of its max.
    "encode": dict(metrics=1e-2, grad=0.15, weights=0.3),
    # float32 end to end (K3 is exact, the convolutions run without TF32):
    # only the order of the float32 sums differs. On an H100 the step read
    # metrics 2.4e-7, gradients 2.5e-6 and weights 3.0e-5 apart; the bounds
    # sit 40x, 40x and 330x above those readings
    "image": dict(metrics=1e-5, grad=1e-4, weights=1e-2),
    # The row store: float32 end to end as 'image' (the 'cnn' torso's
    # one-hot planes are exact), so it takes 'image''s bounds
    "encode rows": dict(metrics=1e-5, grad=1e-4, weights=1e-2),
    "image rows": dict(metrics=1e-5, grad=1e-4, weights=1e-2),
    # The recurrent steps. The plane-major embed reads its tables and dout
    # in bf16 on both devices, so, as on the float32 image path, only the
    # order of float32 sums differs: on an H100 the GRU encode step read
    # metrics 1.2e-7, gradients 2.9e-7 and weights 5.9e-5 apart, the GRU
    # image step 2.2e-8, 2.4e-6 and 5.8e-5; the bounds sit 40-80x above
    # the metrics' and gradients' readings and 170x above the weights'.
    # The LSTM encode step runs the K2 route, bf16 as 'encode' (it read
    # 4.4e-4, 5.5e-2 and 0.11), and keeps its bounds.
    "encode gru plane-major": dict(metrics=1e-5, grad=1e-5, weights=1e-2),
    "encode lstm": dict(metrics=1e-2, grad=0.15, weights=0.3),
    "image gru": dict(metrics=1e-6, grad=1e-4, weights=1e-2),
    # The hetero steps (reference_hetero) take the homogeneous paths'
    # bounds: the all-encode and the mixed population's encode groups run
    # the K2 route in bf16, as 'encode'; the recurrent one the plane-major
    # embed, float32 sums as 'encode gru plane-major'. On an H100 they read
    # metrics 2.9e-4 / 4.0e-7 / 3.8e-4, gradients 0.116 / 4.7e-7 / 0.111
    # and weights 0.148 / 5.1e-5 / 0.120 (the homogeneous encode step in
    # the same run: 1.1e-3, 0.070, 0.125). The mixed population's image
    # group runs in float32 end to end and is held to 'image' (its step
    # runs without the global-norm clip, which would tie its scale to the
    # encode group's bf16 gradients).
    "hetero": dict(metrics=1e-2, grad=0.15, weights=0.3),
    "hetero-rnn": dict(metrics=1e-5, grad=1e-5, weights=1e-2),
    "hetero-mixed": dict(metrics=1e-2, grad=0.15, weights=0.3),
}


def reference_train(seed, kind, rnn="", plane_major=False, rows=False):
    """A train step at a small size in float32 (:func:`_train_config`):
    the card's rollout and update, and the CPU's update of the card's
    trajectory (feature-major codes, or the stored EnvStates that the image
    update re-renders) from the same weights and key. (The CPU does not
    roll out itself: a logit that differs by a rounding can flip a sampled
    action.) With ``rnn``, the recurrent step (``ppo_rnn``), its update fed
    the card's stored window carries too; ``plane_major`` builds both nets
    with the plane-major embed (K5f/K5b on the card). The tolerances of
    ``TRAIN_TOL``, per weight tensor (``rows``: the row store's
    configuration of :func:`_train_config`):
    every metric within ``metrics``; the first minibatch's gradient within
    ``grad`` of its L2 norm; the weights after the step within ``weights``
    of the step's change in L2 norm (Adam moves a weight by about lr
    whatever the size of its gradient, so a gradient near zero may take
    the other sign). A layout, clip or optimizer fault would miss them by
    far more."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    ep, cfg = _train_config(kind, rnn, rows)
    label = " ".join([kind] + [rnn] * bool(rnn)
                     + ["plane-major"] * plane_major + ["rows"] * rows)
    tol = TRAIN_TOL[label]
    devs = {"card": "cuda", "cpu": "cpu"}
    init = ppo_rnn.init_state_rnn if rnn else ppo.init_state
    with embed_v2(plane_major):
        made = {who: init(ep, cfg, torch.Generator().manual_seed(seed),
                          device=dev) for who, dev in devs.items()}
    nets = {who: m[:2] for who, m in made.items()}
    if cfg.torso == "mlp" and \
            nets["card"][0].torso0.plane_major != plane_major:
        raise AssertionError(f"{label}: the embed route was not selected")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             device="cuda")
    if rnn:
        rollout = ppo_rnn.make_rollout_rnn(ep, cfg, nets["card"][0],
                                           device="cuda")
        _, _, key, traj, h0s, last = rollout(env, made["card"][2],
                                             rng.fold_in(key, 2))
    else:
        rollout = ppo.make_rollout(ep, cfg, nets["card"][0], device="cuda")
        _, key, traj, last = rollout(env, rng.fold_in(key, 2))
    w0 = {k: v.clone() for k, v in nets["cpu"][0].state_dict().items()}
    ms, grads, ws = {}, {}, {}
    for who, (net, opt) in nets.items():
        dev = devs[who]
        _record_first_grads(net, opt, grads.setdefault(who, {}))
        tr = {k: v.to(dev) if isinstance(v, torch.Tensor) else
              v.map(lambda x: x.to(dev)) for k, v in traj.items()}
        if rnn:
            update = ppo_rnn.make_update_rnn(ep, cfg, net, opt, device=dev)
            m = update(tr, ppo_rnn.map_carry(lambda x: x.to(dev), h0s),
                       last.to(dev), key.to(dev))
        else:
            update = ppo.make_update(ep, cfg, net, opt, device=dev)
            m = update(tr, last.to(dev), key.to(dev))
        ms[who] = {k: float(v) for k, v in m.items()}
        ws[who] = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    _check_reference(f"{label} train step ({cfg.torso}, B=16, T=8)", tol, ms,
                     grads, ws, w0)


def _record_first_grads(net, opt, first):
    """Keep the first Adam step's gradients of ``net`` in ``first``."""
    opt.register_step_pre_hook(lambda o, a, k: (
        first.update({n: p.grad.detach().cpu().clone()
                      for n, p in net.named_parameters()})
        if not first else None))


def _check_reference(label, tol, ms, grads, ws, w0, part_of=None):
    """Card against CPU after the same update (see :func:`reference_train`):
    every metric within ``tol['metrics']``, each first gradient within
    ``tol['grad']`` of its L2 norm, each weight tensor within
    ``tol['weights']`` of the step's change in L2 norm. ``part_of`` maps a
    weight's name to (its part's name, the part's bounds), which then hold
    its gradient and weights, each part reported on its own."""
    merr = max(abs(ms["card"][k] - ms["cpu"][k]) for k in ms["cpu"])
    if not merr <= tol["metrics"]:
        raise AssertionError(f"{label} metrics card vs CPU: {ms}")
    worst = {}
    for k, gc in grads["cpu"].items():
        part, t = part_of(k) if part_of else ("", tol)
        e = float((grads["card"][k] - gc).norm() / gc.norm())
        d = float((ws["card"][k] - ws["cpu"][k]).norm()
                  / (ws["cpu"][k] - w0[k]).norm())
        if not (e <= t["grad"] and d <= t["weights"]):
            raise AssertionError(
                f"{label} {k}: first gradient {e:.3e} of its norm apart, "
                f"weights {d:.3e} of the step's change apart")
        ge, we, _ = worst.get(part, (0.0, 0.0, t))
        worst[part] = (max(ge, e), max(we, d), t)
    parts = "; ".join(
        f"{part + ': ' if part else ''}first minibatch's gradients within "
        f"{ge:.3e} of their L2 norm (tolerance {t['grad']:g}); weights "
        f"within {we:.3e} of the step's change (tolerance {t['weights']:g})"
        for part, (ge, we, t) in worst.items())
    print(f"[reference] float32 {label}, "
          f"card vs CPU: metrics max abs err {merr:.3e} (tolerance "
          f"{tol['metrics']:g}); {parts}; loss {ms['card']['loss']:.5f} "
          f"card, {ms['cpu']['loss']:.5f} CPU")


def reference_image(seed):
    """Image observations on the card against the CPU, bit-equal, over an
    autoreset run (goal_cycle 13x13, 4 agents, B = 32, T = 16, episodes of
    12 steps, prestige over all 8 levels), in the standard and the (N, B)
    s2d layouts; the cnn_s2d policy's logits and values card vs CPU in
    float32 (TF32 off) within 1e-3 absolute (two float32 conv stacks that
    sum in different orders; a layout fault moves them by far more); then
    the float32 image train step of :func:`reference_train`."""
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.models import ActorCritic
    from marlgrid_tpu_torch.parallel import ppo

    ep, _ = _train_config("image")
    B, T, N = 32, 16, ep.n_agents
    runs = {}
    for dev in ("cpu", "cuda"):
        key = rng.PRNGKey(seed, device=dev)
        s = _spread_prestige(ep, grid_gen.reset(ep, rng.split(key, B)))
        pool = step.fresh_pool(ep, rng.fold_in(key, 7), 8)
        acts = rng.randint(rng.fold_in(key, 3), (T, B, N), 0, 7)
        views = []
        for t in range(T):
            s, _, _, _ = step.step_autoreset_with_fresh_batch(
                ep, s, acts[t], step.fresh_pool_rows(pool, t, 0, B), salt=t)
            views.append((obs.all_obs_image_b(ep, s),
                          obs.all_obs_image_b(ep, s, bminor=True, s2d=True),
                          int((s.step_count == 0).sum())))
        runs[dev] = views
    for t in range(T):
        for i, layout in enumerate(("standard", "(N, B) s2d")):
            if not torch.equal(runs["cpu"][t][i], runs["cuda"][t][i].cpu()):
                raise AssertionError(f"image obs ({layout}) differ card vs "
                                     f"CPU at step {t}")
    n_done = sum(v[2] for v in runs["cuda"])
    print(f"[reference] image obs bit-equal card vs CPU over {T} steps x {B} "
          f"envs ({n_done} resets), standard and (N, B) s2d layouts")

    cfg = ppo.PPOConfig(hidden=128, torso="cnn_s2d", dtype=torch.float32)
    net_c = ActorCritic(cfg, 7, torch.Generator().manual_seed(seed),
                        device="cpu", tile_size=ep.view_tile_size)
    net_g = ActorCritic(cfg, 7, device="cuda", tile_size=ep.view_tile_size)
    net_g.load_state_dict(net_c.state_dict())
    x = runs["cpu"][-1][1]                          # (N, B, 14, 14, 48)
    with torch.no_grad():
        lc, vc = net_c(x)
        lg, vg = net_g(x.cuda())
    err = max(float((lc - lg.cpu()).abs().max()),
              float((vc - vg.cpu()).abs().max()))
    if lg.shape != (N, B, 7) or not err <= 1e-3:
        raise AssertionError(f"cnn_s2d logits/values card vs CPU differ by "
                             f"{err} ({tuple(lg.shape)})")
    print(f"[reference] cnn_s2d logits and values card vs CPU: max abs err "
          f"{err:.3e} (float32, tolerance 1e-3)")
    reference_train(seed, "image")
    reference_train(seed, "image", "gru")
    reference_train(seed, "encode", rows=True)
    reference_train(seed, "image", rows=True)


def phase_rollout(seed, card):
    """One T = 64 rollout at the train CLI's defaults (:func:`cli_config`),
    the launch counts read around it, then three more calls timed."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.models import ActorCritic
    from marlgrid_tpu_torch.parallel import ppo

    ep, cfg = cli_config()
    pals = cfg.embed_palettes
    B, T, N = cfg.n_envs, cfg.rollout_len, ep.n_agents
    net = ActorCritic(cfg, ep.view_size, torch.Generator().manual_seed(seed),
                      device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    rollout = ppo.make_rollout(ep, cfg, net, device="cuda")
    sync()

    zero_counts()
    t0 = time.perf_counter()
    env, key2, traj, last = rollout(env, rng.fold_in(key, 2))
    sync()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = want_counts(transpose_bk=T + 1, onehot_embed_fwd=T + 1)
    print(f"[rollout] launches on the main path: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"rollout: launches {counts}, want {want}")

    if traj["obs"].shape != (T, N, 147, B) or traj["obs"].dtype != \
            torch.uint8:
        raise AssertionError(f"trajectory obs {traj['obs'].shape}")
    for k in ("logp", "val"):
        if not torch.isfinite(traj[k]).all():
            raise AssertionError(f"non-finite {k}")
    if not torch.isfinite(last).all():
        raise AssertionError("non-finite last_value")
    with torch.no_grad():
        logits, _ = net(traj["obs"][-1])
    if logits.shape != (N, B, 7) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    if not ((traj["act"] >= 0) & (traj["act"] < 7)).all():
        raise AssertionError("actions out of range")
    for p, vocab in enumerate(pals):
        seen = torch.unique(traj["obs"][:, :, p * 49:(p + 1) * 49]).cpu()
        if not set(seen.tolist()) <= set(vocab):
            raise AssertionError(f"plane {p} codes {seen.tolist()} outside "
                                 f"the palette {vocab}")
    n_done = int(traj["done"].sum())
    if n_done <= 0:
        raise AssertionError("no episode ended: the autoreset never ran")
    print(f"[rollout] B={B} T={T}: first call {dt:.3f} s "
          f"({B * T / dt:,.0f} env-steps/s), {n_done} episodes ended, "
          f"mean reward/step {float(traj['rew'].mean()):.4f} [{card}]")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        env, key2, traj2, _ = rollout(env, key2)
        sync()
        reps.append(time.perf_counter() - t0)
    dt2 = sorted(reps)[1]
    print(f"[rollout] 3 more calls: {', '.join(f'{r:.3f}' for r in reps)} "
          f"s; median {B * T / dt2:,.0f} env-steps/s [{card}]")
    return dict(counts=counts, first_s=dt, steady_s=reps,
                env_steps_per_s=B * T / dt2, episodes=n_done,
                obs=traj2["obs"][-1].contiguous(), traj_obs=traj2["obs"],
                net=net, ep=ep, cfg=cfg, env=env, key=key2)


def phase_train(seed, card, steps=2):
    """The train path at the train CLI's defaults (:func:`cli_config`):
    ``make_train_step`` (rollout + 2 epochs x 4 minibatches of 2048 blocks
    of 128 samples), ``steps`` calls, the launch counts read around each
    call."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo

    ep, cfg = cli_config()
    B, T = cfg.n_envs, cfg.rollout_len
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(seed),
                              device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    # the eager step (jit=False): the profile phase reads its stages
    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda", jit=False)
    w0 = [p.detach().clone() for p in net.parameters()]
    want = want_counts(
        transpose_bk=T + 1,
        onehot_embed_fwd=T + 1 + cfg.n_epochs * cfg.n_minibatches,
        onehot_embed_bwd=cfg.n_epochs * cfg.n_minibatches)
    secs, metrics = [], []
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        env, key, m = step(env, key)
        sync()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"train step {i}: launches {counts}, want "
                                 f"{want}")
        hashes = hash_launches()
        m = {k: float(v) for k, v in m.items()}
        if not (math.isfinite(m["loss"]) and m["entropy"] > 0
                and m["n_episodes"] > 0):
            raise AssertionError(f"train step {i}: metrics {m}")
        metrics.append(m)
        print(f"[train] step {i}: {secs[-1]:.3f} s, loss {m['loss']:.5f}, "
              f"entropy {m['entropy']:.4f}, ratio_dev {m['ratio_dev']:.4f}, "
              f"{m['n_episodes']:.0f} episodes, return "
              f"{m['episode_return']:.4f}")
    if all(torch.equal(p, q) for p, q in zip(net.parameters(), w0)):
        raise AssertionError("the train steps changed no weight")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[train] launches per train step on the train path: {counts} "
          f"(want {want}); {HASH} {hashes}")
    print(f"[train] B={B} T={T}, 2 epochs x 4 minibatches: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s "
          f"[{card}]")
    return dict(counts=dict(counts, **{HASH: hashes}), seconds=secs,
                metrics=metrics, env_steps_per_s=B * T / steady, step=step,
                env=env, key=key, ep=ep, cfg=cfg, net=net, opt=opt)


def phase_rnn(seed, card, steps=2):
    """The recurrent encode train path at full width (``--rnn gru``'s
    :func:`cli_config`: goal_cycle 13x13, 4 agents, B = 4096, T = 64, hidden
    128, palettes, board pool 256) with the plane-major embed selected:
    ``steps`` calls of ``make_train_step_rnn``, the launch counts read
    around each (K1 65, K5f 73 = 65 rollout + 8 minibatches, K5b 8; K2f,
    K2b and K3 none), each step's loss and train env-steps/s."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    ep, cfg = cli_config("--rnn", "gru")
    B, T = cfg.n_envs, cfg.rollout_len
    with embed_v2(True):
        net, opt, h = ppo_rnn.init_state_rnn(
            ep, cfg, torch.Generator().manual_seed(seed), device="cuda")
    if not net.torso0.plane_major:
        raise AssertionError("rnn phase: the plane-major embed is not on")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    # the eager step (jit=False): the profile phase and chip_pair.py read
    # its stages
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cuda",
                                       jit=False)
    n_up = cfg.n_epochs * cfg.n_minibatches
    want = want_counts(transpose_bk=T + 1, onehot_embed2_fwd=T + 1 + n_up,
                       onehot_embed2_bwd=n_up)
    w0 = [p.detach().clone() for p in net.parameters()]
    secs, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        env, h, key, m = step(env, h, key)
        sync()
        secs.append(time.perf_counter() - t0)
        got = read_counts()
        if got != want:
            raise AssertionError(f"rnn train step {i}: launches {got}, want "
                                 f"{want}")
        m = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(v) for v in m.values())
                and m["entropy"] > 0 and m["n_episodes"] > 0
                and bool(torch.isfinite(h).all())):
            raise AssertionError(f"rnn train step {i}: metrics {m}")
        metrics.append(m)
        print(f"[rnn] train step {i}: {secs[-1]:.3f} s, loss "
              f"{m['loss']:.5f}, entropy {m['entropy']:.4f}, ratio_dev "
              f"{m['ratio_dev']:.4f}, {m['n_episodes']:.0f} episodes, return "
              f"{m['episode_return']:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if all(torch.equal(p, q) for p, q in zip(net.parameters(), w0)):
        raise AssertionError("the rnn train steps changed no weight")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[rnn] launches per recurrent train step: {got} (want {want})")
    print(f"[rnn] B={B} T={T}, GRU, plane-major embed, 2 epochs x 4 "
          f"minibatches of 8 sequence blocks: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s; "
          f"peak device memory {peak_gb:.2f} GB [{card}]")
    return dict(counts=got, seconds=secs, metrics=metrics, peak_gb=peak_gb,
                env_steps_per_s=B * T / steady, step=step, env=env, h=h,
                key=key, ep=ep, cfg=cfg, net=net, opt=opt)


def phase_rnn_image(seed, card, steps=2):
    """The recurrent image train path at full width (``--rnn gru --obs
    image``: cnn_s2d, minibatches of 64 sequence blocks of 16 envs x 64
    steps re-rendered from stored states): ``steps`` train steps with K1
    and K3 73 launches each (65 in the rollout, one per minibatch's
    re-render), the loss, the peak device memory and train env-steps/s."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    ep, cfg = cli_config("--rnn", "gru", "--obs", "image")
    B, T = cfg.n_envs, cfg.rollout_len
    net, opt, h = ppo_rnn.init_state_rnn(
        ep, cfg, torch.Generator().manual_seed(seed), device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cuda",
                                       jit=False)
    n_up = cfg.n_epochs * cfg.n_minibatches
    want = want_counts(transpose_bk=T + 1 + n_up,
                       compose_image_b=T + 1 + n_up)
    secs, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        env, h, key, m = step(env, h, key)
        sync()
        secs.append(time.perf_counter() - t0)
        got = read_counts()
        if got != want:
            raise AssertionError(f"rnn image train step {i}: launches {got}, "
                                 f"want {want}")
        m = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(v) for v in m.values())
                and m["entropy"] > 0 and m["n_episodes"] > 0
                and tuple(h.shape) == (B, ep.n_agents, cfg.hidden)
                and bool(torch.isfinite(h).all())):
            raise AssertionError(f"rnn image train step {i}: metrics {m}, "
                                 f"carry {tuple(h.shape)}")
        metrics.append(m)
        print(f"[rnn-image] train step {i}: {secs[-1]:.3f} s, loss "
              f"{m['loss']:.5f}, entropy {m['entropy']:.4f}, ratio_dev "
              f"{m['ratio_dev']:.4f}, {m['n_episodes']:.0f} episodes, mean "
              f"episode return {m['episode_return']:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[rnn-image] launches per step: {got} (want {want})")
    print(f"[rnn-image] B={B} T={T}, cnn_s2d + GRU: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s; "
          f"peak device memory {peak_gb:.2f} GB [{card}]")
    return dict(counts=got, seconds=secs, metrics=metrics, peak_gb=peak_gb,
                env_steps_per_s=B * T / steady)


def cli_config(*flags, rows=False):
    """(EnvParams, PPOConfig) that ``python -m
    marlgrid_tpu_torch.parallel.train`` builds from ``flags``: at no flags
    the train path's config (goal_cycle 13x13 with reward_decay off, 4
    agents, 7x7 views, B = 4096, T = 64, hidden 128, mlp torso with the
    palettes, 2 epochs x 4 minibatches, board pool 256); with ``--obs
    image`` the image train path's (8-pixel tiles, the cnn_s2d torso,
    recompute_image_obs, no palettes); with ``--torso cnn`` the encode
    row store's (channels (32, 64), no palettes). ``rows``: with
    ``recompute_image_obs=False`` (``PPOConfig`` only: the CLI has no flag
    for it), the image row store."""
    import dataclasses

    from marlgrid_tpu_torch.parallel import train

    ep, cfg = train.build(train.parse_args(list(flags)))
    if rows:
        cfg = dataclasses.replace(cfg, recompute_image_obs=False)
    return ep, cfg


#: the row store's full-width paths: (train CLI flags, recompute_image_obs
#: off). 'cnn': the JAX CLI's --torso cnn; 'image-rows': image obs stored
#: as rendered s2d pixels, the store recompute_image_obs replaced
ROW_PATHS = {"cnn": (("--torso", "cnn"), False),
             "image-rows": (("--obs", "image"), True)}


def path_counts(ep, cfg, plane_major):
    """The kernel launches of one train step of any path: on the row store
    K1 once per render of the rollout (T + 1) and K3 as often on image
    rows, none in the update (it reads the stored rows); on every other
    path :func:`hetero_counts`'s (a homogeneous path is one group)."""
    from marlgrid_tpu_torch.parallel import ppo

    if not (ep.has_hetero_obs or cfg.rnn) and \
            ppo.storage(ep, cfg) == ppo.ROWS:
        T1 = cfg.rollout_len + 1
        image = ep.observation_style == "image"
        return want_counts(transpose_bk=T1, compose_image_b=T1 * image)
    return hetero_counts(ep, cfg, plane_major)


def phase_rows(seed, card, name, steps=2):
    """The row store at full width (``ROW_PATHS[name]``): one rollout
    through ``make_rollout`` (K1 T + 1 = 65 times, K3 as often on image
    rows, every other kernel none; the stored (T, B*N, F) uint8 rows, their
    bytes, encode codes at most 176), then ``steps`` eager train steps
    (``jit=False``; the same launches per step: the update reads the
    stored rows), the launch counts read around each call, each step's
    metrics, train env-steps/s and the peak device memory; then one more
    eager step at T = 16 (the depth cut of :func:`phase_profile`) under
    torch.profiler, by stage (:func:`profile_stages`)."""
    import dataclasses

    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo

    flags, rows = ROW_PATHS[name]
    ep, cfg = cli_config(*flags, rows=rows)
    if ppo.storage(ep, cfg) != ppo.ROWS:
        raise AssertionError(f"{name}: not the row store")
    B, T, N = cfg.n_envs, cfg.rollout_len, ep.n_agents
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(seed),
                              device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    want = path_counts(ep, cfg, False)
    rollout = ppo.make_rollout(ep, cfg, net, device="cuda")
    sync()
    zero_counts()
    t0 = time.perf_counter()
    env, key, traj, last = rollout(env, key)
    sync()
    dt = time.perf_counter() - t0
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"{name} rollout: launches {counts}, want "
                             f"{want}")
    shape, _ = ppo.obs_spec(ep, cfg)
    F = math.prod(shape)
    obs = traj["obs"]
    if tuple(obs.shape) != (T, B * N, F) or obs.dtype != torch.uint8 or \
            tuple(traj["act"].shape) != (T, B, N):
        raise AssertionError(f"{name} trajectory: obs {tuple(obs.shape)} "
                             f"{obs.dtype}, actions "
                             f"{tuple(traj['act'].shape)}")
    top = int(obs.max())
    if ep.observation_style == "encode" and top > 176:
        raise AssertionError(f"{name}: a stored code of {top} > 176")
    for k in ("logp", "val"):
        if not torch.isfinite(traj[k]).all():
            raise AssertionError(f"{name} rollout: non-finite {k}")
    if not torch.isfinite(last).all() or \
            not ((traj["act"] >= 0) & (traj["act"] < 7)).all():
        raise AssertionError(f"{name} rollout: last_value or actions")
    n_done = int(traj["done"].sum())
    if n_done <= 0:
        raise AssertionError(f"{name} rollout: no episode ended")
    store_bytes = obs.numel() * obs.element_size()
    print(f"[rows] {name} ({' '.join(flags)}, torso {cfg.torso}) rollout "
          f"B={B} T={T}: first call {dt:.3f} s, launches {counts}; "
          f"trajectory store (T, B*N, F) = {tuple(obs.shape)} uint8, "
          f"{store_bytes:,} bytes ({store_bytes / 1e9:.2f} GB), largest "
          f"stored value {top}; {n_done} episodes ended [{card}]")
    del traj, obs, last
    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda", jit=False)
    w0 = [p.detach().clone() for p in net.parameters()]
    secs, metrics = [], []
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        env, key, m = step(env, key)
        sync()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"{name} train step {i}: launches "
                                 f"{counts}, want {want}")
        m = {k: float(v) for k, v in m.items()}
        if not (math.isfinite(m["loss"]) and m["entropy"] > 0
                and m["n_episodes"] > 0):
            raise AssertionError(f"{name} train step {i}: metrics {m}")
        metrics.append(m)
        print(f"[rows] {name} train step {i}: {secs[-1]:.3f} s, loss "
              f"{m['loss']:.5f}, entropy {m['entropy']:.4f}, ratio_dev "
              f"{m['ratio_dev']:.4f}, {m['n_episodes']:.0f} episodes, mean "
              f"episode return {m['episode_return']:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if all(torch.equal(p, q) for p, q in zip(net.parameters(), w0)):
        raise AssertionError(f"the {name} train steps changed no weight")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[rows] {name}: launches per train step {counts} (want {want}); "
          f"B={B} T={T}, 2 epochs x 4 minibatches of "
          f"{T * B * N // cfg.n_minibatches:,} rows: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} eager train "
          f"env-steps/s; peak device memory {peak_gb:.2f} GB [{card}]")
    del step
    step = ppo.make_train_step(ep, dataclasses.replace(cfg, rollout_len=16),
                               net, opt, device="cuda", jit=False)
    prof = profile_stages(lambda: step(env, key), ("rollout.", "update."),
                          card, f"one {name} train step (B={B}, T=16, "
                          f"torso {cfg.torso}, row store)")
    del net, opt, step, env, w0
    torch.cuda.empty_cache()
    return dict(counts=counts, rollout_first_s=dt, store_bytes=store_bytes,
                max_stored=top, seconds=secs, metrics=metrics,
                peak_gb=peak_gb, env_steps_per_s=B * T / steady,
                profile=prof)


def phase_image(seed, card, steps=2):
    """The image train path at full width (``--obs image``'s
    :func:`cli_config`): one
    rollout through ``make_rollout`` (65 launches each of K1 and K3), then
    ``steps`` train steps through ``make_train_step`` (73 each: 65 in the
    rollout, one per minibatch re-render; K2f and K2b none), the launch
    counts read around each call, the peak device memory, the mean episode
    return of each step and train env-steps/s."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo

    ep, cfg = cli_config("--obs", "image")
    B, T, N = cfg.n_envs, cfg.rollout_len, ep.n_agents
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(seed),
                              device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    rollout = ppo.make_rollout(ep, cfg, net, device="cuda")
    sync()
    zero_counts()
    t0 = time.perf_counter()
    env, key, traj, last = rollout(env, key)
    sync()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = want_counts(transpose_bk=T + 1, compose_image_b=T + 1)
    if counts != want:
        raise AssertionError(f"image rollout: launches {counts}, want {want}")
    st = traj["obs"]
    if tuple(st.agent_pos.shape) != (T, B, N, 2) or \
            tuple(traj["act"].shape) != (T, B, N):
        raise AssertionError(f"image trajectory: states "
                             f"{tuple(st.agent_pos.shape)}, actions "
                             f"{tuple(traj['act'].shape)}")
    for k in ("logp", "val"):
        if not torch.isfinite(traj[k]).all():
            raise AssertionError(f"image rollout: non-finite {k}")
    if not torch.isfinite(last).all() or \
            not ((traj["act"] >= 0) & (traj["act"] < 7)).all():
        raise AssertionError("image rollout: last_value or actions")
    roll_counts = counts
    n_done = int(traj["done"].sum())
    if n_done <= 0:
        raise AssertionError("image rollout: no episode ended")
    print(f"[image] rollout B={B} T={T} (cnn_s2d): first call {dt:.3f} s "
          f"({B * T / dt:,.0f} env-steps/s), launches {counts}, {n_done} "
          f"episodes ended [{card}]")

    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda", jit=False)
    w0 = [p.detach().clone() for p in net.parameters()]
    n_up = cfg.n_epochs * cfg.n_minibatches
    want = want_counts(transpose_bk=T + 1 + n_up,
                       compose_image_b=T + 1 + n_up)
    secs, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        env, key, m = step(env, key)
        sync()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"image train step {i}: launches {counts}, "
                                 f"want {want}")
        m = {k: float(v) for k, v in m.items()}
        if not (math.isfinite(m["loss"]) and m["entropy"] > 0
                and m["n_episodes"] > 0):
            raise AssertionError(f"image train step {i}: metrics {m}")
        metrics.append(m)
        print(f"[image] train step {i}: {secs[-1]:.3f} s, loss "
              f"{m['loss']:.5f}, entropy {m['entropy']:.4f}, ratio_dev "
              f"{m['ratio_dev']:.4f}, {m['n_episodes']:.0f} episodes, mean "
              f"episode return {m['episode_return']:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if all(torch.equal(p, q) for p, q in zip(net.parameters(), w0)):
        raise AssertionError("the image train steps changed no weight")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[image] launches per image train step: {counts} (want {want})")
    print(f"[image] B={B} T={T}, cnn_s2d, 2 epochs x 4 minibatches: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s; "
          f"peak device memory {peak_gb:.2f} GB [{card}]")
    return dict(counts=counts, rollout_counts=roll_counts, rollout_first_s=dt,
                seconds=secs, metrics=metrics, peak_gb=peak_gb,
                env_steps_per_s=B * T / steady, step=step, env=env, key=key,
                traj=traj, ep=ep, cfg=cfg, net=net, opt=opt)


#: the CLI phases' depth (the paths' own is 64)
T32 = ("--rollout", "32")


def phase_cli(card, flags=(), want=None, plane_major=False, spc=1,
              keep=None):
    """The training CLI at its defaults plus ``flags`` (the train path's
    config, the image train path's with ``--obs image``, the recurrent
    one's with ``--rnn gru``; the callers add :data:`T32`) on the card,
    graphed (``make_train_step*(...,
    jit=True)``, or with ``spc`` > 1 ``--steps-per-call spc``: one captured
    step replayed ``spc`` times a call): two calls with a checkpoint after
    the second, then one call resumed from it, the launch counts read
    around it (``want`` per iteration; with ``spc`` > 1 its first step runs
    eagerly and the others replay the graph captured on the restored
    tensors). ``plane_major``: run with ``MARLGRID_TPU_EMBED_V2=1``. A
    ``--rnn`` checkpoint must hold the carry of the whole batch, which the
    resumed run restores. ``keep``: a directory to copy the checkpoint to
    (for the evaluate phase)."""
    import shutil
    import tempfile

    from marlgrid_tpu_torch.parallel import train
    from marlgrid_tpu_torch.utils import checkpoint

    flags = list(flags) + (["--steps-per-call", str(spc)] if spc > 1 else [])
    with tempfile.TemporaryDirectory() as tmp:
        ck, log = f"{tmp}/ck", f"{tmp}/m.jsonl"
        t0 = time.perf_counter()
        with embed_v2(plane_major):
            train.main(flags + ["--iters", str(2 * spc), "--metrics", log,
                                "--checkpoint-dir", ck, "--checkpoint-every",
                                "2"])
        first = time.perf_counter() - t0
        if keep:
            shutil.copytree(ck, keep)
        recs = [json.loads(line) for line in open(log)]
        config = checkpoint.load_config(ck)
        if checkpoint.steps(ck) != [2] or config["ppo"]["n_envs"] != 4096:
            raise AssertionError("the CLI wrote no full-width checkpoint")
        if "--rnn" in flags:
            h = checkpoint.restore(ck, map_location="cpu")["h"]
            if tuple(h.shape) != (4, 4096, 128) or not h.abs().sum() > 0:
                raise AssertionError(f"the --rnn checkpoint's carry: "
                                     f"{tuple(h.shape)}")
        zero_counts()
        with embed_v2(plane_major):
            train.main(flags + ["--iters", str(spc), "--metrics", log,
                                "--resume", ck])
        counts = read_counts()
        recs += [json.loads(line) for line in open(log)]
    want = {k: spc * v for k, v in want.items()}
    if counts != want:
        raise AssertionError(f"resumed CLI iterations {flags}: launches "
                             f"{counts}, want {want}")
    for r in recs:
        if not (math.isfinite(r["loss"]) and r["n_episodes"] > 0):
            raise AssertionError(f"CLI metrics {r}")
    print(f"[cli] python -m marlgrid_tpu_torch.parallel.train "
          f"{' '.join(flags) or '(defaults)'} (torso "
          f"{config['ppo']['torso']}), graphed: {2 * spc} iterations + "
          f"checkpoint in {first:.2f} s, then {spc} resumed; launches "
          f"{counts}; "
          f"env_steps_per_s "
          f"{', '.join(format(r['env_steps_per_s'], ',.0f') for r in recs)} "
          f"[{card}]")
    return dict(env_steps_per_s=[r["env_steps_per_s"] for r in recs],
                returns=[r["episode_return"] for r in recs], counts=counts)


def _short_replay(ops, stage_map, events):
    """Where a traced replay lacks nodes of its stage map: the nodes
    lacking, the first node whose name the replay's op there does not
    agree with (from the start) and the last (from the end), the names of
    the map's first three nodes and the replay's first three ops, and the
    device ops outside every replay that start inside this one's span
    (records the trace holds under another correlation)."""
    from marlgrid_tpu_torch.utils import profiling

    names = stage_map["names"]
    got = [e.get("name", "") for e in ops]
    head = next((i for i, (a, b) in enumerate(zip(names, got))
                 if not profiling._agrees(a, b)), len(got))
    tail = next((i for i, (a, b) in enumerate(zip(names[::-1], got[::-1]))
                 if not profiling._agrees(a, b)), len(got))
    inside = {id(e) for e in ops}
    t0, t1 = ops[0]["ts"], max(e["ts"] + e["dur"] for e in ops)
    stray = [e.get("name", "")[:40] for e in events
             if e.get("cat") in profiling.DEVICE_CATS and id(e) not in inside
             and t0 <= e["ts"] <= t1]
    return dict(lacking=len(names) - len(got), first_off=head,
                last_off=len(names) - 1 - tail,
                map_head=[n[:40] for n in names[:3]],
                ops_head=[n[:40] for n in got[:3]],
                ops_before=sum(e.get("cat") in profiling.DEVICE_CATS
                               and e["ts"] < t0 for e in events),
                stray=len(stray), stray_names=stray[:3])


def phase_cli_tools(card):
    """The train CLI's two debugging tools, at B = 1024: ``--profile-dir``
    over 5 calls (T = 8: the traced calls 2-4 are graph replays), which
    must leave one trace and its stage map beside it; the trace read back
    by ``profiling.kernel_times`` and ``profiling.hotspots``, which must
    name a ``rollout.`` and an ``update.`` stage and put at least 95 % of
    the device time down to stages; each replay's traced op count is
    printed beside the map's node count (a replay that lost records is
    lined up by ``profiling.match``); then ``--debug-nans`` on the
    defaults (T = 64, graphed), 3 calls that must pass the finite check
    after each."""
    from marlgrid_tpu_torch.parallel import train
    from marlgrid_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        prof, log = f"{tmp}/prof", f"{tmp}/m.jsonl"
        t0 = time.perf_counter()
        train.main(["--envs", "1024", "--rollout", "8", "--iters", "5",
                    "--profile-dir", prof, "--metrics", log])
        prof_s = time.perf_counter() - t0
        files = sorted(os.listdir(prof))
        size = sum(os.path.getsize(f"{prof}/{f}") for f in files)
        traces = [f for f in files if f.endswith(".pt.trace.json.gz")]
        maps = [f for f in files if f.endswith(".stages.json.gz")]
        times = profiling.kernel_times(prof)
        hot = profiling.hotspots(prof, top=None)
        names = [n for _, n in hot]
        staged = sum(ms for ms, n in hot
                     if n.startswith(("step", "rollout", "update")))
        share = staged / max(sum(ms for ms, _ in hot), 1e-12)
        path = f"{prof}/{traces[0]}" if len(traces) == 1 else None
        events = profiling._events(path) if path else []
        replays = sorted(profiling._replays(events).items())
        counts = [len(ops) for _, ops in replays]
        maps = profiling._read_maps(path) if path else []
        nodes = [sum(n for _, n in m["stages"]) for m in maps]
        short = [_short_replay(ops, maps[0], events)
                 for _, ops in replays if maps and len(ops) < nodes[0]]
        if len(traces) != 1 or len(maps) != 1 or not times or not (
                any(n.startswith("rollout.") for n in names)
                and any(n.startswith("update.") for n in names)) \
                or share < 0.95:
            raise AssertionError(f"--profile-dir: files {files}, hotspots "
                                 f"{hot[:20]}, {share:.2%} by stage, "
                                 f"replays of {counts} ops, maps of {nodes}; "
                                 f"short replays {short}")
        print(f"[cli] --profile-dir (B=1024, T=8, 5 calls, calls 2-4 "
              f"traced): {prof_s:.1f} s, {files} {size:,} bytes; "
              f"{len(times)} kernel names, {sum(times.values()) / 1e3:.2f} "
              f"ms of device time; replays of {counts} ops against maps of "
              f"{nodes} nodes (short: {short}); {share:.4%} of the device "
              f"time by stage; "
              f"hotspots (ms, stage): "
              + "; ".join(f"{ms:.2f} {n}" for ms, n in hot[:8])
              + f" [{card}]")
        t0 = time.perf_counter()
        train.main(["--envs", "1024", "--iters", "3", "--debug-nans",
                    "--metrics", log])
        nan_s = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(log)]
    if len(recs) != 3 or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"--debug-nans: {recs}")
    print(f"[cli] --debug-nans (B=1024, T=64, graphed): 3 calls passed the "
          f"finite check in {nan_s:.1f} s; env_steps_per_s "
          f"{', '.join(format(r['env_steps_per_s'], ',.0f') for r in recs)}"
          f" [{card}]")
    return dict(profile_s=prof_s, trace_bytes=size, replay_ops=counts,
                map_nodes=nodes, short_replays=short, staged_share=share,
                hotspots=[[ms, n] for ms, n in hot[:20]],
                debug_nans_s=nan_s,
                debug_nans_env_steps_per_s=[r["env_steps_per_s"]
                                            for r in recs])


def phase_cli_cpu_resume(card):
    """A checkpoint written by the CLI on the CPU (Adam's step counts on
    the CPU, in its plain form) resumed on the card, where Adam is
    capturable and the step graphed: tiny config, one iteration on the
    CPU, two on the card (eager, then captured on the restored state)."""
    import tempfile

    from marlgrid_tpu_torch.parallel import train

    tiny = ["--scenario", "empty", "--grid-size", "9", "--agents", "2",
            "--envs", "64", "--rollout", "8", "--hidden", "32"]
    with tempfile.TemporaryDirectory() as tmp:
        ck, log = f"{tmp}/ck", f"{tmp}/m.jsonl"
        train.main(tiny + ["--device", "cpu", "--iters", "1",
                           "--checkpoint-dir", ck, "--checkpoint-every", "1"])
        net = train.main(tiny + ["--iters", "2", "--resume", ck,
                                 "--metrics", log])
        recs = [json.loads(line) for line in open(log)]
    if len(recs) != 2 or not all(math.isfinite(r["loss"]) for r in recs) \
            or not all(bool(torch.isfinite(p).all())
                       for p in net.parameters()):
        raise AssertionError(f"CPU checkpoint resumed on the card: {recs}")
    print(f"[cli] a CPU-written checkpoint (empty 9x9, B=64) resumed on the "
          f"card, graphed: 2 iterations, losses "
          f"{', '.join(format(r['loss'], '.5f') for r in recs)} [{card}]")


def profile_stages(run, prefixes, card, title):
    """Where the time of ``run()`` goes, by stage: torch.profiler over one
    call. Device time is the sum of the kernels' (and copies') durations.
    A kernel counts for the stage label whose span on the card's timeline
    holds its start; a kernel outside every such span (the autograd engine
    launches the backward from its own thread, outside the main thread's
    labels) counts for the label whose span on the host's timeline holds
    its start. Host time is the stage label's span on the host. It reads
    the profiler's raw events: ``prof.events()`` first builds a tree of
    every event, which takes a minute or more for an eager train step's
    events."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    kernels = [e for e in on_card if not e.is_user_annotation()]
    busy = sum(e.duration_ns() for e in kernels) / 1e9
    out = dict(wall_s=wall, device_busy_s=busy, device_ops=len(kernels),
               stages={}, top={})
    if busy <= 0:
        print(f"[profile] {title}: the profiler saw no device time: not "
              f"measured")
        return out

    def spans_of(evs):
        sp = sorted((e.start_ns(), e.end_ns(), e.name()) for e in evs
                    if e.name().startswith(prefixes))
        return [x[0] for x in sp], sp

    dev_starts, dev_spans = spans_of(e for e in on_card
                                     if e.is_user_annotation())
    host_starts, host_spans = spans_of(
        e for e in events if e.device_type() == DeviceType.CPU)

    def stage_of(t):
        for starts, spans in ((dev_starts, dev_spans),
                              (host_starts, host_spans)):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                return spans[i][2]
        return "(outside the stages)"

    stage = {}
    for e in kernels:
        ms = e.duration_ns() / 1e6
        d = stage.setdefault(stage_of(e.start_ns()), [0.0, 0])
        d[0] += ms
        d[1] += 1
        top = out["top"].setdefault(e.name()[:90], [0.0, 0])
        top[0] += ms
        top[1] += 1
    host = {}
    for st, en, name in host_spans:
        host[name] = host.get(name, 0.0) + (en - st) / 1e6
    print(f"[profile] {title}: wall {wall * 1e3:.1f} ms, kernels busy "
          f"{busy * 1e3:.1f} ms (device idle share {1 - busy / wall:.3f}), "
          f"{len(kernels)} device ops [{card}]")
    for name in sorted(set(stage) | set(host)):
        dev_ms, n = stage.get(name, (0.0, 0))
        out["stages"][name] = dict(host_ms=host.get(name, 0.0),
                                   device_ms=dev_ms, device_ops=n)
        print(f"[profile]   {name:22s} host {host.get(name, 0.0):9.2f} ms,"
              f" device {dev_ms:8.2f} ms in {n:7d} ops")
    for name, (ms, n) in sorted(out["top"].items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   device {ms:8.2f} ms x{n:6d}  {name[:70]}")
    return out


def phase_profile(roll, train, image, rnn, hetero, card, T=8, T_step=16):
    """torch.profiler over a T-step rollout of the rollout path's config,
    over one train step of the train path, one of the image train path, one
    of the recurrent encode train path (``update.cell`` is its update's
    cell loop) and one each of the all-encode hetero train paths,
    feedforward and recurrent (``hetero``: :func:`phase_hetero`'s results
    by path name). The train steps are those paths' nets, optimizers, env
    states and carries stepped at ``T_step`` steps (full width, the depth
    cut: an eager step under the profiler costs the host about a second
    per 5,000 launches, and its launches grow with T)."""
    import dataclasses

    from marlgrid_tpu_torch.parallel import ppo
    from marlgrid_tpu_torch.parallel import train as train_mod

    cfg = dataclasses.replace(roll["cfg"], rollout_len=T)
    rollout = ppo.make_rollout(roll["ep"], cfg, roll["net"], device="cuda")
    rollout(roll["env"], roll["key"])                  # warm-up
    sync()
    out = profile_stages(lambda: rollout(roll["env"], roll["key"]),
                         ("rollout.",), card, f"T={T} rollout")
    out["T"] = T
    out["device_ops_per_step"] = out["device_ops"] / T
    print(f"[profile] {out['device_ops_per_step']:.0f} device ops per "
          f"rollout step")

    def train_step(p, what):
        """One eager train step of phase result ``p`` at ``T_step``."""
        step = train_mod.make_step(
            p["ep"], dataclasses.replace(p["cfg"], rollout_len=T_step),
            p["net"], p["opt"], torch.device("cuda"), jit=False)
        carry = (p["env"], p["key"]) if p.get("h") is None else (
            p["env"], p["h"], p["key"])
        res = profile_stages(lambda: step(*carry), ("rollout.", "update."),
                             card, f"one {what} (B=4096, T={T_step})")
        res["T"] = T_step
        return res

    het, hrn = hetero["hetero"], hetero["hetero-rnn"]
    return dict(
        rollout=out, train_step=train_step(train, "train step"),
        image_train_step=train_step(image, "image train step (cnn_s2d)"),
        rnn_train_step=train_step(rnn, "recurrent train step (GRU, "
                                  "plane-major embed)"),
        hetero_train_step=train_step(het, "hetero train step (views "
                                     "7/5/7/5)"),
        hetero_rnn_train_step=train_step(hrn, "hetero recurrent train step "
                                         "(views 7/5/7/5, GRU, plane-major "
                                         "embed)"))


def phase_env_only(seed, card, style="encode"):
    """bench.py's config (build_params, main's defaults; ``--obs image``
    with ``style='image'``): cluttered 15x15, 3 agents, 25 clutter,
    B = 32768, board pool 256, T cut from 64 to 16 random actions, the
    batch-minor observations of every step folded into a checksum. K1 (and
    K3 for images) launches once per step."""
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors

    ep = EnvParams(width=15, height=15, n_agents=3, scenario="cluttered",
                   n_clutter=25, max_steps=250, view_size=7,
                   observation_style=style,
                   agent_colors=default_agent_colors(3))
    B, T = 32768, 16
    pool = max(k for k in range(1, 257) if B % k == 0)
    key = rng.PRNGKey(seed, device="cuda")
    state = grid_gen.reset(ep, rng.split(key, B))

    def run(state, key):
        fresh = step.fresh_pool(ep, rng.fold_in(key, 0xF), pool)
        acc = torch.zeros((), device="cuda")
        for t in range(T):
            ks = rng.split(key)
            key, ak = ks[0], ks[1]
            a = rng.randint(ak, (B, 3), 0, 7)
            state, rew, done, _ = step.step_autoreset_with_fresh_batch(
                ep, state, a, step.fresh_pool_rows(fresh, t, 0, B), salt=t)
            o = obs.all_agent_obs_b(ep, state, bminor=True)
            if style == "image":
                # an integer sum of the uint8 pixels: no float copy of them
                acc = acc + rew.sum() + o.sum(dtype=torch.int64) / o.numel()
            else:
                acc = acc + rew.sum() + o.float().mean()
        return state, key, acc

    state, key, acc = run(state, key)          # warm-up
    sync()
    want = want_counts(transpose_bk=T,
                       compose_image_b=T if style == "image" else 0)
    reps = []
    for _ in range(3):
        zero_counts()
        t0 = time.perf_counter()
        state, key, acc = run(state, key)
        checksum = float(acc)
        reps.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"env-only phase ({style}): launches "
                                 f"{counts}, want {want}")
        if not math.isfinite(checksum):
            raise AssertionError("env-only checksum is not finite")
    dt = sorted(reps)[1]
    print(f"[env] {style}: cluttered 15x15, 3 agents, B={B}, T={T}, pool "
          f"{pool}: {', '.join(f'{r:.3f}' for r in reps)} s; median "
          f"{B * T / dt:,.0f} env-steps/s, launches {counts} per run "
          f"[{card}]")
    return dict(env_steps_per_s=B * T / dt, seconds=reps, counts=counts,
                ep=ep, state=state)


def phase_host_shapes(palettes, card):
    """The kernels at the host path's shapes, each against its plain
    version: K1 at B = 1 (a single-column output; K = N * vs * vs of the
    host env's views), K2f and K5f at S in {1, 2, 4} samples of R in {1, 2,
    4} rows (evaluate's policies: one sample per agent row) with both
    vocabularies, two launches bit-equal, and K3 at B = 1 with 16-pixel
    tiles (``MultiGridEnv.render``'s agent povs) and 8-pixel ones (the
    host env's image obs) on the ids of real views, in the standard
    layout, bit-exact. Then each is timed at the host path's shape beside
    its bound, plain version and library call. Returns ({kernel: max
    |err|}, {timing name: record})."""
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2
    from marlgrid_tpu_torch.ops import sprite
    from marlgrid_tpu_torch.ops import transpose as T

    errs = dict.fromkeys(("transpose_bk", "onehot_embed_fwd",
                          "onehot_embed2_fwd", "compose_image_b"), 0.0)
    for K in (147, 196, 100, 75, 25):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, K), dtype=torch.int32,
                          device="cuda")
        n0 = T.transpose_bk.launches
        y = T.transpose_bk(x)
        sync()
        if T.transpose_bk.launches != n0 + 1 or y.shape != (K, 1) or \
                not torch.equal(y, T.transpose_bk_plain(x)):
            raise AssertionError(f"K1 at (1, {K}): not launched, or it "
                                 f"differs from x.t()")
    print("[host shapes] K1 at B=1, K in 147/196/100/75/25: bit-exact")
    gen = torch.Generator().manual_seed(5)
    for name, pal in (("full", None), ("goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        for R in (1, 2, 4):
            for S in (1, 2, 4):
                what = f"{name} (R={R}, F=147, S={S}, H=128)"
                x = _codes(R, 49, S, gen)
                w = (torch.randn(49, sum(widths), 128, generator=gen)
                     * 0.05).to(torch.bfloat16).cuda()
                ws = _tables2(49, widths, 128, gen)
                with torch.no_grad():
                    out, again = (E.onehot_embed(x, w, widths, values)
                                  for _ in range(2))
                    out2, again2 = (E2.onehot_embed2(x, *ws, widths, values)
                                    for _ in range(2))
                sync()
                errs["onehot_embed_fwd"] = max(
                    errs["onehot_embed_fwd"], _hold_k2f(
                        out, E.onehot_embed_plain(
                            x, w.float(), widths, values,
                            torch.float32).to(torch.bfloat16), what))
                errs["onehot_embed2_fwd"] = max(
                    errs["onehot_embed2_fwd"], _hold_k5f(
                        out2, E2.onehot_embed2_plain(x, *ws, widths, values),
                        what))
                if not (torch.equal(out, again) and torch.equal(out2,
                                                                again2)):
                    raise AssertionError(f"K2f or K5f {what}: two launches "
                                         f"differ")
    print("[host shapes] K2f and K5f at R, S in {1, 2, 4}: within their "
          "tolerances, two launches bit-equal")

    tim = {}
    for T_px, (N, W, scen) in ((16, (4, 13, "goal_cycle")),
                               (8, (3, 15, "cluttered"))):
        ep = EnvParams(width=W, height=W, n_agents=N, scenario=scen,
                       observation_style="image", view_tile_size=T_px,
                       agent_colors=default_agent_colors(N))
        key = rng.PRNGKey(T_px, device="cuda")
        st = grid_gen.reset(ep, rng.split(key, 1))
        for t in range(6):
            st = step.step(ep, st, rng.randint(rng.fold_in(key, t), (1, N),
                                               0, 7))[0]
        ids = obs.image_ids(ep, _spread_prestige(ep, st))
        n0 = sprite.compose_image_b.launches
        out = sprite.compose_image_b(ep, *ids)
        sync()
        err = max_byte_err(out, sprite.compose_image_b_plain(ep, *ids))
        if sprite.compose_image_b.launches != n0 + 1 or err != 0:
            raise AssertionError(f"K3 at B=1, T={T_px}: not launched, or "
                                 f"max abs err {err}")
        print(f"[host shapes] K3 at B=1, N={N}, T={T_px} "
              f"({tuple(out.shape)}): bit-exact")
        if T_px == 16:
            tim["compose_image_b_host"] = time_k3(
                ep, ids, {}, "host render's agent povs (B=1, T=16)", card,
                plain_iters=20)

    x = torch.randint(0, 2 ** 20, (1, 196), dtype=torch.int32,
                      device="cuda")
    k1 = dict(bytes=2 * x.numel() * 4, ops=0)
    k1["ms"], k1["host_ms"] = time_ms(lambda: T.transpose_bk(x))
    k1["plain_ms"], _ = time_ms(lambda: T.transpose_bk_plain(x))
    k1["library_ms"], _ = time_ms(lambda: x.t().contiguous())
    k1["max_abs_err"] = 0.0
    _bound(k1)
    print(f"[time] K1 (1, 196) int32 (the host env's encode views): "
          f"{k1['ms'] * 1e3:.2f} us (host {k1['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k1['plain_ms'] * 1e3:.2f} us, x.t().contiguous() "
          f"{k1['library_ms'] * 1e3:.2f} us, bound "
          f"{k1['bound_ms'] * 1e3:.5f} us ({k1['bound_by']}) [{card}]")
    tim["transpose_bk_host"] = k1
    widths, values = E.vocab(palettes)
    codes = _codes(4, 49, 1, gen)
    table = (torch.randn(49, sum(widths), 128, generator=gen) * 0.05).to(
        torch.bfloat16).cuda()
    tim["onehot_embed_fwd_host"] = time_k2f(
        codes, table, widths, values, "evaluate policy's shape", card)
    tim["onehot_embed2_fwd_host"] = time_k5f(
        codes, _tables2(49, widths, 128, gen), widths, values,
        "evaluate policy's shape", card)
    for name in errs:
        errs[name] = max([errs[name]] + [
            v["max_abs_err"] for k, v in tim.items() if k.startswith(name)])
    return errs, tim


def phase_rounding_ops(card):
    """What the reward-rounding repair costs on the card: the device ops
    (kernels in a profiler trace) and device time of the single-rounding
    decay and prestige update of ``core/step.py`` (``reward_decay``,
    ``fma_f32``), beside the formulas they replaced (one rounding per op),
    at a rollout step's shapes (B = 4096, N = 4); both run once per env
    step. The repair's slowest kernels are printed by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from marlgrid_tpu_torch.core.state import EnvParams
    from marlgrid_tpu_torch.core.step import fma_f32, reward_decay

    B, N = 4096, 4
    ep = EnvParams(max_steps=250)
    g = torch.Generator(device="cuda").manual_seed(0)
    pres = torch.rand((B, N), generator=g, device="cuda") * 10
    rew = torch.rand((B, N), generator=g, device="cuda") - 0.25
    count = torch.randint(1, 250, (B,), generator=g, device="cuda",
                          dtype=torch.int32)
    betas = torch.full((N,), 0.95, device="cuda")
    betas64 = betas.double()

    def old():
        decay = 1.0 - 0.9 * count.to(torch.float32) / 250
        r = rew * decay[:, None]
        return r, pres * betas + torch.clamp(r, min=0.0)

    def new():
        r = rew * reward_decay(ep, count)[:, None]
        return r, fma_f32(pres, betas64, torch.clamp(r, min=0.0))

    out = {}
    for name, fn in (("per-op rounding", old), ("single rounding", new)):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        kern = [(e.name(), e.duration_ns() / 1e3)
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
        ms, _ = time_ms(fn)
        out[name] = dict(device_ops=len(kern), ms=ms,
                         slowest=sorted(kern, key=lambda k: -k[1])[:4])
    a, b = out["per-op rounding"], out["single rounding"]
    out["added_ops"] = b["device_ops"] - a["device_ops"]
    print(f"[rounding] the decay and prestige update per env step (B={B}, "
          f"N={N}): per-op rounding {a['device_ops']} device ops, "
          f"{a['ms'] * 1e3:.2f} us; single rounding {b['device_ops']} ops, "
          f"{b['ms'] * 1e3:.2f} us: {out['added_ops']} ops added per env "
          f"step; its slowest kernels (traced us): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in b["slowest"])
          + f" [{card}]")
    return out


def phase_vector(seed, card, env_only_rate):
    """``VectorEnv.rollout_fn`` at bench.py's config #3 (cluttered 15x15,
    3 agents, 25 clutter, 7x7 encode views, B = 32768, T = 16) with a
    random policy (``rng.randint`` on each step's key), from a staggered
    start (env i at step i * 250 // B, so envs finish inside the run), in
    both reset modes (the shared fresh board, and ``independent_resets``):
    the raw eager rollout, then the graphed ``rollout_fn`` three times
    from the same start (its first call eager, the second captured, the
    third a replay), each bit-equal to the eager one in the final state
    and the whole trajectory; then replays chained from state to state,
    timed (env-steps/s) with the launch counts read around them (K1 once
    a step)."""
    from marlgrid_tpu_torch.core import rng, step
    from marlgrid_tpu_torch.core.state import (FIELDS, EnvParams,
                                               default_agent_colors)
    from marlgrid_tpu_torch.vector import VectorEnv

    ep = EnvParams(width=15, height=15, n_agents=3, scenario="cluttered",
                   n_clutter=25, max_steps=250, view_size=7,
                   observation_style="encode",
                   agent_colors=default_agent_colors(3))
    B, T = 32768, 16

    def policy(obs, key):
        return rng.randint(key, (B, 3), 0, 7)

    def same(a, b):
        return all(torch.equal(getattr(a[0], f), getattr(b[0], f))
                   for f in FIELDS) and all(torch.equal(a[1][k], b[1][k])
                                            for k in a[1])

    out = {}
    for independent, reps in ((False, 3), (True, 1)):
        mode = "independent resets" if independent else "shared board"
        env = VectorEnv(ep, B, independent_resets=independent)
        fn = env.rollout_fn(policy, T)
        key = rng.PRNGKey(seed, device="cuda")
        s0 = step.stagger_step_counts(env.reset(rng.fold_in(key, 1))[0],
                                      ep.max_steps)
        k0 = rng.fold_in(key, 2)
        sync()
        t0 = time.perf_counter()
        ref_state, _, ref_traj = fn.graph.fn(s0, k0)
        sync()
        eager_s = time.perf_counter() - t0
        ref = (ref_state.clone(), {k: v.clone() for k, v in ref_traj.items()})
        del ref_state, ref_traj
        n_done = int(ref[1]["done"].sum())
        if not n_done:
            raise AssertionError(f"vector ({mode}): no env finished")
        calls = []
        for what in ("first call (eager)", "capture", "replay"):
            sync()
            t0 = time.perf_counter()
            got = fn(s0, k0)
            sync()
            calls.append(time.perf_counter() - t0)
            if not same(got, ref):
                raise AssertionError(f"vector ({mode}): the {what} differs "
                                     f"from the eager rollout")
            del got
        zero_counts()
        st = s0
        sync()
        t0 = time.perf_counter()
        for i in range(reps):
            st, traj = fn(st, rng.fold_in(k0, i))
        sync()
        dt = time.perf_counter() - t0
        counts = read_counts()
        if counts != want_counts(transpose_bk=reps * T) or not bool(
                torch.isfinite(traj["rew"]).all()):
            raise AssertionError(f"vector ({mode}): launches {counts}, want "
                                 f"K1 {reps * T}")
        rate = B * T * reps / dt
        out["independent" if independent else "shared"] = dict(
            env_steps_per_s=rate, eager_env_steps_per_s=B * T / eager_s,
            calls_s=calls, capture_s=fn.graph.capture_s, counts=counts,
            done=n_done)
        print(f"[vector] rollout_fn ({mode}), cluttered 15x15, 3 agents, "
              f"B={B}, T={T}: graphed calls bit-equal to the eager rollout "
              f"({n_done} env resets in it); eager {B * T / eager_s:,.0f} "
              f"env-steps/s, graphed {rate:,.0f} env-steps/s ({reps} chained "
              f"replays, capture {fn.graph.capture_s:.2f} s), env-only eager "
              f"phase {env_only_rate:,.0f}; launches {counts} [{card}]")
        del fn, env, st, traj, ref
        torch.cuda.empty_cache()
    return out


def _compare_host(g, c, what):
    """Two host envs' current observations (given), encode() and render()
    bit-equal."""
    if not np.array_equal(g.encode(), c.encode()):
        raise AssertionError(f"{what}: encode() differs card vs CPU")
    if not np.array_equal(g.render(), c.render()):
        raise AssertionError(f"{what}: render() differs card vs CPU")


def _same_obs(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_obs(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b)) and \
        np.asarray(a).dtype == np.asarray(b).dtype


def phase_host_api(seed, card):
    """The host API on the card against the same env on the CPU: ``make(
    'MarlGrid-3AgentCluttered15x15-v0')`` (image obs, 7x7 views of 8-pixel
    tiles), a goal-cycle env from ``env_from_config`` (13x13, 4 agents,
    encode obs) and ``make('MarlGrid-2AgentDoorKey11x11-v0')`` (image): one
    episode each to done on a seeded action stream, obs, rewards, done,
    ``encode()`` and ``render()`` bit-equal at every step, and
    ``render(show_agent_views=True)`` (the agent povs at 16-pixel tiles,
    K3 at B = 1) at the first and last; then one more episode on the card
    alone for the per-step wall. The launch counts are read around the
    card's episodes."""
    from marlgrid_tpu_torch import envs

    cases = (
        ("make('MarlGrid-3AgentCluttered15x15-v0')",
         lambda dev: envs.make("MarlGrid-3AgentCluttered15x15-v0",
                               seed=seed, device=dev)),
        ("env_from_config(goal_cycle 13x13, 4 agents, encode)",
         lambda dev: envs.env_from_config(dict(
             env_class="goal_cycle", n_agents=4, grid_size=13,
             view_size=7, observation_style="encode", seed=seed),
             device=dev)),
        ("make('MarlGrid-2AgentDoorKey11x11-v0')",
         lambda dev: envs.make("MarlGrid-2AgentDoorKey11x11-v0", seed=seed,
                               device=dev)))
    out = {}
    for name, mk in cases:
        g, c = mk("cuda"), mk("cpu")
        acts = np.random.default_rng(seed).integers(
            0, 7, (g.params.max_steps + 1, g.num_agents), dtype=np.int32)
        zero_counts()
        og, oc = g.reset(), c.reset()
        if not all(map(_same_obs, og, oc)):
            raise AssertionError(f"host API {name}: reset obs differ")
        _compare_host(g, c, name)
        for t, a in enumerate(acts):
            og, rg, dg, _ = g.step(a)
            oc, rc, dc, _ = c.step(a)
            if not (all(map(_same_obs, og, oc)) and np.array_equal(rg, rc)
                    and rg.dtype == rc.dtype and dg is dc):
                raise AssertionError(f"host API {name}: step {t} differs "
                                     f"card vs CPU")
            _compare_host(g, c, f"{name} step {t}")
            if t == 0 or dg:
                views = [e.render(tile_size=16, show_agent_views=True)
                         for e in (g, c)]
                if not np.array_equal(*views):
                    raise AssertionError(f"{name}: render with the agent "
                                         f"views differs at step {t}")
            if dg:
                break
        counts = read_counts()
        if not dg or counts["compose_image_b"] == 0 or (
                g.params.observation_style == "encode"
                and counts["transpose_bk"] == 0):
            raise AssertionError(f"host API {name}: done {dg}, launches "
                                 f"{counts}")
        g.reset()
        n = 0
        sync()
        t0 = time.perf_counter()
        done = False
        while not done:
            _, _, done, _ = g.step(acts[n % len(acts)])
            n += 1
        wall = (time.perf_counter() - t0) / n
        out[name] = dict(steps=t + 1, counts=counts, step_ms=wall * 1e3)
        print(f"[host API] {name}: an episode of {t + 1} steps bit-equal "
              f"card vs CPU (obs, rewards, done, encode, render, agent "
              f"views); launches {counts}; {wall * 1e3:.2f} ms per step on "
              f"the card over {n} steps [{card}]")
    return out


#: the evaluate phase's episode cap (the checkpoints' envs run to 250): its
#: depth, cut to keep the run's time
EVAL_STEPS = 100


def phase_evaluate(ckpts, card):
    """``python -m marlgrid_tpu_torch.parallel.evaluate --checkpoint <dir>
    --episodes 1 --max-steps EVAL_STEPS`` on the checkpoints the CLI phases
    wrote at full width
    (goal_cycle 13x13, 4 agents, hidden 128: mlp, ``--rnn gru`` on the
    plane-major embed, the hetero population 7/5/7/5, ``--torso cnn``),
    with the launch counts read around each: K1 once per host observation
    per group, K2f (K5f for the plane-major checkpoint; none for 'cnn')
    once per step per group. Then the
    card's policy against the plain CPU forward of the same checkpoint on
    the first 8 steps' observations, logits within 5e-2 (bf16 layers after
    the embed, as the reference phase's bound), carries held alike."""
    from marlgrid_tpu_torch.parallel import evaluate
    from marlgrid_tpu_torch.vector import obs_groups
    from marlgrid_tpu_torch.wrapper import MultiGridEnv

    out = {}
    for name, (ck, plane_major) in ckpts.items():
        embed = "onehot_embed2_fwd" if plane_major else "onehot_embed_fwd"
        with embed_v2(plane_major):
            zero_counts()
            stats = evaluate.main(["--checkpoint", ck, "--episodes", "1",
                                   "--max-steps", str(EVAL_STEPS)])
            counts = read_counts()
            args = evaluate.parse_args(["--checkpoint", ck])
            ep, cfg = evaluate.resolve_config(args)
            ng = len(obs_groups(ep)) if ep.has_hetero_obs else 1
            # the 'cnn' torso's first layer is its convolutions: no embed
            want = want_counts(
                transpose_bk=ng * (stats["steps"] + stats["episodes"]),
                **{embed: ng * stats["steps"] * (cfg.torso == "mlp")})
            if counts != want or not math.isfinite(stats["mean_return"]):
                raise AssertionError(f"evaluate {name}: launches {counts}, "
                                     f"want {want}; stats {stats}")
            nets = {}
            for dev in ("cuda", "cpu"):
                a = evaluate.parse_args(["--checkpoint", ck, "--device",
                                         dev])
                evaluate.resolve_config(a)
                nets[dev] = evaluate.restore_policy(a, ep, cfg)
        groups = ([(list(idxs), gp.observation_style, "mlp")
                   for idxs, gp in obs_groups(ep)] if ep.has_hetero_obs
                  else [(list(range(ep.n_agents)), args.obs, cfg.torso)])
        env = MultiGridEnv(params=ep, seed=1, device="cpu")
        obs_list = env.reset()
        hs = {dev: nets[dev][1]() for dev in nets}
        worst = 0.0
        for t in range(8):
            acts = np.zeros(ep.n_agents, np.int64)
            for g, (idxs, style, torso) in enumerate(groups):
                logits = {}
                for dev, (net, _) in nets.items():
                    n = net[g] if ep.has_hetero_obs else net
                    h = hs[dev]
                    hg = h[g] if isinstance(h, dict) else h
                    x, aux = evaluate.style_obs_batch(
                        [obs_list[i] for i in idxs], ep, style, torso, dev)
                    with torch.no_grad():
                        logits[dev], hg = evaluate.policy_logits(n, x, aux,
                                                                 hg)
                    if isinstance(h, dict):
                        h[g] = hg
                    else:
                        hs[dev] = hg
                err = float((logits["cuda"].cpu() - logits["cpu"]).abs()
                            .max())
                worst = max(worst, err)
                acts[idxs] = logits["cpu"].argmax(-1).numpy()
            obs_list, _, _, _ = env.step(acts)
        if not worst < 5e-2:
            raise AssertionError(f"evaluate {name}: card logits differ from "
                                 f"the CPU's by {worst}")
        step_ms = stats["seconds"] / stats["steps"] * 1e3
        out[name] = dict(stats=stats, counts=counts, step_ms=step_ms,
                         logit_err=worst)
        print(f"[evaluate] {name}: {json.dumps({k: stats[k] for k in ('episodes', 'mean_return', 'returns', 'mean_length', 'video')})}; "
              f"{stats['steps']} steps, {step_ms:.2f} ms per step (host env "
              f"+ policy + sync); launches {counts}; logits card vs CPU max "
              f"abs err {worst:.3e} over 8 steps (tolerance 5e-2) [{card}]")
    return out


def _bag_rows(codes, widths, values, cells, cw):
    """(n_valid, bag_idx): the in-vocabulary codes' count, and each
    sample's F row indices into the flattened (cells * cw + 1, H) table,
    the last row (zeros) for "no row"."""
    from marlgrid_tpu_torch.ops import embed as E

    R, Fd, S = codes.shape
    lut = torch.as_tensor(E.slot_table(widths, values), device="cuda").long()
    plane = torch.arange(Fd, device="cuda") // cells
    slot = lut[plane[None, :, None], codes.long()]       # (R, F, S)
    cell = torch.arange(Fd, device="cuda") % cells
    rows = torch.where(slot >= 0, cell[None, :, None] * cw + slot,
                       cells * cw)
    return (int((slot >= 0).sum()),
            rows.permute(0, 2, 1).reshape(R * S, Fd).contiguous())


def _threefry_draws(seed):
    """Name -> a draw of ``ops/threefry.py`` at every caller shape of
    ``core/rng.py``, at the benchmark's widths (B 4096 and 32768 keys, the
    encode train and acting cells' Gumbel draws, a rank's part of a draw,
    strided key views), on the card."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.ops import threefry as TF

    g = torch.Generator().manual_seed(seed)

    def keys(*batch):
        return torch.randint(0, 2 ** 32, batch + (2,), generator=g,
                             dtype=torch.int64).cuda()

    one, k4096, k32768 = keys(), keys(4096), keys(32768)
    ks = TF.threefry2x32_draw_plain(TF.split_draw(k4096, 2))
    ids = torch.arange(32768, device="cuda")
    hi, lo, sub = rng.part_counts((4, 8192, 7), (1, 4096, 8192), "cuda")
    return {
        "fold_in int, one key": TF.fold_in_draw(one, 0xA110),
        "fold_in int, B 4096": TF.fold_in_draw(k4096, 0xA110),
        "fold_in int, B 32768": TF.fold_in_draw(k32768, 7),
        "fold_in per-key int64, B 32768": TF.fold_in_draw(k32768, ids),
        "fold_in per-key int32, B 4096": TF.fold_in_draw(
            k4096, ids[:4096].int() - 5),
        "fold_in one key by 32768 ids": TF.fold_in_draw(one, ids),
        "fold_in strided keys ks[:, 1], B 4096": TF.fold_in_draw(
            ks[:, 1], ids[:4096]),
        "split one key into 2": TF.split_draw(one, 2),
        "split one key into 32768": TF.split_draw(one, 32768),
        "split B 4096 into 2": TF.split_draw(k4096, 2),
        "split B 32768 into 2": TF.split_draw(k32768, 2),
        "split strided keys ks[:, 0], B 4096": TF.split_draw(ks[:, 0], 2),
        "bits one key (4, 4096, 7)": TF.bits_draw(one, 4 * 4096 * 7,
                                                  (4, 4096, 7)),
        "bits one key (4, 32768, 7)": TF.bits_draw(one, 4 * 32768 * 7,
                                                   (4, 32768, 7)),
        "bits B 4096 keys (4,)": TF.bits_draw(k4096, 4, (4,)),
        "bits B 32768 keys ()": TF.bits_draw(k32768, 1, ()),
        "bits strided keys ks[:, 1], B 4096 (4,)": TF.bits_draw(
            ks[:, 1], 4, (4,)),
        "bits part (4, 8192, 7)[:, 4096:]": TF.bits_draw(one, (hi, lo), sub),
    }


def _threefry_bound(d):
    """:func:`_bound` of a draw: its bytes (each int64 output written once;
    each distinct key, the count tables and the data read once), and about
    70 32-bit integer instructions an element (20 rounds of an add, a
    funnel shift and a xor, the key adds, the index arithmetic) at 16.7 T/s
    (132 SMs x 64 lanes x 1.98 GHz)."""
    n = d.rows.shape[0] * d.counts
    key_rows = 1 if d.rows.stride(0) == 0 else d.rows.shape[0]
    nbytes = 8 * n * (1 if d.xor else 2) + 16 * key_rows + sum(
        t.numel() * t.element_size() for t in (d.hi, d.lo, d.data)
        if t is not None)
    return _bound(dict(bytes=nbytes, ops=70 * n,
                       ops_per_s=132 * 64 * 1.98e9))


def phase_threefry(seed, card):
    """The threefry2x32 kernel (``csrc/threefry.cu``) against the plain hash
    evaluating the same draw on the card, bit-equal, at every caller shape
    (:func:`_threefry_draws`): eagerly (one launch a draw), then all the
    draws captured in one CUDA graph and replayed; ``rng``'s samplers card
    against CPU; then each draw's device time a launch (CUDA events, eager
    and in a graph of 50 launches) beside its bound and the plain
    version's time."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.ops import threefry as TF

    draws = _threefry_draws(seed)
    n0 = hash_launches()
    eager = {name: TF.threefry2x32(d) for name, d in draws.items()}
    sync()
    if hash_launches() != n0 + len(draws):
        raise AssertionError(f"threefry2x32: {hash_launches() - n0} "
                             f"launches for {len(draws)} draws")
    for name, d in draws.items():
        if not torch.equal(eager[name], TF.threefry2x32_draw_plain(d)):
            raise AssertionError(f"threefry2x32 {name}: differs from the "
                                 f"plain hash")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    n0 = hash_launches()
    with torch.cuda.graph(graph, stream=stream):
        captured = {name: TF.threefry2x32(d) for name, d in draws.items()}
    if hash_launches() != n0 + len(draws):
        raise AssertionError("threefry2x32: the capture did not record one "
                             "launch a draw")
    for t in captured.values():
        t.zero_()
    graph.replay()
    sync()
    for name in draws:
        if not torch.equal(captured[name], eager[name]):
            raise AssertionError(f"threefry2x32 {name}: the graph's replay "
                                 f"differs from the eager launch")
    print(f"[threefry] {len(draws)} draws: kernel bit-equal to the plain "
          f"hash, eagerly and replayed in one CUDA graph")
    g = torch.Generator().manual_seed(seed + 1)
    k = torch.randint(0, 2 ** 32, (64, 2), generator=g, dtype=torch.int64)
    for what, fn in (
            ("split", lambda x: rng.split(x, 3)),
            ("fold_in", lambda x: rng.fold_in(x, torch.arange(
                64, device=x.device))),
            ("random_bits", lambda x: rng.random_bits(x, (5, 7))),
            ("uniform part", lambda x: rng.uniform(
                x[0], (4, 64, 7), part=(1, 16, 48))),
            ("permutation", lambda x: rng.permutation(x, 4))):
        if not torch.equal(fn(k.cuda()).cpu(), fn(k)):
            raise AssertionError(f"rng.{what}: card differs from the CPU")
    print("[threefry] rng's split, fold_in, random_bits, uniform (a part) "
          "and permutation: card bit-equal to the CPU")
    out = {}
    for name, d in draws.items():
        t = _threefry_bound(d)
        t["ms"], t["host_ms"] = time_ms(lambda: TF.threefry2x32(d),
                                        iters=200)
        t["graph_ms"] = graph_ms(lambda: TF.threefry2x32(d))
        t["plain_ms"], _ = time_ms(lambda: TF.threefry2x32_draw_plain(d),
                                   iters=10)
        t["elements"] = d.rows.shape[0] * d.counts
        out[name] = t
        print(f"[threefry] {name}: {t['elements']:,} elements, "
              f"{t['ms'] * 1e3:.2f} us a launch ({t['graph_ms'] * 1e3:.2f} "
              f"in a graph), bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.1f} us "
              f"[{card}]")
    return out


def _bound(k):
    """The least time for ``k``'s work: its bytes at the memory rate, its
    operations at ``k['ops_per_s']`` (float32 outside the tensor cores
    unless it says otherwise), whichever is longer."""
    t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = k["ops"] / k.get("ops_per_s", F32_OPS_PER_S) * 1e3
    k["bound_ms"] = max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


def _least_route(k, adds, mma):
    """Set ``k``'s operations to the lesser of its two routes: ``adds``
    float32 adds at 67 TFLOP/s, or a dense bf16 product of ``mma``
    operations at 989 TFLOP/s (``adds_ms`` and ``mma_ms`` kept beside)."""
    k.update(adds_ms=adds / F32_OPS_PER_S * 1e3,
             mma_ms=mma / BF16_OPS_PER_S * 1e3)
    if k["mma_ms"] < k["adds_ms"]:
        k.update(ops=mma, ops_per_s=BF16_OPS_PER_S)
    else:
        k.update(ops=adds)
    return k


def _onehot_bf16(bag_idx, rows):
    """The (samples, rows) one-hot count matrix of :func:`_bag_rows`'
    indices, bf16 (entries 0 or 1, exact): indices past the table (no row)
    drop out."""
    onehot = torch.zeros(bag_idx.shape[0], rows + 1, dtype=torch.bfloat16,
                         device="cuda")
    onehot.scatter_add_(1, bag_idx, torch.ones_like(
        bag_idx, dtype=torch.bfloat16))
    return onehot[:, :-1].contiguous()


def _vocab_name(values):
    return "full vocabulary" if values is None else "palette"


def time_k2f(codes, table, widths, values, where, card):
    """K2f held against its plain version (:func:`_hold_k2f`) and timed
    beside its bound, its plain version and two one-call yardsticks:
    embedding_bag(sum) over each sample's F row indices, and the
    tensor-core route, ``torch.mm`` of the one-hot matrix (built before the
    timing, bf16) by the bf16 table (``library_mm_ms``). The bound is the
    least time over the routes: its bytes (codes, table, bf16 output) at
    the memory rate, or else the lesser of its float32 adds (one per
    in-vocabulary code per hidden unit) and the dense bf16 product
    (2 * samples * cells * cw * H)."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E

    R, Fd, S = codes.shape
    cells, cw, H = table.shape
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    k = _least_route(
        dict(bytes=codes.numel() + table.numel() * 2 + R * S * H * 2),
        n_valid * H, 2 * R * S * cells * cw * H)
    what = f"{where} (R={R}, F={Fd}, S={S}, H={H}, {_vocab_name(values)})"
    with torch.no_grad():
        kern = E.onehot_embed(codes, table, widths, values)
        k["max_abs_err"] = _hold_k2f(kern, E.onehot_embed_plain(
            codes, table.float(), widths, values, torch.float32).to(
                torch.bfloat16), what)
        k["ms"], k["host_ms"] = time_ms(
            lambda: E.onehot_embed(codes, table, widths, values))
        k["plain_ms"], _ = time_ms(lambda: E.onehot_embed_plain(
            codes, table, widths, values, torch.bfloat16), iters=5,
            warmup=1)
        bag_w = torch.cat([table.reshape(cells * cw, H),
                           torch.zeros(1, H, dtype=table.dtype,
                                       device="cuda")])
        k["library_ms"], _ = time_ms(
            lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"))
        bag = F.embedding_bag(bag_idx, bag_w, mode="sum").reshape(R, S, H)
        gap = float((bag.float() - kern.float()).abs().max())
        del bag, bag_w
        onehot = _onehot_bf16(bag_idx, cells * cw)
        w2 = table.reshape(cells * cw, H)
        k["library_mm_ms"], _ = time_ms(lambda: torch.mm(onehot, w2),
                                        iters=20)
        mm_gap = float((torch.mm(onehot, w2).float().reshape(R, S, H)
                        - kern.float()).abs().max())
        del onehot
    _bound(k)
    print(f"[time] K2f at the {what}, {n_valid} of {codes.numel()} codes "
          f"in the vocabulary: {k['ms'] * 1e3:.2f} us (host "
          f"{k['host_ms'] * 1e3:.2f} us per call), plain "
          f"{k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"{k['library_ms'] * 1e3:.2f} us (max abs diff to K2f {gap:.3e}), "
          f"torch.mm of the one-hot by the table "
          f"{k['library_mm_ms'] * 1e3:.2f} us (max abs diff {mm_gap:.3e}), "
          f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}; float32 "
          f"adds {k['adds_ms'] * 1e3:.2f} us, bf16 product "
          f"{k['mma_ms'] * 1e3:.2f} us) [{card}]")
    return k


def time_k2b(codes, table, widths, values, card, seed):
    """K2b at the update's shape beside its bound, its plain version and
    two one-call yardsticks: the backward of embedding_bag(sum) over the
    same row indices (timed as forward + backward minus forward), and the
    tensor-core route, ``torch.mm`` of the one-hot matrix (built before the
    timing, bf16, transposed) by ``dout`` (``library_mm_ms``); with a bf16
    dout like the one the update gives it. The bound is the least time over
    the routes: its bytes at the memory rate, or else the lesser of its
    float32 adds (one per in-vocabulary code per hidden unit) at 67 TFLOP/s
    and the dense bf16 product (2 * samples * cells * cw * H) at
    989 TFLOP/s."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E

    R, Fd, S = codes.shape
    cells, cw, H = table.shape
    gen = torch.Generator().manual_seed(seed)
    dout = (torch.randn(R, S, H, generator=gen) * 1e-3).to(
        torch.bfloat16).cuda()
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    k = _least_route(
        dict(bytes=codes.numel() + dout.numel() * 2 + cells * cw * H * 4),
        n_valid * H, 2 * R * S * cells * cw * H)
    k["ms"], k["host_ms"] = time_ms(
        lambda: E.onehot_embed_bwd(codes, dout, widths, values))
    k["plain_ms"], _ = time_ms(lambda: E.onehot_embed_bwd_plain(
        codes, dout, widths, values), iters=3, warmup=1)
    bag_w = torch.cat([table.reshape(cells * cw, H),
                       torch.zeros(1, H, dtype=table.dtype, device="cuda")])
    bag_w.requires_grad_(True)
    d_flat = dout.reshape(R * S, H)
    fwd_ms, _ = time_ms(lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"),
                        iters=10)
    both_ms, _ = time_ms(lambda: torch.autograd.grad(
        F.embedding_bag(bag_idx, bag_w, mode="sum"), bag_w, d_flat),
        iters=10)
    k["library_ms"] = both_ms - fwd_ms
    (g,) = torch.autograd.grad(F.embedding_bag(bag_idx, bag_w, mode="sum"),
                               bag_w, d_flat)
    kern = E.onehot_embed_bwd(codes, dout, widths, values)
    gap = float((g[:-1].float().reshape(cells, cw, H) - kern).abs().max())
    del g, bag_w
    onehot = _onehot_bf16(bag_idx, cells * cw)
    k["library_mm_ms"], _ = time_ms(lambda: torch.mm(onehot.t(), d_flat),
                                    iters=20)
    mm_gap = float((torch.mm(onehot.t(), d_flat).float().reshape(
        cells, cw, H) - kern).abs().max())
    del onehot
    _bound(k)
    print(f"[time] K2b at the update's shape (R={R}, F={Fd}, S={S}, H={H}, "
          f"palette, {n_valid} codes in the vocabulary): "
          f"{k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"backward {k['library_ms'] * 1e3:.2f} us (forward+backward "
          f"{both_ms * 1e3:.2f} us minus forward {fwd_ms * 1e3:.2f} us; its "
          f"bf16 gradient within {gap:.3e} of K2b's), torch.mm of the "
          f"one-hot by dout {k['library_mm_ms'] * 1e3:.2f} us (its bf16 "
          f"product within {mm_gap:.3e} of K2b's), bound "
          f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}; float32 adds "
          f"{k['adds_ms'] * 1e3:.2f} us, bf16 product "
          f"{k['mma_ms'] * 1e3:.2f} us) [{card}]")
    return k


def time_k5f(codes, ws, widths, values, where, card):
    """K5f held against its plain version (:func:`_hold_k5f`) and timed
    beside its bound, its plain version and two one-call yardsticks:
    embedding_bag(sum) over each sample's F row indices into the float32
    tables, and ``torch.mm`` of the one-hot matrix (built before the
    timing, bf16) by the packed bf16 tables (``library_mm_ms``; its output
    is bf16, K5f's float32). The bound is the least time over the routes:
    its bytes (codes, bf16 tables, float32 output) at the memory rate, or
    else the lesser of its float32 adds and the dense bf16 product."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    R, Fd, S = codes.shape
    cells, H = Fd // 3, ws[0].shape[-1]
    cw = sum(widths)
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    k = _least_route(
        dict(bytes=codes.numel() + cells * cw * H * 2 + R * S * H * 4),
        n_valid * H, 2 * R * S * cells * cw * H)
    what = f"{where} (R={R}, F={Fd}, S={S}, H={H}, {_vocab_name(values)})"
    with torch.no_grad():
        kern = E2.onehot_embed2(codes, *ws, widths, values)
        k["max_abs_err"] = _hold_k5f(kern, E2.onehot_embed2_plain(
            codes, *ws, widths, values), what)
        k["ms"], k["host_ms"] = time_ms(
            lambda: E2.onehot_embed2(codes, *ws, widths, values))
        k["plain_ms"], _ = time_ms(lambda: E2.onehot_embed2_plain(
            codes, *ws, widths, values), iters=5, warmup=1)
        packed = E.pack_weights(*ws).reshape(cells * cw, H)
        bag_w = torch.cat([packed.float(), torch.zeros(1, H, device="cuda")])
        k["library_ms"], _ = time_ms(
            lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"))
        bag = F.embedding_bag(bag_idx, bag_w, mode="sum").reshape(R, S, H)
        gap = float((bag - kern).abs().max())
        del bag, bag_w
        onehot = _onehot_bf16(bag_idx, cells * cw)
        w2 = packed.to(torch.bfloat16).contiguous()
        k["library_mm_ms"], _ = time_ms(lambda: torch.mm(onehot, w2),
                                        iters=20)
        del onehot
    _bound(k)
    print(f"[time] K5f at the {what}, {n_valid} of {codes.numel()} codes "
          f"in the vocabulary: {k['ms'] * 1e3:.2f} us (host "
          f"{k['host_ms'] * 1e3:.2f} us per call), plain "
          f"{k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"{k['library_ms'] * 1e3:.2f} us (float32 tables; max abs diff to "
          f"K5f {gap:.3e}), torch.mm of the one-hot by the bf16 tables "
          f"{k['library_mm_ms'] * 1e3:.2f} us (bf16 out), bound "
          f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}; float32 adds "
          f"{k['adds_ms'] * 1e3:.2f} us, bf16 product "
          f"{k['mma_ms'] * 1e3:.2f} us) [{card}]")
    return k


def time_k5b(codes, ws, widths, values, where, card, seed):
    """K5b held against its plain version and timed beside its bound, its
    plain version and two one-call yardsticks: the backward of
    embedding_bag(sum) over the same row indices into the float32 tables
    (forward + backward minus forward), and ``torch.mm`` of the one-hot
    matrix (built before the timing, bf16, transposed) by dout
    (``library_mm_ms``), with a bf16 dout. The bound is K2b's: the least
    time over the routes (bytes, float32 adds, the dense bf16 product)."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    R, Fd, S = codes.shape
    cells, H = Fd // 3, ws[0].shape[-1]
    cw = sum(widths)
    gen = torch.Generator().manual_seed(seed)
    dout = (torch.randn(R, S, H, generator=gen) * 1e-3).to(
        torch.bfloat16).cuda()
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    k = _least_route(
        dict(bytes=codes.numel() + dout.numel() * 2 + cells * cw * H * 4),
        n_valid * H, 2 * R * S * cells * cw * H)
    what = f"{where} (R={R}, F={Fd}, S={S}, H={H}, {_vocab_name(values)})"
    k["ms"], k["host_ms"] = time_ms(
        lambda: E2.onehot_embed2_bwd(codes, dout, widths, values))
    k["plain_ms"], _ = time_ms(lambda: E2.onehot_embed2_bwd_plain(
        codes, dout, widths, values), iters=3, warmup=1)
    bag_w = torch.cat([E.pack_weights(*ws).float().reshape(cells * cw, H),
                       torch.zeros(1, H, device="cuda")])
    bag_w.requires_grad_(True)
    d_flat = dout.float().reshape(R * S, H)
    fwd_ms, _ = time_ms(lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"),
                        iters=10)
    both_ms, _ = time_ms(lambda: torch.autograd.grad(
        F.embedding_bag(bag_idx, bag_w, mode="sum"), bag_w, d_flat),
        iters=10)
    k["library_ms"] = both_ms - fwd_ms
    del bag_w
    onehot = _onehot_bf16(bag_idx, cells * cw)
    d_bf16 = dout.reshape(R * S, H)
    k["library_mm_ms"], _ = time_ms(lambda: torch.mm(onehot.t(), d_bf16),
                                    iters=20)
    del onehot
    kern = E2.onehot_embed2_bwd(codes, dout, widths, values)
    refs = E2.onehot_embed2_bwd_plain(codes, dout, widths, values)
    k["max_abs_err"] = max(float((a - b).abs().max())
                           for a, b in zip(kern, refs))
    if not all(float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
               for a, b in zip(kern, refs)):
        raise AssertionError(f"K5b at the {what}: max abs err "
                             f"{k['max_abs_err']}")
    _bound(k)
    print(f"[time] K5b at the {what}, {n_valid} codes in the vocabulary: "
          f"{k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"backward {k['library_ms'] * 1e3:.2f} us (forward+backward "
          f"{both_ms * 1e3:.2f} us minus forward {fwd_ms * 1e3:.2f} us), "
          f"torch.mm of the one-hot (transposed) by dout "
          f"{k['library_mm_ms'] * 1e3:.2f} us, bound "
          f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}; float32 adds "
          f"{k['adds_ms'] * 1e3:.2f} us, bf16 product "
          f"{k['mma_ms'] * 1e3:.2f} us) [{card}]")
    return k


def phase_timings_k5(roll, rnn, card, seed):
    """K5f at the rollout's shape (the rollout phase's last observation,
    (4, 147, 4096)) and at the recurrent update's (one minibatch of the
    rollout phase's trajectory cut into the recurrent sequence blocks: 8
    blocks of 64 steps x 4 agents x 128 envs, laid out (L, mb, N) as the
    update's torso reads them: R = 2048, S = 128), and K5b at the update's,
    with the recurrent phase's tables."""
    from marlgrid_tpu_torch.parallel import ppo_rnn

    emb = rnn["net"].torso0
    ws = [w.detach().contiguous() for w in emb.tables()]
    widths, values = emb.widths, emb.values
    cfg = rnn["cfg"]
    obs = roll["traj_obs"]                               # (T, N, F, B)
    T, N, Fd, B = obs.shape
    c = ppo_rnn.sequence_block_size(B, 1, cfg.n_minibatches)
    G = B // c
    blocks = obs.reshape(T, N, Fd, G, c).permute(3, 0, 1, 2, 4)
    pick = torch.randperm(G, generator=torch.Generator().manual_seed(seed))
    mb = blocks[pick[:G // cfg.n_minibatches].cuda()]   # (mb, T, N, F, c)
    codes = mb.transpose(0, 1).reshape(-1, Fd, c).contiguous()
    return dict(
        onehot_embed2_fwd=time_k5f(roll["obs"], ws, widths, values,
                                   "rollout's shape", card),
        onehot_embed2_fwd_update=time_k5f(codes, ws, widths, values,
                                          "recurrent update's shape", card),
        onehot_embed2_bwd=time_k5b(codes, ws, widths, values,
                                   "recurrent update's shape", card, seed))


def phase_timings_5x5(hetero, card, seed):
    """K2f, K5f and K5b at a hetero 5x5 view group's update shape (R =
    1024 blocks of S = 128, 25 cells, the full vocabulary: hetero runs have
    no palettes), on the codes and tables of the first update minibatch of
    the hetero and the hetero recurrent train phases (K5b with a random
    bf16 dout, as at the recurrent update's shape)."""
    from marlgrid_tpu_torch.ops import embed as E

    x, tables, widths, values = hetero["hetero"]["embed_5x5"]
    out = dict(onehot_embed_fwd_5x5=time_k2f(
        x, E.pack_weights(*tables).to(torch.bfloat16).contiguous(), widths,
        values, "hetero 5x5 group's update shape", card))
    x, tables, widths, values = hetero["hetero-rnn"]["embed_5x5"]
    tables = [t.contiguous() for t in tables]
    out["onehot_embed2_fwd_5x5"] = time_k5f(
        x, tables, widths, values, "hetero 5x5 group's update shape", card)
    out["onehot_embed2_bwd_5x5"] = time_k5b(
        x, tables, widths, values, "hetero 5x5 group's update shape", card,
        seed)
    return out


def time_k3(ep, ids, layout, where, card, plain_iters=3):
    """K3 on ``ids`` in its caller's ``layout`` beside its bound (output
    bytes plus id bytes; the float multiplies of agent-covered bytes as its
    operations), its plain version and ``F.embedding`` of the base ids
    alone: no single PyTorch call computes the composite, and a gather of
    the base sprites, which writes the same bytes, is a floor for any
    library route. Then K3's output against its plain version's on the same
    ids, bit-exact (max abs err 0)."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import sprite

    base_id, agent_id, _ = ids
    N, vs, _, B = base_id.shape
    T = ep.view_tile_size
    blut, alut = sprite.tables(T, base_id.device)
    covered = (alut[..., 3] > 0).sum((1, 2))          # alpha pixels per row
    k = dict(bytes=N * B * (vs * T) ** 2 * 3 + 3 * base_id.numel() * 4,
             ops=int(covered[agent_id.long()].sum()) * 3)
    k["ms"], k["host_ms"] = time_ms(
        lambda: sprite.compose_image_b(ep, *ids, **layout), iters=20)
    k["plain_ms"], _ = time_ms(
        lambda: sprite.compose_image_b_plain(ep, *ids, **layout),
        iters=plain_iters, warmup=1)
    idx = base_id.reshape(-1).long()
    table = blut.reshape(blut.shape[0], -1)
    k["library_ms"], _ = time_ms(lambda: F.embedding(idx, table), iters=20)
    del idx, table
    out = sprite.compose_image_b(ep, *ids, **layout)
    ref = sprite.compose_image_b_plain(ep, *ids, **layout)
    k["max_abs_err"] = max_byte_err(out, ref)
    if k["max_abs_err"] != 0:
        raise AssertionError(f"K3 differs from its plain version at the "
                             f"{where}: max abs err {k['max_abs_err']}")
    del out, ref
    _bound(k)
    k["granule"] = sprite.granule(T, layout.get("s2d", False))
    print(f"[time] K3 at the {where} ({N * B} images of {vs * T}x{vs * T}x3,"
          f" {layout}, {k['granule']}-byte granules): "
          f"{k['ms'] * 1e3:.2f} us (host "
          f"{k['host_ms'] * 1e3:.2f} us per call), plain "
          f"{k['plain_ms'] * 1e3:.2f} us, F.embedding of the base ids "
          f"{k['library_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.2f} "
          f"us ({k['bound_by']}: {k['bytes'] / 1e6:.1f} MB); bit-exact "
          f"against the plain version [{card}]")
    return k


def phase_timings_k3(image, env_img, card, seed):
    """K3's device times at its three shapes: the image rollout's render
    (the final env state of the image phase, standard s2d layout), the
    update's minibatch re-render (2048 random state blocks of the image
    rollout's trajectory, 65,536 envs, (N, B) s2d layout) and the image
    env-only render (B = 32768, N = 3, (N, B) layout), each also held
    bit-exact against the plain version."""
    from marlgrid_tpu_torch.core import obs
    from marlgrid_tpu_torch.parallel import ppo

    ep, cfg = image["ep"], image["cfg"]
    B, T = cfg.n_envs, cfg.rollout_len
    out = dict(rollout=time_k3(ep, obs.image_ids(ep, image["env"]),
                               dict(s2d=True), "image rollout's shape", card))
    c = ppo.state_block_size(B, T)
    G = T * (B // c)
    pick = torch.randperm(G, generator=torch.Generator().manual_seed(seed))
    pick = pick[:G // cfg.n_minibatches].cuda()
    mb = image["traj"]["obs"].map(
        lambda x: x.reshape((G, c) + x.shape[2:])[pick].reshape(
            (-1,) + x.shape[2:]))
    out["update"] = time_k3(ep, obs.image_ids(ep, mb),
                            dict(nb_layout=True, s2d=True), "update's shape",
                            card, plain_iters=2)
    del mb
    out["env_only"] = time_k3(env_img["ep"],
                              obs.image_ids(env_img["ep"], env_img["state"]),
                              dict(nb_layout=True), "image env-only shape",
                              card, plain_iters=2)
    return out


def phase_timings(roll, card, seed):
    """The kernels' device times (launches queued behind a busy card) and
    host times per call (card idle), at the rollout's shapes (K1, K2f) and
    the update's (K2f, K2b: a minibatch of 2048 blocks of the rollout
    phase's trajectory, the train path's layout)."""
    from marlgrid_tpu_torch.ops import transpose as T
    from marlgrid_tpu_torch.parallel import ppo

    # K1 at the rollout's shape: (B, K) = (4096, 4 * 49)
    x = torch.randint(0, 2 ** 20, (4096, 196), dtype=torch.int32,
                      device="cuda")
    k1 = dict(bytes=2 * x.numel() * 4, ops=0)
    k1["ms"], k1["host_ms"] = time_ms(lambda: T.transpose_bk(x))
    k1["graph_ms"] = graph_ms(lambda: T.transpose_bk(x))
    k1["plain_ms"], _ = time_ms(lambda: T.transpose_bk_plain(x))
    k1["library_ms"], _ = time_ms(lambda: x.t().contiguous())
    _bound(k1)
    print(f"[time] K1 (4096, 196) int32: {k1['ms'] * 1e3:.2f} us (one CUDA "
          f"graph of 50 launches {k1['graph_ms'] * 1e3:.2f} us a launch; "
          f"host {k1['host_ms'] * 1e3:.2f} us per call), plain "
          f"{k1['plain_ms'] * 1e3:.2f} us, x.t().contiguous() "
          f"{k1['library_ms'] * 1e3:.2f} us, bound "
          f"{k1['bound_ms'] * 1e3:.2f} us ({k1['bound_by']}) [{card}]")

    emb = roll["net"].torso0
    table = emb.table().detach().to(torch.bfloat16).contiguous()
    widths, values = emb.widths, emb.values
    # K2f on the rollout's last observation with the rollout's weights
    k2 = time_k2f(roll["obs"], table, widths, values, "rollout's shape",
                  card)
    # the update's minibatch: blocks (G, F, c) of the stored trajectory
    cfg = roll["cfg"]
    blocks = ppo.obs_blocks(roll["traj_obs"], ppo.block_size(
        cfg.n_envs, cfg.rollout_len, roll["ep"].n_agents))
    G = blocks.shape[0]
    pick = torch.randperm(G, generator=torch.Generator().manual_seed(seed))
    codes = blocks[pick[:G // cfg.n_minibatches].cuda()].contiguous()
    k2u = time_k2f(codes, table, widths, values, "update's shape", card)
    k2b = time_k2b(codes, table, widths, values, card, seed)
    return dict(transpose_bk=k1, onehot_embed_fwd=k2,
                onehot_embed_fwd_update=k2u, onehot_embed_bwd=k2b)


def _k4_time(x, what, card):
    """K4's device time on ``x`` beside its bound (each element read once
    and written once), the plain version's, the library call's
    (``x.permute(1, 0, 3, 2).contiguous()``, which the plain version is)
    and that of a device-to-device copy of the same bytes (``x.clone()``),
    the rate a well-formed copy reaches on this card."""
    from marlgrid_tpu_torch.ops import transpose as T

    k = dict(shape=list(x.shape), dtype=str(x.dtype),
             bytes=2 * x.numel() * x.element_size(), ops=0, max_abs_err=0.0)
    k["ms"], k["host_ms"] = time_ms(lambda: T.transpose_traj(x), iters=20)
    k["plain_ms"], _ = time_ms(lambda: T.transpose_traj_plain(x), iters=20)
    k["library_ms"], _ = time_ms(
        lambda: x.permute(1, 0, 3, 2).contiguous(), iters=20)
    k["copy_ms"], _ = time_ms(lambda: x.clone(), iters=20)
    _bound(k)
    print(f"[time] K4 at {what} {tuple(x.shape)} {x.dtype}: "
          f"{k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, "
          f"x.permute(1, 0, 3, 2).contiguous() {k['library_ms'] * 1e3:.2f} "
          f"us, x.clone() {k['copy_ms'] * 1e3:.2f} us, bound "
          f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}: "
          f"{k['bytes'] / 1e6:.1f} MB), {k['bound_ms'] / k['ms']:.2f} of "
          f"the bound [{card}]")
    return k


def phase_transpose_traj(traj_obs, card):
    """K4 (transpose_traj) against its plain version, bit for bit, and two
    launches bit-equal: on the encode rollout's trajectory obs ``traj_obs``,
    (T, N, F, B) = (64, 4, 147, 4096) uint8 (154.1 MB), and in uint8 and
    int32 on a hetero 5x5 group's trajectory (64, 2, 75, 4096), on random
    odd shapes, on a B off the 16-byte vector with full tiles elsewhere,
    on a view whose data pointer is off 16-byte alignment (storage offset
    1), on T * N = 75,000 planes (past the old grid's 65,535), and on wide
    F (4- and 1-vector tile rows, the latter past 48 KB of shared memory);
    then its device time at the encode trajectory's shape, the 5x5
    group's, and the encode shape in int32, each beside its bound. No train
    path launches K4 (its TPU kernel has no caller either): the launches
    it reports are this probe's."""
    from marlgrid_tpu_torch.ops import transpose as T

    gen = torch.Generator().manual_seed(5)

    def rand(shape, dtype, offset=0):
        n = math.prod(shape) + offset
        if dtype == torch.uint8:
            v = torch.randint(0, 256, (n,), generator=gen,
                              dtype=torch.int32).to(torch.uint8)
        else:
            v = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                              dtype=torch.int32)
        return v.cuda()[offset:].view(shape)

    n0 = T.transpose_traj.launches
    cases = [("encode trajectory", traj_obs)]
    for dtype in (torch.uint8, torch.int32):
        for what, shape, offset in (
                ("hetero 5x5 trajectory", (64, 2, 75, 4096), 0),
                ("random odd", (5, 3, 75, 300), 0),
                ("random odd", (3, 2, 33, 31), 0),
                ("B off the vector", (4, 3, 147, 4100), 0),
                ("data pointer off 16 bytes", (4, 3, 147, 4096), 1),
                ("T*N = 75000 planes", (300, 250, 3, 20), 0),
                ("T*N = 75000 planes", (300, 250, 3, 128), 0),
                ("wide F, 4-vector rows", (2, 3, 400, 1008), 0),
                ("wide F, 1-vector rows, 49.6 KB chunk",
                 (2, 2, 3100, 80), 0)):
            cases.append((what, rand(shape, dtype, offset)))
    for what, x in cases:
        y = T.transpose_traj(x)
        y2 = T.transpose_traj(x)
        sync()
        if not torch.equal(y, T.transpose_traj_plain(x)):
            raise AssertionError(f"K4 differs from its plain version: {what} "
                                 f"{tuple(x.shape)} {x.dtype}")
        if not torch.equal(y, y2):
            raise AssertionError(f"K4's two launches differ: {what}")
        plan = T.traj_plan(x.shape[2], x.shape[3], x.element_size())
        print(f"[K4] {what} {tuple(x.shape)} {x.dtype} (data_ptr % 16 = "
              f"{x.data_ptr() % 16}, {plan['cols']} columns a tile, "
              f"{plan['smem']} B chunk): bit-exact, two launches bit-equal")
    k = _k4_time(traj_obs, "the encode trajectory's shape", card)
    k["hetero_5x5"] = _k4_time(rand((64, 2, 75, 4096), torch.uint8),
                               "a hetero 5x5 group's trajectory", card)
    k["int32"] = _k4_time(rand(tuple(traj_obs.shape), torch.int32),
                          "the encode trajectory's shape in int32", card)
    k["probe_launches"] = T.transpose_traj.launches - n0
    print(f"[K4] {k['probe_launches']} probe launches [{card}]")
    return k


def _print_split(out, where, vocab, ms, card):
    """Print and keep (``out['split <vocab> <where>']``) K6's split of
    K2f's kernel: 'full' beside 'build' + 'gemm', device ms by mode."""
    out[f"split {vocab} {where}"] = ms
    print(f"[time] K6 split at the {where} ({vocab}): full "
          f"{ms['full'] * 1e3:.2f} us; build {ms['build'] * 1e3:.2f} + gemm "
          f"{ms['gemm'] * 1e3:.2f} = "
          f"{(ms['build'] + ms['gemm']) * 1e3:.2f} us [{card}]")


def phase_embed_roofline(roll, tim, palettes, card, seed):
    """K6 (the embed-roofline probe, ``probes/embed_roofline.py``: K2f's
    tensor-core kernel whole or one half alone), each mode against its
    plain version on the card: at K2f's rollout shape (R = 4, F = 147, S =
    4096, H = 128) and update shape (R = 2048, S = 128), with the full
    vocabularies and the goal_cycle palette, and at a hetero 5x5 group's
    two shapes (25 cells, full vocabulary), on codes across and beyond
    both vocabularies ('build' exact; 'full' and 'gemm' within 1e-5 of max
    |out|: float32 sums in another order). Then each mode's device time at
    both shapes with the train path's codes and table (palette), beside
    K2f's time of the same run, its bound, its plain version's and, where
    one PyTorch call computes the same function, that call's:
    ``embedding_bag(sum)`` for 'full'; for 'gemm' ``torch.mm`` of the
    broadcast first code row (materialized beforehand) by the (cells * cw,
    H) table, the TPU probe's dense product; none for 'build'. The same
    codes with a full-vocabulary table (random, bf16) give the split of
    the kernel's time with the full vocabulary ('full', 'build', 'gemm'
    only).

    Bounds, of the work each mode does: 'full' as K5f's (the least over
    the routes: its bytes, codes, the bf16 table and the float32 output
    once, or the lesser of its float32 adds and the dense bf16 product);
    'build' one add per (feature, sample) and the codes and float32 output
    once; 'gemm' computes x[r, 0, s] * colsum(W)[h]: the table's column
    sums and one multiply per output at the float32 rate, or its bytes
    (the first code row, the table, the float32 output once) if longer.
    The kernel must not take that column-sum route (it probes the mma
    side), so 'gemm' also reports ``mma_bound_ms``, the roofline of the
    dense product it does instead: 2 * R * S * cells * cw * H operations
    at the bf16 tensor-core rate (uint8 codes are exact in bf16, the
    products exact in float32), or the same bytes if longer."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.parallel import ppo
    from marlgrid_tpu_torch.probes import embed_roofline as P

    gen = torch.Generator().manual_seed(seed + 6)
    H = 128
    n0 = P.fwd_variant.launches
    worst = dict.fromkeys(P.MODES, 0.0)
    for R, cells, S, name, pal in (
            (4, 49, 4096, "full", None),
            (4, 49, 4096, "goal_cycle palette", palettes),
            (2048, 49, 128, "full", None),
            (2048, 49, 128, "goal_cycle palette", palettes),
            (*HETERO_ROLLOUT, "full", None), (*HETERO_UPDATE, "full", None)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        w = (torch.randn(cells, sum(widths), H, generator=gen) * 0.05).to(
            torch.bfloat16).cuda()
        errs = []
        for mode in P.MODES:
            out = P.fwd_variant(x, w, widths, values, mode)
            sync()
            ref = P.fwd_variant_plain(x, w, widths, values, mode)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            ok = err == 0 if mode == "build" else err <= 1e-5 * scale
            if out.shape != (R, S, H) or out.dtype != torch.float32 \
                    or not ok:
                raise AssertionError(
                    f"K6 {mode} ({name}, R={R}, F={3 * cells}, S={S}): max "
                    f"abs err {err} of max |out| {scale}, or "
                    f"{tuple(out.shape)} {out.dtype}")
            worst[mode] = max(worst[mode], err)
            errs.append(f"{mode} {err:.3e} of {scale:.3e}")
            del out, ref
        print(f"[K6] {name} (R={R}, F={3 * cells}, S={S}, H={H}): max "
              f"abs err {', '.join(errs)} (build exact, full and gemm "
              f"within 1e-5 of max |out|)")

    emb = roll["net"].torso0
    table = emb.table().detach().to(torch.bfloat16).contiguous()
    widths, values = emb.widths, emb.values
    cells, cw = table.shape[:2]
    cfg = roll["cfg"]
    blocks = ppo.obs_blocks(roll["traj_obs"], ppo.block_size(
        cfg.n_envs, cfg.rollout_len, roll["ep"].n_agents))
    pick = torch.randperm(blocks.shape[0],
                          generator=torch.Generator().manual_seed(seed))
    update_codes = blocks[pick[:blocks.shape[0] // cfg.n_minibatches]
                          .cuda()].contiguous()
    full_table = (torch.randn(cells, sum(E.WIDTHS), H, generator=gen) *
                  0.05).to(torch.bfloat16).cuda()
    out = {}
    for where, codes, k2f in (
            ("rollout's shape", roll["obs"], tim["onehot_embed_fwd"]),
            ("update's shape", update_codes,
             tim["onehot_embed_fwd_update"])):
        R, Fd, S = codes.shape
        n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
        bag_w = torch.cat([table.reshape(cells * cw, H),
                           torch.zeros(1, H, dtype=table.dtype,
                                       device="cuda")])
        x0 = codes[:, 0, :].reshape(R * S, 1).to(torch.bfloat16).expand(
            R * S, cells * cw).contiguous()
        w2 = table.reshape(cells * cw, H)
        library = dict(full=lambda: F.embedding_bag(bag_idx, bag_w,
                                                    mode="sum"),
                       build=None, gemm=lambda: torch.mm(x0, w2))
        dense = 2 * R * S * cells * cw * H
        shape = dict(
            full=_least_route(dict(bytes=codes.numel() + table.numel() * 2
                                   + R * S * H * 4), n_valid * H, dense),
            build=dict(bytes=codes.numel() + R * S * H * 4, ops=R * Fd * S),
            gemm=dict(bytes=R * S + table.numel() * 2 + R * S * H * 4,
                      ops=R * S * H + cells * cw * H))
        shape["gemm"]["mma_bound_ms"] = max(
            shape["gemm"]["bytes"] / HBM_BYTES_PER_S,
            dense / BF16_OPS_PER_S) * 1e3
        for mode in P.MODES:
            k = shape[mode]
            with torch.no_grad():
                k["ms"], k["host_ms"] = time_ms(
                    lambda: P.fwd_variant(codes, table, widths, values,
                                          mode), iters=20)
                k["plain_ms"], _ = time_ms(
                    lambda: P.fwd_variant_plain(codes, table, widths, values,
                                                mode), iters=5, warmup=1)
                k["library_ms"] = (None if library[mode] is None else
                                   time_ms(library[mode], iters=20)[0])
            k["max_abs_err"] = worst[mode]
            _bound(k)
            k["k2f_ms"] = k2f["ms"]
            out[f"{mode} {where}"] = k
            lib = ("none" if k["library_ms"] is None
                   else f"{k['library_ms'] * 1e3:.2f} us")
            dense_s = ("" if mode != "gemm" else f"; the dense product's "
                       f"roofline {k['mma_bound_ms'] * 1e3:.2f} us")
            print(f"[time] K6 {mode} at the {where} (R={R}, F={Fd}, S={S}, "
                  f"H={H}, palette): {k['ms'] * 1e3:.2f} us (K2f "
                  f"{k2f['ms'] * 1e3:.2f} us in this run), plain "
                  f"{k['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                  f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}){dense_s} "
                  f"[{card}]")
        del x0, bag_idx, bag_w
        _print_split(out, where, "palette", {
            m: out[f"{m} {where}"]["ms"] for m in P.MODES}, card)
        with torch.no_grad():
            _print_split(out, where, "full vocabulary", {
                m: time_ms(lambda: P.fwd_variant(codes, full_table, E.WIDTHS,
                                                 None, m), iters=20)[0]
                for m in P.MODES}, card)
    out["probe_launches"] = P.fwd_variant.launches - n0
    print(f"[K6] {out['probe_launches']} probe launches")
    return out


def hetero_counts(ep, cfg, plane_major):
    """The kernel launches of one hetero train step, counted from the code:
    every render of the rollout (T + 1 of them) launches K1 once per group
    and K3 once per pixel group; every policy call (T + 1) the embed's
    forward (K2f, or K5f on the plane-major route) once per encode group;
    every minibatch the embed's forward and backward (K2b, K5b) once per
    encode group and, for the re-render, K1 and K3 once per pixel group."""
    from marlgrid_tpu_torch.vector import obs_groups

    groups = obs_groups(ep)
    n_pix = sum(gp.observation_style != "encode" for _, gp in groups)
    n_enc = len(groups) - n_pix
    T1, n_up = cfg.rollout_len + 1, cfg.n_epochs * cfg.n_minibatches
    fwd, bwd = (("onehot_embed2_fwd", "onehot_embed2_bwd") if plane_major
                else ("onehot_embed_fwd", "onehot_embed_bwd"))
    return want_counts(transpose_bk=T1 * len(groups) + n_up * n_pix,
                       compose_image_b=(T1 + n_up) * n_pix,
                       **{fwd: (T1 + n_up) * n_enc, bwd: n_up * n_enc})


def capture_embeds(nets):
    """Forward hooks on each encode group's embed (``torso0``) that keep,
    from the calls that follow, the codes and tables of its first call
    without a gradient (the rollout's) and of its first call with one (the
    update's), with the gradient that reaches that call's output: per
    group index, {'rollout': (x, tables), 'update': (x, tables, [dout])}.
    Returns (captured, hook handles)."""
    captured, handles = {}, []
    for g, net in enumerate(nets):
        if net.kind != "mlp":
            continue
        got = captured.setdefault(g, {})

        def hook(mod, inputs, out, got=got):
            where = "update" if out.requires_grad else "rollout"
            if where in got:
                return
            x = inputs[0].reshape((-1,) + tuple(inputs[0].shape[-2:]))
            got[where] = (x.detach().clone(),
                          [t.detach().clone() for t in mod.tables()], [])
            if out.requires_grad:
                out.register_hook(
                    lambda d: got["update"][2].append(d.detach().clone()))

        handles.append(net.torso0.register_forward_hook(hook))
    return captured, handles


def hold_embeds(nets, captured, name):
    """Each embed kernel of a hetero step against its plain version on the
    inputs :func:`capture_embeds` kept from a real step: the forward (K2f,
    or K5f on the plane-major route) on the rollout's and the update's
    codes and tables, the backward (K2b, K5b) on the update's codes and
    the bf16 gradient of that call's output, with the bounds of the embed
    phases. Returns {kernel name: max |err|}."""
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    worst = {}
    for g, got in captured.items():
        emb = nets[g].torso0
        widths, values = emb.widths, emb.values
        if set(got) != {"rollout", "update"} or len(got["update"][2]) != 1:
            raise AssertionError(f"{name} group {g}: the embed's rollout and "
                                 f"update calls were not both seen")
        for where in ("rollout", "update"):
            x, tables = got[where][:2]
            what = (f"{name} group {g} {where} (R={x.shape[0]}, "
                    f"F={x.shape[1]}, S={x.shape[2]}, real codes)")
            with torch.no_grad():
                if emb.plane_major:
                    out = E2.onehot_embed2(x, *tables, widths, values)
                    err = _hold_k5f(out, E2.onehot_embed2_plain(
                        x, *tables, widths, values), what)
                    kname = "onehot_embed2_fwd"
                else:
                    w = E.pack_weights(*tables).to(torch.bfloat16)
                    out = E.onehot_embed(x, w, widths, values)
                    err = _hold_k2f(out, E.onehot_embed_plain(
                        x, w.float(), widths, values, torch.float32).to(
                            torch.bfloat16), what)
                    kname = "onehot_embed_fwd"
            worst[kname] = max(worst.get(kname, 0.0), err)
        x, _, (dout,) = got["update"]
        dout = dout.to(torch.bfloat16).reshape(
            x.shape[0], x.shape[2], -1).contiguous()
        what = (f"{name} group {g} update (R={x.shape[0]}, F={x.shape[1]}, "
                f"S={x.shape[2]}, real codes and dout)")
        if emb.plane_major:
            kname, (_, err) = "onehot_embed2_bwd", _hold_k5b(
                x, dout, widths, values, what)
        else:
            kname, (_, err) = "onehot_embed_bwd", _hold_k2b(
                x, dout, widths, values, what)
        worst[kname] = max(worst.get(kname, 0.0), err)
    return worst


def phase_hetero(seed, card, name, steps=2):
    """A hetero train path at full width (``HETERO_PATHS[name]``'s CLI
    config: goal_cycle 13x13, B = 4096, hidden 128, 2 epochs x 4
    minibatches, no palettes; T = 64, or 32 for the mixed population):
    ``steps`` train steps through the CLI's own trainer selection, the
    launch counts read around each (:func:`hetero_counts`), each step's
    metrics, the peak device memory and train env-steps/s. The first
    step's embed inputs are kept (:func:`capture_embeds`) and each embed
    kernel is held against its plain version on them after the steps."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo
    from marlgrid_tpu_torch.parallel import train as train_mod

    flags, plane_major = HETERO_PATHS[name]
    ep, cfg = cli_config(*flags)
    B, T = cfg.n_envs, cfg.rollout_len
    dev = torch.device("cuda")
    with embed_v2(plane_major):
        net, opt, h = train_mod.init(ep, cfg,
                                     torch.Generator().manual_seed(seed), dev)
    kinds = [n.kind for n in net]
    if plane_major and not all(n.torso0.plane_major for n in net):
        raise AssertionError(f"{name}: the plane-major embed is not on")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    # the eager step (jit=False): the profile phase and chip_pair.py read
    # its stages
    step = train_mod.make_step(ep, cfg, net, opt, dev, jit=False)
    want = hetero_counts(ep, cfg, plane_major)
    w0 = [p.detach().clone() for p in net.parameters()]
    secs, metrics = [], []
    captured, hooks = capture_embeds(net)
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        sync()
        zero_counts()
        t0 = time.perf_counter()
        if h is None:
            env, key, m = step(env, key)
        else:
            env, h, key, m = step(env, h, key)
        sync()
        secs.append(time.perf_counter() - t0)
        for hook in hooks:
            hook.remove()
        hooks = []
        got = read_counts()
        if got != want:
            raise AssertionError(f"{name} train step {i}: launches {got}, "
                                 f"want {want}")
        m = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(v) for v in m.values())
                and m["entropy"] > 0 and m["n_episodes"] > 0):
            raise AssertionError(f"{name} train step {i}: metrics {m}")
        if h is not None and not all(bool(torch.isfinite(x).all())
                                     for x in h.values()):
            raise AssertionError(f"{name} train step {i}: carry not finite")
        metrics.append(m)
        print(f"[{name}] train step {i}: {secs[-1]:.3f} s, loss "
              f"{m['loss']:.5f}, entropy {m['entropy']:.4f}, ratio_dev "
              f"{m['ratio_dev']:.4f}, {m['n_episodes']:.0f} episodes, mean "
              f"episode return {m['episode_return']:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if all(torch.equal(p, q) for p, q in zip(net.parameters(), w0)):
        raise AssertionError(f"the {name} train steps changed no weight")
    errs = hold_embeds(net, captured, name)
    # the 5x5 group's update inputs, for the forward's timing phase
    embed_5x5 = next(((*got["update"][:2], net[g].torso0.widths,
                       net[g].torso0.values) for g, got in captured.items()
                      if got["update"][0].shape[1] == 3 * 25), None)
    del captured
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"[{name}] launches per train step: {got} (want {want})")
    print(f"[{name}] {' '.join(flags)}: groups {kinds}, B={B} T={T}: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s; "
          f"peak device memory {peak_gb:.2f} GB [{card}]")
    return dict(counts=got, seconds=secs, metrics=metrics, peak_gb=peak_gb,
                env_steps_per_s=B * T / steady, step=step, env=env, h=h,
                key=key, embed_errs=errs, embed_5x5=embed_5x5, ep=ep,
                cfg=cfg, net=net, opt=opt)


#: the graphs phase's paths: (train CLI flags, plane-major embed, B). The
#: three largest host shares and the encode row store ('cnn') at full
#: width; image, the mixed population and --overlap at B = 1024 (an eager
#: step's host time does not depend on B). Depth: T = 32 (the CLI's is
#: 64); the gspmd phase's encode and rnn mesh steps, at the same T, stand
#: beside the profiled replays of encode and rnn
GRAPH_PATHS = {
    "encode": (("--rollout", "32"), False, 4096),
    "cnn": (ROW_PATHS["cnn"][0] + ("--rollout", "32"), False, 4096),
    "rnn": (("--rnn", "gru", "--rollout", "32"), True, 4096),
    "hetero-rnn": (HETERO_PATHS["hetero-rnn"][0] + ("--rollout", "32"), True,
                   4096),
    "image": (("--obs", "image", "--rollout", "32"), False, 1024),
    "hetero-mixed": (HETERO_PATHS["hetero-mixed"][0], False, 1024),
    "overlap": (("--overlap", "--rollout", "32"), False, 1024),
}


#: the sharded default path's steps (:func:`phase_gspmd`): the encode and
#: recurrent graphs paths, and the three hetero populations at full width
#: with T = 16 (depth)
GSPMD_PATHS = {
    "encode": GRAPH_PATHS["encode"],
    "rnn": GRAPH_PATHS["rnn"],
    **{name: (flags + ("--rollout", "16"), plane_major, 4096)
       for name, (flags, plane_major) in HETERO_PATHS.items()},
    # the tensor-parallel feedforward step (the 'model' axis), at the
    # encode mesh= step's depth
    "tp encode": GRAPH_PATHS["encode"],
}


def _clone_tree(tree):
    from marlgrid_tpu_torch.parallel import graph

    leaves, spec = graph.flatten(tree)
    return graph.unflatten(spec, [x.clone() for x in leaves])


def _max_diff(xs, ys):
    """max |x - y| over paired tensors (inf if a shape differs; NaN if a
    value is NaN, which fails every bar)."""
    d = 0.0
    for x, y in zip(xs, ys, strict=True):
        if x.shape != y.shape:
            return math.inf
        if x.numel():
            d = max(d, float((x.double() - y.double()).abs().max()))
    return d


def phase_graphs(seed, card, name, n=2, envs=None, profile=True, mesh=None,
                 T=None):
    """One path's train step graphed against its eager step, from one start
    (``GRAPH_PATHS[name]``'s CLI config at B = ``envs`` or the path's own,
    at T = ``T`` or the path's own;
    with a ``mesh``, the ``--shard-map`` step over it, whose env batch is
    this rank's slice, and the ``all_reduce`` calls of an eager step and of
    the capture counted):
    the weights, Adam's state and the carry (env state, key; ``h``, or the
    overlap step's priming rollout) copied before, and restored for every
    run. Runs: eager ``n`` steps (``jit=False``), the second step under
    ``torch.cuda.set_sync_debug_mode('error')`` (a host sync in the step
    raises); ``jit=True`` ``n`` calls (eager, then the capture) and two more
    replays for its rate; ``ppo.multi_step`` (``multi_step_rnn``,
    ``multi_step_overlap``) of the raw step with k = 2, ``n // 2`` calls and
    one more for its rate. Every call's launch
    counts equal
    :func:`hetero_counts` times its steps. Bar: after the ``n`` steps each
    graphed run's env state, key, weights, Adam's moments and step counts,
    the rest of its carry and the last step's metrics are bit-equal to the
    eager run's.
    Prints train env-steps/s of each run (median of its steps after the
    first; a multi-step call's time over its 2 steps), the capture's
    seconds, peak device memory (and the allocation's rise above the run's
    start, what the run itself holds) and, with ``profile``, the device
    busy and
    idle time of one profiled replay."""
    import copy

    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import graph, ppo, ppo_rnn
    from marlgrid_tpu_torch.parallel import train as train_mod

    flags, plane_major, B = GRAPH_PATHS[name]
    B = envs or B
    if T:
        flags = flags + ("--rollout", str(T))
    ep, cfg = cli_config(*flags, "--envs", str(B))
    T = cfg.rollout_len
    dev = torch.device("cuda")
    overlap = "--overlap" in flags
    with embed_v2(plane_major):
        net, opt, h = train_mod.init(ep, cfg,
                                     torch.Generator().manual_seed(seed), dev)
    key = rng.PRNGKey(seed, device=dev)
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device=dev, mesh=mesh)
    h = train_mod.local_carry(mesh, h)
    key = rng.fold_in(key, 2)
    label = name + (f" --shard-map (D={mesh.D})" if mesh else "")
    if overlap:
        _, prime = ppo.make_train_step(ep, cfg, net, opt, device=dev,
                                       overlap=True, jit=False)
        carry0 = prime(env, key)
    else:
        carry0 = (env, key) if h is None else (env, h, key)
    carry0 = _clone_tree(carry0)
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    o0 = copy.deepcopy(opt.state_dict())
    per_step = path_counts(ep, cfg, plane_major)

    def make(jit):
        if overlap:
            return ppo.make_train_step(ep, cfg, net, opt, device=dev,
                                       overlap=True, jit=jit)[0]
        return train_mod.make_step(ep, cfg, net, opt, dev, jit=jit,
                                   **({} if mesh is None else {"axis": mesh}))

    collectives = {}

    def run(mode, sync_check=False):
        net.load_state_dict(w0)
        opt.load_state_dict(copy.deepcopy(o0))
        carry = _clone_tree(carry0)
        k = 1
        if mode == "eager":
            step = make(False)
        elif mode == "graphed":
            step = make(True)
        else:
            k = 2
            wrap = ppo_rnn.multi_step_rnn if h is not None else (
                ppo.multi_step_overlap if overlap else ppo.multi_step)
            step = wrap(make(False), k)
        want = {kn: k * v for kn, v in per_step.items()}
        secs = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 1e9
        for i in range(n // k):
            sync()
            zero_counts()
            debug = sync_check and i == 1
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            ar = mesh.all_reduces if mesh else 0
            t0 = time.perf_counter()
            try:
                *carry, m = step(*carry)
            finally:
                if debug:
                    torch.cuda.set_sync_debug_mode("default")
            sync()
            secs.append((time.perf_counter() - t0) / k)
            if mesh:
                collectives[f"{mode} call {i}"] = mesh.all_reduces - ar
            got = read_counts()
            if got != want:
                raise AssertionError(f"graphs {label} {mode} call {i}: "
                                     f"launches {got}, want {want}")
        peak = (torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.max_memory_reserved() / 1e9)
        # the returned carry is donated: clone what is compared
        leaves = [x.clone() for x in graph.flatten(tuple(carry))[0]]
        n_env = len(graph.flatten(carry[0])[0])
        gs = step.step if mode == "multi" else step
        out = dict(
            env_key=leaves[:n_env] + leaves[-1:], carry=leaves[n_env:-1],
            weights=[v.clone() for v in net.state_dict().values()],
            moments=[t.clone() for st in opt.state.values()
                     for t in (st["exp_avg"], st["exp_avg_sq"], st["step"])],
            metrics={kn: float(v) for kn, v in m.items()},
            secs=secs, peak_gb=peak, rise_gb=peak[0] - start, profile=None,
            capture_s=getattr(gs, "capture_s", None))
        # a graphed run's rate: replays after the compared calls
        for _ in range({"graphed": 2, "multi": 1}.get(mode, 0)):
            sync()
            zero_counts()
            ar = mesh.all_reduces if mesh else 0
            t0 = time.perf_counter()
            *carry, m = step(*carry)
            sync()
            secs.append((time.perf_counter() - t0) / k)
            if read_counts() != want:
                raise AssertionError(f"graphs {label} {mode} replay: "
                                     f"launches {read_counts()}")
            if mesh and mesh.all_reduces != ar:
                raise AssertionError(f"graphs {label}: a replay called "
                                     f"all_reduce from the host")
        if profile and mode == "graphed":
            out["profile"] = profile_stages(
                lambda: step(*carry), ("rollout.", "update."), card,
                f"graphs {label}: one graphed step (a replay; B={B}, "
                f"T={T})")
        del step, gs, carry, m
        torch.cuda.empty_cache()
        return out

    runs = {"eager": run("eager", sync_check=True),
            "graphed": run("graphed"), "multi": run("multi")}

    def dist(a, b):
        return dict(
            weights=_max_diff(a["weights"], b["weights"]),
            moments=_max_diff(a["moments"], b["moments"]),
            carry=_max_diff(a["carry"], b["carry"]),
            metrics=max(abs(a["metrics"][kn] - b["metrics"][kn])
                        for kn in a["metrics"]))

    e1 = runs["eager"]
    report = dict(B=B, T=T)
    for mode in list(runs)[1:]:
        g = runs[mode]
        if not all(torch.equal(x, y) for x, y in zip(
                g["env_key"], e1["env_key"], strict=True)):
            raise AssertionError(f"graphs {label} {mode}: the env state or "
                                 f"key differs from the eager run's")
        d1 = dist(g, e1)
        for what, d in d1.items():
            if d != 0:
                raise AssertionError(f"graphs {label} {mode}: {what} "
                                     f"{d:.3e} from the eager run's")
        report[mode] = dict(vs_eager=d1)
    rates = {}
    for mode, r in runs.items():
        steady = sorted(r["secs"][1:])[len(r["secs"][1:]) // 2]
        rates[mode] = B * T / steady
        report[mode] = dict(report.get(mode, {}), seconds=r["secs"],
                            env_steps_per_s=rates[mode], peak_gb=r["peak_gb"],
                            rise_gb=r["rise_gb"],
                            capture_s=r["capture_s"], profile=r["profile"])
    if mesh:
        # the eager step's all_reduce calls, and those the capture recorded
        # (the graphed run's call 1): one graph node each
        report["all_reduces"] = collectives
        per = collectives["eager call 0"]
        if collectives["graphed call 1"] != per or per == 0:
            raise AssertionError(f"graphs {label}: all_reduce calls "
                                 f"{collectives}")
        print(f"[graphs] {label}: {per} all_reduce calls per eager step, "
              f"{collectives['graphed call 1']} captured into the graph "
              f"(one node each), none from the host on a replay [{card}]")
    print(f"[graphs] {label} ({' '.join(flags) or 'defaults'}, B={B}, T={T}): "
          f"launches per step {per_step}, equal on every eager, captured "
          f"and replayed step; no host sync in an eager step; after {n} "
          f"steps the env state, key, weights, Adam's state, carry and "
          f"metrics of jit=True and multi_step(k=2) bit-equal to the eager "
          f"run's")
    print(f"[graphs] {label}: train env-steps/s eager "
          f"{rates['eager']:,.0f}, graphed "
          f"{rates['graphed']:,.0f}, multi_step(k=2) {rates['multi']:,.0f} "
          f"({rates['graphed'] / rates['eager']:.2f}x eager); step "
          f"seconds eager {', '.join(f'{t:.3f}' for t in e1['secs'])}, "
          f"graphed "
          f"{', '.join(f'{t:.3f}' for t in runs['graphed']['secs'])}; "
          f"capture {runs['graphed']['capture_s']} s (multi_step "
          f"{runs['multi']['capture_s']} s); peak device memory "
          f"allocated / reserved eager {e1['peak_gb'][0]:.2f} / "
          f"{e1['peak_gb'][1]:.2f} GB, graphed "
          f"{runs['graphed']['peak_gb'][0]:.2f} / "
          f"{runs['graphed']['peak_gb'][1]:.2f} GB (allocated "
          f"{runs['graphed']['rise_gb']:.3f} GB above the run's start) "
          f"[{card}]")
    del net, opt, h, carry0, w0, o0, runs
    torch.cuda.empty_cache()
    return report


def phase_shard_map(seed, card):
    """The ``--shard-map`` steps in one process on an NCCL group of world
    size 1 (a ``file://`` store in a temporary directory; the group is
    destroyed at the end): ``phase_graphs``' runs of the feedforward and
    the recurrent (GRU, plane-major embed) step over its mesh, at full
    width: every collective runs on NCCL, and the graphed step captures
    them. At T = 16 (depth; the paths' own is 64), no profiled replay.
    Bars as ``phase_graphs``': launches per step equal to the unsharded
    step's, the graphed and ``multi_step`` (k = 2) runs bit-equal to the
    eager steps, every ``all_reduce`` captured. Then, on the same group,
    :func:`phase_gspmd` of both paths (the sharded default path, ``"gspmd
    encode"`` and ``"gspmd rnn"``) and of the three hetero populations at
    T = 16, each beside its own unsharded graphed step (``multi_step`` on
    the all-encode one)."""
    import torch.distributed as dist

    from marlgrid_tpu_torch.parallel import mesh as mesh_mod

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = mesh_mod.make_mesh(device="cuda")
            for name in ("encode", "rnn"):
                out[name] = phase_graphs(seed, card, name, profile=False,
                                         mesh=mesh, T=16)
            for name in ("encode", "rnn"):
                out[f"gspmd {name}"] = phase_gspmd(seed, card, name, mesh)
            for name in HETERO_PATHS:
                out[f"gspmd {name}"] = phase_gspmd(
                    seed, card, name, mesh, multi=name == "hetero",
                    own_baseline=True)
            out["tp encode"] = phase_gspmd(seed, card, "tp encode", mesh,
                                           multi=False, tp=True)
            out["tp eager"] = phase_tp_eager(seed, card, mesh)
            out["graft"] = phase_graft(card)
        finally:
            dist.destroy_process_group()
    return out


def phase_tp_eager(seed, card, mesh, T=16):
    """One eager step each, from one start, of the unsharded step, the
    plain ``mesh=`` step and the tensor-parallel ``mesh=`` step (the
    encode path at B = 4096, T = 16) on the NCCL group's mesh: the
    tensor-parallel step bit-equal to the plain ``mesh=`` step (weights,
    first gradients, env state, key, loss: at n_model = 1 it runs the same
    operations). Reported beside it, not held to a bound: each one's
    distance to the unsharded step, whose reductions differ in order
    (``ppo.Share``), and the largest first gradient among the weights
    beyond rtol 2e-4, atol 2e-5 (Adam moves a weight of a small gradient
    by up to lr whatever its size)."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import graph, ppo, tensor_parallel
    from marlgrid_tpu_torch.parallel import train as train_mod

    ep, cfg = cli_config("--rollout", str(T), "--envs", "4096")
    dev = torch.device("cuda")
    runs = {}
    for kind in ("unsharded", "mesh=", "tensor-parallel"):
        gen = torch.Generator().manual_seed(seed)
        if kind == "tensor-parallel":
            net = tensor_parallel.TensorParallelActorCritic(
                cfg, ep.view_size, mesh, gen, device=dev)
            opt = ppo.make_optimizer(net, cfg)
        else:
            net, opt, _ = train_mod.init(ep, cfg, gen, dev)
        first = {}
        _record_first_grads(net, opt, first)
        key = rng.PRNGKey(seed, device=dev)
        env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                                 stagger=True, device=dev, mesh=mesh)
        step = ppo.make_train_step(ep, cfg, net, opt, device=dev, jit=False,
                                   **({} if kind == "unsharded"
                                      else dict(mesh=mesh)))
        env, key, m = step(env, rng.fold_in(key, 2))
        sync()
        runs[kind] = dict(
            w={k: v.clone() for k, v in net.state_dict().items()},
            g=first, env_key=graph.flatten(env)[0] + [key],
            loss=float(m["loss"]))
        del net, opt, step
    tp, plain = runs["tensor-parallel"], runs["mesh="]
    if not (all(torch.equal(a, b) for a, b in zip(
            tp["env_key"], plain["env_key"], strict=True))
            and _max_diff(list(tp["w"].values()), list(plain["w"].values()))
            == 0 and _max_diff(list(tp["g"].values()),
                               list(plain["g"].values())) == 0
            and tp["loss"] == plain["loss"]):
        raise AssertionError("tp eager: the tensor-parallel step at "
                             "n_model = 1 differs from the plain mesh= step")
    out = {}
    base = runs["unsharded"]
    for kind in ("mesh=", "tensor-parallel"):
        r, worst, n_off, g_off = runs[kind], 0.0, 0, 0.0
        for k, y in base["w"].items():
            x, y = r["w"][k].double(), y.double()
            off = ~torch.isclose(x, y, rtol=2e-4, atol=2e-5)
            n_off += int(off.sum())
            worst = max(worst, float((x - y).abs().max()))
            if off.any():
                g_off = max(g_off,
                            float(base["g"][k][off.cpu()].abs().max()))
        g_diff = _max_diff(list(r["g"].values()), list(base["g"].values()))
        env_equal = all(torch.equal(a, b) for a, b in zip(
            r["env_key"], base["env_key"], strict=True))
        out[kind] = dict(max_weight_diff=worst, n_off=n_off,
                         max_grad_diff=g_diff, off_max_grad=g_off,
                         env_key_equal=env_equal)
        print(f"[tp] {kind} eager step (B=4096, T={T}) against the "
              f"unsharded one from one start: env state and key "
              f"{'bit-equal' if env_equal else 'DIFFER'}, first gradients "
              f"max |diff| {g_diff:.3e}, weights max |diff| {worst:.3e}, "
              f"{n_off} beyond rtol 2e-4, atol 2e-5 (reported, not held; "
              f"their first gradients at most {g_off:.3e} in magnitude) "
              f"[{card}]")
    print(f"[tp] tensor-parallel eager step (n_model = 1) against the plain "
          f"mesh= step from one start: weights, first gradients, env state, "
          f"key and loss bit-equal [{card}]")
    return out


def phase_graft(card):
    """The entry points of ``__graft_entry_torch__.py`` on the card:
    ``entry()``'s forward (one K2f launch) on its zeros and on random valid
    codes against ``entry("cpu")``'s, the same weights, within the bf16
    forward's 1e-2; then ``dryrun_multichip(1)`` in this rank of the NCCL
    group of world size 1 (a 1 x 1 mesh: every family's step on it, the
    feedforward one through the tensor-parallel policy): seven finite
    losses."""
    import __graft_entry_torch__ as graft

    fn, (params, obs) = graft.entry()
    cpu_fn, (cpu_params, cpu_obs) = graft.entry("cpu")
    for k, v in params.items():
        if not torch.equal(v.cpu(), cpu_params[k]):
            raise AssertionError(f"entry(): weight {k} differs card vs CPU")
    gen = torch.Generator().manual_seed(5)
    codes = torch.stack([torch.randint(0, hi, tuple(obs.shape[:-1]),
                                       generator=gen, dtype=torch.int32)
                         for hi in (12, 10, 25)], -1)
    worst = 0.0
    with torch.no_grad():
        for x in (cpu_obs, codes):
            zero_counts()
            logits, value = fn(params, x.cuda())
            sync()
            if read_counts() != want_counts(onehot_embed_fwd=1):
                raise AssertionError(f"entry(): launches {read_counts()}")
            want_l, want_v = cpu_fn(cpu_params, x)
            if logits.shape != (32, 4, 7) or value.shape != (32, 4) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"entry(): logits {logits.shape}, "
                                     f"value {value.shape}")
            for got, want in ((logits, want_l), (value, want_v)):
                worst = max(worst, float((got.cpu() - want).abs().max()))
                if not torch.allclose(got.cpu(), want, rtol=1e-2, atol=1e-2):
                    raise AssertionError(f"entry(): card vs CPU max |diff| "
                                         f"{worst:.3e}")
    t0 = time.perf_counter()
    losses = graft.dryrun_multichip(1)
    secs = time.perf_counter() - t0
    if len(losses) != 7 or not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"dryrun_multichip(1): {losses}")
    print(f"[graft] entry(): logits (32, 4, 7) and values on its zeros and "
          f"on random codes, card vs CPU max |diff| {worst:.3e} (bound "
          f"1e-2), 1 K2f launch a forward; dryrun_multichip(1) on one NCCL "
          f"rank in {secs:.2f} s: losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
          + f" [{card}]")
    return dict(entry_max_diff=worst, dryrun_losses=losses,
                dryrun_s=secs)


def phase_gspmd(seed, card, name, mesh, multi=True, own_baseline=False,
                tp=False):
    """The sharded default path's step (``ppo.make_train_step(mesh=...)``,
    ``ppo_rnn.make_train_step_rnn(mesh=...)``, the hetero trainers'
    ``make_train_step_hetero*(mesh=...)``; the JAX CLI's training step
    without ``--shard-map``) of ``GSPMD_PATHS[name]`` at full width over
    ``mesh`` (one NCCL rank), graphed, beside the unsharded step from the
    same start. Runs: the unsharded step's eager call (with
    ``own_baseline``, the first call of its graphed step, then from the
    start its capture and replay, and one profiled replay: the unsharded
    graphed step's busy time and memory rise, which the encode and GRU
    paths take from the graphs phase instead); the mesh step's eager call
    (its first: the communicator), then, from the same start again (the
    weights copied back and Adam's state zeroed in place, so the capture
    holds their addresses), its capture and replay, two more replays for
    its wall time and one profiled replay; then, with ``multi``, from the
    start two eager steps of the raw mesh step (``jit=False``), and
    ``ppo.multi_step`` (``ppo_rnn.multi_step_rnn``) of it with k = 2, one
    call (an eager step, then the capture of the second) and one more call
    of two replays. Bars: launches per step the unsharded step's
    (:func:`path_counts`); the mesh step's env state and key after one
    step bit-equal to the unsharded step's, eager and graphed (and, with
    ``own_baseline``, the unsharded graphed step's to its eager call's);
    its weights within rtol 2e-4, atol 2e-5 of the unsharded step's, and
    its graphed weights bit-equal to its eager ones; the ``multi_step``
    call's env state, key, carry, weights and metrics bit-equal to the two
    eager steps'; the collectives of the eager call (``all_gather``,
    ``all_reduce``) all captured, by the graphed step and by
    ``multi_step``'s, none called from the host on a replay. Prints busy ms
    and device ops of the profiled replay, the collectives per step, the
    replays' wall and peak memory (and its rise above the allocation at
    the start of the eager call, capture and replays, as ``phase_graphs``
    reports its runs'). ``tp``: the mesh step's net is the tensor-parallel
    policy (``tensor_parallel.TensorParallelActorCritic``, drawn from the
    same generator: at n_model = 1 its shards are the whole weights) in
    ``ppo.make_train_step(mesh=...)``; the model axis's collectives
    (``model_all_gather``, ``model_all_reduce``) are counted and held as
    the data axis's."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import graph, ppo, ppo_rnn
    from marlgrid_tpu_torch.parallel import tensor_parallel
    from marlgrid_tpu_torch.parallel import train as train_mod

    def collectives():
        return (mesh.all_gathers, mesh.all_reduces, mesh.model_all_gathers,
                mesh.model_all_reduces)

    flags, plane_major, B = GSPMD_PATHS[name]
    ep, cfg = cli_config(*flags, "--envs", str(B))
    dev = torch.device("cuda")
    with embed_v2(plane_major):
        net, opt, h = train_mod.init(ep, cfg,
                                     torch.Generator().manual_seed(seed), dev)
    key = rng.PRNGKey(seed, device=dev)
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device=dev, mesh=mesh)
    carry0 = _clone_tree((env, rng.fold_in(key, 2)) if h is None
                         else (env, h, rng.fold_in(key, 2)))
    del env
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    per_step = path_counts(ep, cfg, plane_major)
    label = f"{name} mesh= (D={mesh.D})"

    def restart():
        """The weights back to ``w0`` and Adam's state to zero, in place."""
        with torch.no_grad():
            for k, v in net.state_dict().items():
                v.copy_(w0[k])
        for st in opt.state.values():
            for t in st.values():
                if torch.is_tensor(t):
                    t.zero_()

    def call(step, what, carry=None, steps=1):
        """One call of ``step`` (``steps`` train steps) from the start, or
        from ``carry`` and the weights as they are: its env state and key,
        the rest of its carry, weights, metrics and collectives, cloned."""
        if carry is None:
            restart()
            carry = _clone_tree(carry0)
        sync()
        zero_counts()
        n0 = collectives()
        t0 = time.perf_counter()
        *carry, m = step(*carry)
        sync()
        secs = time.perf_counter() - t0
        want = {k: steps * v for k, v in per_step.items()}
        if read_counts() != want:
            raise AssertionError(f"gspmd {label} {what}: launches "
                                 f"{read_counts()}, want {want}")
        return dict(
            env_key=[x.clone() for x in graph.flatten(carry[0])[0]]
            + [carry[-1].clone()],
            h=[x.clone() for x in graph.flatten(tuple(carry[1:-1]))[0]],
            weights=[v.clone() for v in net.state_dict().values()],
            metrics={k: float(v) for k, v in m.items()}, secs=secs,
            collectives=tuple(b - a for a, b in zip(n0, collectives())),
            carry=carry)

    def replays(step, carry, what):
        """Two replays of a captured ``step`` from ``carry`` (their wall
        seconds), the peak memory since the last reset, and one profiled
        replay."""
        secs = []
        for _ in range(2):
            sync()
            zero_counts()
            n0 = collectives()
            t0 = time.perf_counter()
            *carry, m = step(*carry)
            sync()
            secs.append(time.perf_counter() - t0)
            if read_counts() != per_step or collectives() != n0:
                raise AssertionError(f"gspmd {label} {what} replay: "
                                     f"launches {read_counts()}, or a "
                                     f"collective called from the host")
        peak = (torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.max_memory_reserved() / 1e9)
        prof = profile_stages(lambda: step(*carry), ("rollout.", "update."),
                              card, f"gspmd {label}: one graphed {what} "
                              f"step (a replay; B={B}, "
                              f"T={cfg.rollout_len})")
        return secs, peak, prof

    own = None
    if own_baseline:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 1e9
        # thread_local: the NCCL group's watchdog queries CUDA from its own
        # thread during the capture
        ustep = graph.GraphedStep(
            train_mod.make_step(ep, cfg, net, opt, dev, jit=False),
            f"{name} unsharded", "thread_local")
        base = call(ustep, "unsharded eager")
        del base["carry"]
        ugraph = call(ustep, "unsharded capture")
        if not all(torch.equal(x, y) for x, y in zip(
                ugraph["env_key"], base["env_key"], strict=True)):
            raise AssertionError(f"gspmd {name}: the unsharded graphed "
                                 f"step's env state or key differs from its "
                                 f"eager call's")
        usecs, upeak, uprof = replays(ustep, ugraph.pop("carry"),
                                      "unsharded")
        own = dict(replay_s=usecs, peak_gb=upeak,
                   rise_gb=upeak[0] - start, profile=uprof,
                   capture_s=ustep.capture_s)
        del ustep, ugraph
    else:
        base = call(train_mod.make_step(ep, cfg, net, opt, dev, jit=False),
                    "unsharded eager")
        del base["carry"]
    if tp:
        # the same draws: at n_model = 1 the shards are the whole weights
        net = tensor_parallel.TensorParallelActorCritic(
            cfg, ep.view_size, mesh, torch.Generator().manual_seed(seed),
            device=dev)
        opt = ppo.make_optimizer(net, cfg)
        if _max_diff(list(net.state_dict().values()),
                     list(w0.values())) != 0:
            raise AssertionError(f"tp {name}: the tensor-parallel policy "
                                 f"did not draw the unsharded weights")
        w0 = {k: v.clone() for k, v in net.state_dict().items()}
        label = f"{name} (D={mesh.D}, n_model={mesh.n_model})"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 1e9
    step = (ppo.make_train_step(ep, cfg, net, opt, device=dev, mesh=mesh)
            if tp else
            train_mod.make_step(ep, cfg, net, opt, dev, jit=True, mesh=mesh))
    eager = call(step, "eager")
    del eager["carry"]
    graphed = call(step, "capture")
    secs, peak, prof = replays(step, graphed.pop("carry"), "mesh")
    rise = peak[0] - start
    for run, what in ((eager, "eager"), (graphed, "graphed")):
        if not all(torch.equal(x, y) for x, y in zip(
                run["env_key"], base["env_key"], strict=True)):
            raise AssertionError(f"gspmd {label} {what}: env state or key "
                                 f"differs from the unsharded step's")
        for x, y in zip(run["weights"], base["weights"], strict=True):
            x, y = x.double(), y.double()
            off = ~torch.isclose(x, y, rtol=2e-4, atol=2e-5)
            if off.any():
                raise AssertionError(
                    f"gspmd {label} {what}: {int(off.sum())} of {x.numel()} "
                    f"weights of a {tuple(x.shape)} tensor off the unsharded "
                    f"step's beyond rtol 2e-4, atol 2e-5 (max |diff| "
                    f"{float((x - y).abs().max()):.3e})")
    if _max_diff(graphed["weights"], eager["weights"]) != 0:
        raise AssertionError(f"gspmd {label}: graphed weights differ from "
                             f"the eager call's")
    if graphed["collectives"] != eager["collectives"] or \
            eager["collectives"][0] != 1:
        raise AssertionError(f"gspmd {label}: collectives eager "
                             f"{eager['collectives']}, captured "
                             f"{graphed['collectives']}")
    wdiff = _max_diff(eager["weights"], base["weights"])
    out = dict(B=B, T=cfg.rollout_len, replay_s=secs, peak_gb=peak,
               rise_gb=rise,
               capture_s=getattr(step, "capture_s", None), profile=prof,
               weights_vs_unsharded=wdiff,
               all_gathers=eager["collectives"][0],
               all_reduces=eager["collectives"][1],
               model_all_gathers=eager["collectives"][2],
               model_all_reduces=eager["collectives"][3],
               loss=[base["metrics"]["loss"], eager["metrics"]["loss"]],
               eager_s=[base["secs"], eager["secs"]], unsharded_graph=own)
    print(f"[gspmd] {label} ({' '.join(flags) or 'defaults'}, B={B}, "
          f"T={cfg.rollout_len}): launches per step {per_step}; after one "
          f"step env state and key bit-equal to the unsharded step's "
          f"(eager and graphed), weights max |mesh - unsharded| "
          f"{wdiff:.3e} (bound rtol 2e-4, atol 2e-5), loss "
          f"{eager['metrics']['loss']:.6f} vs {base['metrics']['loss']:.6f};"
          f" {eager['collectives'][0]} all_gather and "
          f"{eager['collectives'][1]} all_reduce calls a step on 'data'"
          + (f", {eager['collectives'][2]} all_gather and "
             f"{eager['collectives'][3]} all_reduce on 'model'" if tp
             else "")
          + f", all captured "
          f"(graph nodes), none from the host on a replay; replays "
          f"{', '.join(f'{t:.3f}' for t in secs)} s; capture "
          f"{out['capture_s']} s; peak device memory allocated / reserved "
          f"{peak[0]:.2f} / {peak[1]:.2f} GB (allocated {rise:.3f} GB above "
          f"the run's start) [{card}]")
    del step, graphed
    if own is not None:
        up, mp_ = own["profile"], prof
        busy = (f"busy {mp_['device_busy_s'] * 1e3:.1f} ms in "
                f"{mp_['device_ops']} device ops against the unsharded "
                f"graphed step's {up['device_busy_s'] * 1e3:.1f} ms in "
                f"{up['device_ops']} ("
                f"{mp_['device_busy_s'] / up['device_busy_s']:.4f}x busy)"
                if up["device_busy_s"] > 0 and mp_["device_busy_s"] > 0
                else "busy not measured (no device time in the profile)")
        print(f"[gspmd] {label}: graphed mesh= step {busy}; replays "
              f"{', '.join(f'{t:.3f}' for t in secs)} s against "
              f"{', '.join(f'{t:.3f}' for t in own['replay_s'])} s; "
              f"allocated {rise:.3f} GB above its run's start against the "
              f"unsharded graphed step's {own['rise_gb']:.3f} GB (eager "
              f"call, capture, replays); unsharded graphed step env state "
              f"and key bit-equal to its eager call's [{card}]")
    if multi:
        out.update(_gspmd_multi(call, train_mod.make_step(
            ep, cfg, net, opt, dev, jit=False, mesh=mesh), h is None,
            eager["collectives"], label, card))
    del net, opt, h, carry0, w0, base, eager
    torch.cuda.empty_cache()
    return out


def _gspmd_multi(call, raw, feedforward, per_call, label, card):
    """:func:`phase_gspmd`'s ``multi_step`` runs: from the start two eager
    steps of the raw mesh step, then ``ppo.multi_step``
    (``ppo_rnn.multi_step_rnn``) of it with k = 2, one call (an eager step,
    then the capture of the second) and one call of two replays, with
    their bars."""
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    eager1 = call(raw, "raw eager step 1")
    eager2 = call(raw, "raw eager step 2", carry=eager1.pop("carry"))
    del eager2["carry"]
    wrap = ppo.multi_step if feedforward else ppo_rnn.multi_step_rnn
    multi = wrap(raw, 2)
    mres = call(multi, "multi_step(k=2) call", steps=2)
    carry = mres.pop("carry")
    mcoll = mres["collectives"]
    want_coll = tuple(2 * c for c in per_call)
    mrep = call(multi, "multi_step(k=2) replays", carry=carry, steps=2)
    del carry, mrep["carry"]
    for what in ("env_key", "h", "weights"):
        if not all(torch.equal(x, y) for x, y in zip(
                mres[what], eager2[what], strict=True)):
            raise AssertionError(f"gspmd {label} multi_step(k=2): {what} "
                                 f"differs from two eager steps'")
    if mres["metrics"] != eager2["metrics"]:
        raise AssertionError(f"gspmd {label} multi_step(k=2): metrics "
                             f"{mres['metrics']} vs two eager steps' "
                             f"{eager2['metrics']}")
    if mcoll != want_coll or any(mrep["collectives"]):
        raise AssertionError(f"gspmd {label} multi_step(k=2): collectives "
                             f"of its first call {mcoll} (want {want_coll}: "
                             f"an eager step's and the capture's), of a "
                             f"replay call {mrep['collectives']} (want none "
                             f"from the host)")
    print(f"[gspmd] {label}: multi_step(k=2) of the raw mesh step, from the "
          f"start: env state, key, carry, weights and metrics bit-equal to "
          f"two eager steps'; its first call {mcoll[0]} all_gather and "
          f"{mcoll[1]} all_reduce calls (an eager step's, then the "
          f"capture's), none from the host on a call of two replays; calls "
          f"{mres['secs']:.3f}, {mrep['secs']:.3f} s, capture "
          f"{multi.step.capture_s} s [{card}]")
    out = dict(multi_s=[mres["secs"], mrep["secs"]],
               multi_capture_s=multi.step.capture_s,
               raw_eager_s=[eager1["secs"], eager2["secs"]])
    del multi, raw
    return out


#: the JAX package's shard-count equivalence case (tests/test_shard_map.py)
#: at B = 64: (EnvParams fields, PPOConfig fields, stagger)
RANKS_CASE = (dict(width=9, height=9, n_agents=2, scenario="cluttered",
                   n_clutter=6, max_steps=100, view_size=5,
                   observation_style="encode"),
              dict(n_envs=64, rollout_len=4, n_epochs=1, n_minibatches=1,
                   dtype=torch.float32), False)
#: the sharded default path's case, with resets inside the rollout (the
#: CPU tests' ``resets`` case at B = 64): empty 9x9, max_steps 10 with the
#: stagger, T = 8, 2 epochs x 2 minibatches of 8 blocks, 4 a rank
GSPMD_RANKS_CASE = (dict(width=9, height=9, n_agents=2, scenario="empty",
                         max_steps=10, view_size=5,
                         observation_style="encode"),
                    dict(n_envs=64, rollout_len=8, n_epochs=2,
                         n_minibatches=2, dtype=torch.float32), True)
#: the hetero trainers' case on the sharded default path, with resets: the
#: perf gate's all-encode population (views 7, 5, 7, 5) on goal_cycle 9x9,
#: max_steps 10 with the stagger, B = 64, T = 8, 2 epochs x 2 minibatches
#: of 8 (agent, step, 64-env) blocks a group, 4 a rank
GSPMD_HETERO_RANKS_CASE = (dict(width=9, height=9, n_agents=4,
                                scenario="goal_cycle", max_steps=10,
                                reward_decay=False, agent_colors=(0, 4, 5, 1),
                                observation_style="encode",
                                agent_view_sizes=(7, 5, 7, 5)),
                           GSPMD_RANKS_CASE[1], True)


#: the bounds of the sharded default path's two ranks against one on the
#: card (:func:`phase_shard_map_ranks`), as ``TRAIN_TOL``'s: each tensor's
#: first gradient within ``grad`` of its norm, its weights after the two
#: steps within ``weights`` of their change in L2 norm. K2b reads dout in
#: bf16, and two ranks sum each minibatch's advantage statistics and loss
#: terms in two parts where one rank sums them in one, so a dout entry a
#: float32 ulp apart now and then rounds to the other bf16 value; over 8
#: Adam steps such a difference moves a few hundred of the 152,000 weights
#: by up to the learning rate. On an H100 the gradients read 3.5e-5 and
#: the weights 8.5e-3 (the --shard-map step, one Adam step a train step:
#: 1.0e-5 and 1.0e-5); the bounds sit 30x and 6x above. The witness runs
#: beside it: the same pair with the embed in float32, forward and
#: backward by K2f's and K2b's plain versions (:func:`float32_embed`), as
#: the CPU tests run it, holds rtol 2e-4 / atol 2e-5 elementwise.
GSPMD_RANKS_TOL = dict(grad=1e-3, weights=5e-2)

#: the two-rank phase's runs: (label, :func:`_ranks_run` keywords)
RANKS_RUNS = (("shard_map", {}),
              ("mesh= (resets)", dict(gspmd=True)),
              ("mesh= (resets), float32 embed",
               dict(gspmd=True, f32_embed=True)),
              ("hetero mesh= (resets)", dict(gspmd=True, hetero=True)),
              ("hetero mesh= (resets), float32 embed",
               dict(gspmd=True, hetero=True, f32_embed=True)),
              # the 'model' axis: the tensor-parallel step at (1, 2), each
              # rank's K2f and K2b on its H / 2 = 64 columns
              ("tp (1, 2) (resets)", dict(gspmd=True, tp=True)),
              ("tp (1, 2) (resets), float32 embed",
               dict(gspmd=True, tp=True, f32_embed=True)))


@contextlib.contextmanager
def float32_embed():
    """The one-hot embed in float32 on the card while the block runs, in
    this process: forward and table gradient by K2f's and K2b's plain
    versions (``embed.onehot_embed_plain``, ``onehot_embed_bwd_plain``),
    where the card runs K2f, which rounds its output to bf16 (so autograd
    hands K2b a bf16 dout). The two-rank phase's witness that the bf16
    embed is what parts its D = 2 and D = 1 weights."""
    from marlgrid_tpu_torch.ops import embed

    fn = embed._OneHotEmbedFn
    saved = fn.__dict__["backward"], embed._forward

    def forward(x, w, widths, values, dtype):
        return embed.onehot_embed_plain(x, w, widths, values, torch.float32)

    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        widths, values, _, w_dtype = ctx.spec
        dw = embed.onehot_embed_bwd_plain(x, dout.float(), widths, values)
        return None, dw.to(w_dtype), None, None, None

    fn.backward, embed._forward = staticmethod(backward), forward
    try:
        yield
    finally:
        fn.backward, embed._forward = saved


def _ranks_run(seed, mesh, steps=2, gspmd=False, f32_embed=False,
               hetero=False, tp=False):
    """Two eager steps on the card over ``mesh`` from the weights of
    ``seed`` (rank 0's, broadcast): ``--shard-map`` steps of
    :data:`RANKS_CASE`, or with ``gspmd`` the sharded default path's of
    :data:`GSPMD_RANKS_CASE` (with ``hetero``, the all-encode hetero
    trainer's of :data:`GSPMD_HETERO_RANKS_CASE`); with ``f32_embed`` under
    :func:`float32_embed`. The weights, the last loss and episode count,
    the launch counts (and the path's, K2f's and K2b's 0 with
    ``f32_embed``), and the env state gathered in global env order with
    the key (on the CPU). ``tp``: over a mesh with a group, the
    tensor-parallel policy (``tensor_parallel.TensorParallelActorCritic``,
    this rank's shards: its weights and gradients are shards too) in
    ``ppo.make_train_step(mesh=...)``; with no group, the unsharded
    step."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                               default_agent_colors)
    from marlgrid_tpu_torch.parallel import mesh as mesh_mod
    from marlgrid_tpu_torch.parallel import ppo
    from marlgrid_tpu_torch.parallel import train as train_mod

    ep_kw, cfg_kw, stagger = (GSPMD_HETERO_RANKS_CASE if hetero
                              else GSPMD_RANKS_CASE if gspmd else RANKS_CASE)
    ep = EnvParams(**{"agent_colors": default_agent_colors(2), **ep_kw})
    cfg = ppo.PPOConfig(**cfg_kw)
    from marlgrid_tpu_torch.parallel import tensor_parallel

    dev = mesh.device
    gen = torch.Generator().manual_seed(seed)
    if tp and mesh.group is not None:
        net = tensor_parallel.TensorParallelActorCritic(
            cfg, ep.view_size, mesh, gen, device=dev)
        opt = ppo.make_optimizer(net, cfg)
        tensor_parallel.broadcast_state(mesh, net, opt)
    else:
        net, opt, _ = train_mod.init(ep, cfg, gen, dev)
        mesh_mod.broadcast_from(mesh, list(net.state_dict().values()))
    key = rng.PRNGKey(seed, device=dev)
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             stagger=stagger, device=dev, mesh=mesh)
    if tp:
        step = ppo.make_train_step(ep, cfg, net, opt, device=dev, jit=False,
                                   mesh=mesh)
    elif gspmd:
        step = train_mod.make_step(ep, cfg, net, opt, dev, jit=False,
                                   mesh=mesh)
    else:
        step = ppo.make_train_step_shard_map(ep, cfg, net, opt, mesh,
                                             jit=False, device=dev)
    w0 = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    first = {}
    _record_first_grads(net, opt, first)
    zero_counts()
    with float32_embed() if f32_embed else contextlib.nullcontext():
        for _ in range(steps):
            env, key, m = step(env, key)
    counts = read_counts()
    path = path_counts(ep, cfg, False)
    if f32_embed:
        path.update(onehot_embed_fwd=0, onehot_embed_bwd=0)
    return dict(
        w0=w0, grad0=first,
        weights={k: v.cpu() for k, v in net.state_dict().items()},
        loss=float(m["loss"]), n_episodes=float(m["n_episodes"]),
        counts=counts, key=key.cpu(),
        env={f: mesh_mod.gather(mesh, getattr(env, f)).cpu() for f in FIELDS},
        path=path)


def _ranks_worker(rank, world, store, seed, out):
    """One rank of :func:`phase_shard_map_ranks` (a spawned process):
    a gloo group over the card's tensors, then :func:`_ranks_run` of each of
    :data:`RANKS_RUNS` (the ``tp`` runs over a (1, 2) mesh, the others over
    the data axis); each rank saves its results to ``out``-rank."""
    import torch.distributed as dist

    from marlgrid_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = mesh_mod.make_mesh(device="cuda")
        mesh2d = mesh_mod.make_mesh(n_model=2, device="cuda")
        res = {what: _ranks_run(seed, mesh2d if kw.get("tp") else mesh,
                                **kw) for what, kw in RANKS_RUNS}
        torch.save(res, f"{out}-{rank}")
    finally:
        dist.destroy_process_group()


def phase_shard_map_ranks(seed, card):
    """Two ranks on the one card (``torch.multiprocessing`` spawn; NCCL
    refuses two ranks on one GPU, so a gloo group, its collectives over the
    card's tensors; eager steps, since gloo cannot be captured) against
    one rank with no group (D = 1), :data:`RANKS_RUNS`: the
    ``--shard-map`` step on :data:`RANKS_CASE`, and in the same spawn the
    sharded default path's step on :data:`GSPMD_RANKS_CASE` and the hetero
    trainer's on :data:`GSPMD_HETERO_RANKS_CASE`, with resets, each once as
    the card runs it and once with the embed in float32
    (:func:`float32_embed`, the witness), and the tensor-parallel step
    over the same two ranks laid out (1, 2) (the 'model' axis: each rank's
    K2f and K2b on its H / 2 columns), its shards put together. Each: the
    loss within rtol 2e-3, the env state and the key bit-equal, each
    rank's launches those of the unsharded step; the weights after two
    steps within the JAX test's bound (rtol 2e-4, atol 2e-5) for
    ``--shard-map`` and the witnesses, and within :data:`GSPMD_RANKS_TOL`
    in norm for the sharded default path and the tensor-parallel step with
    the bf16 embed."""
    import torch.multiprocessing as mp

    from marlgrid_tpu_torch.models import MODEL_SPLIT
    from marlgrid_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_ranks_worker, args=(2, f"{tmp}/store", seed, f"{tmp}/out"),
                 nprocs=2, join=True)
        ranks = [torch.load(f"{tmp}/out-{r}", weights_only=False)
                 for r in range(2)]
    spawn_s = time.perf_counter() - t0
    report = dict(spawn_s=spawn_s)
    for what, kw in RANKS_RUNS:
        d2 = ranks[0][what]
        if kw.get("tp"):
            # the model ranks' shards put together; the replicated entries
            # the same on both
            for k, v in ranks[1][what]["weights"].items():
                if k in MODEL_SPLIT or torch.equal(v, d2["weights"][k]):
                    continue
                raise AssertionError(f"{what} ranks: replicated {k} "
                                     f"differs between the model ranks")
            d2 = dict(d2, **{k: _tp_whole([r[what][k] for r in ranks])
                             for k in ("w0", "grad0", "weights")})
        d1 = _ranks_run(seed, mesh_mod.make_mesh(device="cuda"), **kw)
        gspmd = kw.get("gspmd", False)
        in_norm = gspmd and not kw.get("f32_embed", False)
        for run in (d1, d2):
            want = {k: 2 * v for k, v in run["path"].items()}
            if run["counts"] != want:
                raise AssertionError(f"{what} ranks: launches "
                                     f"{run['counts']}, want {want}")
        worst, n_off, e_g, e_w = 0.0, 0, 0.0, 0.0
        for k, w in d1["weights"].items():
            x, w = d2["weights"][k].double(), w.double()
            g1, g2 = d1["grad0"][k].double(), d2["grad0"][k].double()
            off = ~torch.isclose(x, w, rtol=2e-4, atol=2e-5)
            n_off += int(off.sum())

            worst = max(worst, float((x - w).abs().max()))
            e_g = max(e_g, float((g2 - g1).norm() / g1.norm()))
            e_w = max(e_w, float((x - w).norm()
                                 / (w - d1["w0"][k].double()).norm()))
            if not in_norm and off.any():
                raise AssertionError(f"{what} ranks: {int(off.sum())} "
                                     f"weights of {k} of D=2 off D=1's "
                                     f"beyond rtol 2e-4, atol 2e-5 (max "
                                     f"|diff| {worst:.3e})")
        if in_norm and not (e_g <= GSPMD_RANKS_TOL["grad"]
                            and e_w <= GSPMD_RANKS_TOL["weights"]):
            raise AssertionError(f"{what} ranks: first gradients {e_g:.3e} "
                                 f"of their norm apart, weights {e_w:.3e} "
                                 f"of the steps' change apart, beyond "
                                 f"{GSPMD_RANKS_TOL}")
        if not (math.isfinite(d2["loss"]) and math.isclose(
                d2["loss"], d1["loss"], rel_tol=2e-3, abs_tol=1e-4)):
            raise AssertionError(f"{what} ranks: loss {d2['loss']} vs "
                                 f"{d1['loss']}")
        for f, v in d1["env"].items():
            if not torch.equal(v, d2["env"][f]):
                raise AssertionError(f"{what} ranks: env field {f} differs")
        if not torch.equal(d1["key"], d2["key"]):
            raise AssertionError(f"{what} ranks: the key differs")
        if gspmd and not d2["n_episodes"] > 0:
            raise AssertionError(f"{what} ranks: no env reset")
        ep_kw, cfg_kw, _ = (GSPMD_HETERO_RANKS_CASE if kw.get("hetero")
                            else GSPMD_RANKS_CASE if gspmd else RANKS_CASE)
        views = ("" if "agent_view_sizes" not in ep_kw else
                 f" views {ep_kw['agent_view_sizes']}")
        print(f"[shard_map] {what}: 2 ranks on one card (gloo over the "
              f"card's tensors, spawned, {spawn_s:.1f} s for all runs' "
              f"steps) against 1 (no group): {ep_kw['scenario']} 9x9{views}, "
              f"B={cfg_kw['n_envs']}, T={cfg_kw['rollout_len']}, float32, 2 "
              f"eager steps ({d2['n_episodes']:.0f} episodes ended in the "
              f"last): env state and key bit-equal, weights max |D2 - D1| "
              f"{worst:.3e}, {n_off} beyond rtol 2e-4, atol 2e-5 (bound: "
              + ("each tensor's first gradient and weights within "
                 f"{GSPMD_RANKS_TOL['grad']} / {GSPMD_RANKS_TOL['weights']} "
                 f"of its norm / of the steps' change: {e_g:.3e} / "
                 f"{e_w:.3e}" if in_norm else "none; first gradients "
                 f"{e_g:.3e} of their norm, weights {e_w:.3e} of the steps' "
                 f"change") + f"), loss "
              f"{d2['loss']:.6f} vs {d1['loss']:.6f}; launches per rank "
              f"{d2['counts']} [{card}]")
        report[what] = dict(
            max_weight_diff=worst, n_off=n_off, grad_err=e_g, weight_err=e_w,
            loss=[d2["loss"], d1["loss"]], counts=d2["counts"])
    return report


#: the tensor-parallel host runs (:func:`phase_tp_ranks`): (label, world,
#: n_model), float32, on :data:`GSPMD_RANKS_CASE`
TP_RUNS = (("(1, 2)", 2, 2), ("(2, 2)", 4, 2))


def _tp_run(seed, mesh, steps=2):
    """Two steps of the tensor-parallel feedforward step on the CPU over
    ``mesh`` (with no group: the unsharded policy's step) from the weights
    of ``seed``, on :data:`GSPMD_RANKS_CASE` (float32): the weights (this
    rank's shards), the first gradients, the last loss and episode count,
    the env state gathered in global env order and the key."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                               default_agent_colors)
    from marlgrid_tpu_torch.parallel import mesh as mesh_mod
    from marlgrid_tpu_torch.parallel import ppo, tensor_parallel

    ep_kw, cfg_kw, stagger = GSPMD_RANKS_CASE
    ep = EnvParams(**{"agent_colors": default_agent_colors(2), **ep_kw})
    cfg = ppo.PPOConfig(**cfg_kw)
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    if mesh.group is None:
        net, opt = ppo.init_state(ep, cfg, gen, device=dev)
    else:
        net = tensor_parallel.TensorParallelActorCritic(
            cfg, ep.view_size, mesh, gen, device=dev)
        opt = ppo.make_optimizer(net, cfg)
        tensor_parallel.broadcast_state(mesh, net, opt)
    key = rng.PRNGKey(seed, device=dev)
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             stagger=stagger, device=dev, mesh=mesh)
    step = ppo.make_train_step(ep, cfg, net, opt, device=dev, mesh=mesh)
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    first = {}
    _record_first_grads(net, opt, first)
    for _ in range(steps):
        env, key, m = step(env, key)
    return dict(w0=w0, grad0=first, weights=net.state_dict(),
                loss=float(m["loss"]), n_episodes=float(m["n_episodes"]),
                key=key, env={f: mesh_mod.gather(mesh, getattr(env, f))
                              for f in FIELDS},
                collectives=(mesh.all_gathers, mesh.all_reduces,
                             mesh.model_all_gathers, mesh.model_all_reduces))


def _tp_ranks_worker(rank, world, n_model, store, seed, out):
    """One gloo rank of :func:`phase_tp_ranks` on the host (a spawned
    process): :func:`_tp_run` over the (world / n_model, n_model) mesh;
    each rank saves its result to ``out``-rank."""
    import torch.distributed as dist

    from marlgrid_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = mesh_mod.make_mesh(n_model=n_model, device="cpu")
        torch.save(_tp_run(seed, mesh), f"{out}-{rank}")
    finally:
        dist.destroy_process_group()


def _tp_whole(parts):
    """A state_dict put back together from the model ranks' ``parts``."""
    from marlgrid_tpu_torch.models import MODEL_SPLIT

    return {k: (torch.cat([p[k] for p in parts], MODEL_SPLIT[k])
                if k in MODEL_SPLIT else parts[0][k]) for k in parts[0]}


def phase_tp_ranks(seed, card):
    """The tensor-parallel feedforward step over gloo ranks on the host
    (``--device cpu``), :data:`TP_RUNS`, all started at once: two ranks
    at (1, 2) and four at (2, 2) (the data axis too), float32, each
    against the unsharded step in this process from the same weights,
    two steps of
    :data:`GSPMD_RANKS_CASE` (B = 64, resets); the two ranks on the card
    are in :func:`phase_shard_map_ranks`. Each: the env state and key
    bit-equal; the replicated weights equal on every rank; the weights,
    the ranks' shards put together, within rtol 2e-4 / atol 2e-5."""
    import torch.multiprocessing as mp

    from marlgrid_tpu_torch.models import MODEL_SPLIT
    from marlgrid_tpu_torch.parallel import mesh as mesh_mod

    report, results = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the runs' ranks at once, and the unsharded step here meanwhile
        runs = [(what, world, mp.spawn(
            _tp_ranks_worker, args=(world, n_model, f"{tmp}/store{world}",
                                    seed, f"{tmp}/out{world}"),
            nprocs=world, join=False)) for what, world, n_model in TP_RUNS]
        d1 = _tp_run(seed, mesh_mod.make_mesh(device="cpu"))
        for what, world, ctx in runs:
            while not ctx.join():
                pass
            results[what] = [torch.load(f"{tmp}/out{world}-{r}",
                                        weights_only=False)
                             for r in range(world)]
    spawn_s = time.perf_counter() - t0
    for what, world, n_model in TP_RUNS:
        ranks = results[what]
        for r in ranks:
            for k, v in r["weights"].items():
                if k not in MODEL_SPLIT and not torch.equal(
                        v, ranks[0]["weights"][k]):
                    raise AssertionError(f"tp ranks {what}: replicated {k} "
                                         f"differs between ranks")
            for f, v in d1["env"].items():
                if not torch.equal(v, r["env"][f]):
                    raise AssertionError(f"tp ranks {what}: env field {f} "
                                         f"differs from the unsharded step")
            if not torch.equal(d1["key"], r["key"]):
                raise AssertionError(f"tp ranks {what}: the key differs")
        # the model ranks of data index 0
        whole = _tp_whole([r["weights"] for r in ranks[:n_model]])
        worst, n_off = 0.0, 0
        for k, want in d1["weights"].items():
            x, y = whole[k].double(), want.double()
            n_off += int((~torch.isclose(x, y, rtol=2e-4, atol=2e-5)).sum())
            worst = max(worst, float((x - y).abs().max()))
        if n_off:
            raise AssertionError(f"tp ranks {what}: {n_off} weights beyond "
                                 f"rtol 2e-4, atol 2e-5 (max |diff| "
                                 f"{worst:.3e})")
        if not (math.isfinite(ranks[0]["loss"]) and math.isclose(
                ranks[0]["loss"], d1["loss"], rel_tol=2e-3, abs_tol=1e-4)
                and ranks[0]["n_episodes"] > 0):
            raise AssertionError(f"tp ranks {what}: loss {ranks[0]['loss']} "
                                 f"vs {d1['loss']}")
        print(f"[tp] {what}: {world} gloo ranks on the host (spawned with "
              f"the other runs' ranks, {spawn_s:.1f} s for all) against the "
              f"unsharded step (no group): "
              f"empty 9x9, B=64, T=8, float32, 2 steps "
              f"({ranks[0]['n_episodes']:.0f} episodes ended in the last): "
              f"env state and key bit-equal, replicated weights equal on "
              f"every rank; shards put together: weights max |diff| "
              f"{worst:.3e}, {n_off} beyond rtol 2e-4, atol 2e-5; loss "
              f"{ranks[0]['loss']:.6f} vs {d1['loss']:.6f}; collectives a "
              f"rank (data all_gather, all_reduce; model all_gather, "
              f"all_reduce) {ranks[0]['collectives']}")
        report[what] = dict(max_weight_diff=worst, n_off=n_off,
                            loss=[ranks[0]["loss"], d1["loss"]],
                            collectives=ranks[0]["collectives"],
                            spawn_s=spawn_s)
    return report


def phase_cli_distributed(card, keep):
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    marlgrid_tpu_torch.parallel.train --distributed --shard-map`` at the CLI
    defaults but T = 32 (depth; one NCCL rank, graphed): two iterations
    with a checkpoint,
    written to ``keep`` (for the evaluate phase); then one iteration
    resumed from it in this process, ``--shard-map`` without
    ``--distributed``, with the unsharded step's launches. Beside it, in a
    process of its own on the same card started at the same time, the same
    torchrun without ``--shard-map`` (the sharded default path, graphed),
    two iterations, and the same with ``--agent-config`` (the perf gate's
    hetero population on ``make_train_step_hetero(mesh=...)``, T = 32).
    The runs share the card, so their times and rates are printed as
    measured on a shared card, not as a single run's. And at the same time
    ``--agent-config`` in two processes, ``--nproc-per-node 2`` with
    ``--device cpu`` (gloo, B = 64): NCCL refuses two ranks on one card,
    and the CLI's graphed step cannot capture gloo's collectives, so two
    ranks of the CLI run on the host; both ranks must log the same
    metrics. Every process is killed if anything in the phase fails."""
    from marlgrid_tpu_torch.parallel import train
    from marlgrid_tpu_torch.utils import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))

    procs = []

    def torchrun(*flags, nproc=1):
        """Start the train CLI under torchrun on ``nproc`` ranks; returns
        ``wait()`` -> (its seconds with process start, its JSONL records:
        one rank's ``--metrics`` file, or with more ranks every rank's
        lines of stdout, interleaved)."""
        log = f"{tmp}/run{len(procs)}.jsonl"
        t0 = time.perf_counter()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), "-m",
             "marlgrid_tpu_torch.parallel.train", "--distributed",
             "--iters", "2", *(("--metrics", log) if nproc == 1 else ()),
             *flags],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=root)))
        proc = procs[-1]

        def wait():
            out, err = proc.communicate(timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"torchrun --distributed "
                                     f"{' '.join(flags)} exited "
                                     f"{proc.returncode}:\n{out[-3000:]}\n"
                                     f"{err[-3000:]}")
            lines = (open(log) if nproc == 1 else
                     [x for x in out.splitlines() if x.startswith("{")])
            return secs, [json.loads(line) for line in lines]

        return wait

    with tempfile.TemporaryDirectory() as tmp:
        log = f"{tmp}/m.jsonl"
        try:
            shard_run = torchrun("--shard-map", "--rollout", "32",
                                 "--checkpoint-dir", keep,
                                 "--checkpoint-every", "2")
            mesh_run = torchrun("--rollout", "32")
            hetero_run = torchrun("--agent-config", HETERO_SPEC, "--rollout",
                                  "32")
            host = ("--device", "cpu", "--grid-size", "9", "--envs", "64",
                    "--rollout", "8", "--hidden", "32", "--max-steps", "10")
            ranks_run = torchrun("--agent-config", HETERO_SPEC, *host,
                                 nproc=2)
            model_run = torchrun("--model-shards", "2", *host, nproc=2)
            first, recs = shard_run()
            tree = checkpoint.restore(keep, map_location="cpu")
            if checkpoint.steps(keep) != [2] or \
                    tree["env_state"]["step_count"].shape != (4096,):
                raise AssertionError("torchrun --shard-map wrote no global "
                                     "checkpoint")
            zero_counts()
            train.main(["--shard-map", "--rollout", "32", "--resume", keep,
                        "--iters", "1", "--metrics", log])
            counts = read_counts()
            recs += [json.loads(line) for line in open(log)]
            mesh_s, mesh_recs = mesh_run()
            hetero_s, hetero_recs = hetero_run()
            ranks_s, ranks_recs = ranks_run()
            model_s, model_recs = model_run()
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    want = path_counts(*cli_config("--rollout", "32"), plane_major=False)
    if counts != want:
        raise AssertionError(f"resumed --shard-map: launches {counts}, want "
                             f"{want}")
    for r in recs + mesh_recs + hetero_recs + ranks_recs + model_recs:
        if not (math.isfinite(r["loss"]) and r["n_episodes"] > 0):
            raise AssertionError(f"--distributed CLI metrics {r}")
    if len(mesh_recs) != 2 or len(hetero_recs) != 2:
        raise AssertionError(f"torchrun --distributed logged {mesh_recs}, "
                             f"with --agent-config {hetero_recs}")

    def by_step(recs, what):
        """Two ranks: each step logged once by each, with the same
        metrics."""
        same = {k for k in recs[0]} - {"time", "env_steps_per_s",
                                       "agent_steps_per_s"}
        steps = {}
        for r in recs:
            steps.setdefault(r["step"], []).append({k: r[k] for k in same})
        if sorted(steps) != [0, 1] or any(
                len(v) != 2 or v[0] != v[1] for v in steps.values()):
            raise AssertionError(f"torchrun --nproc-per-node 2 {what}: the "
                                 f"ranks logged {recs}")
        return ", ".join(format(v[0]["loss"], ".6f")
                         for _, v in sorted(steps.items()))

    ranks_losses = by_step(ranks_recs, "--agent-config")
    model_losses = by_step(model_recs, "--model-shards 2")
    print(f"[cli] torchrun --nproc-per-node 1 ... train --distributed "
          f"--shard-map (defaults, T=32, NCCL, graphed; on a card shared with "
          f"the "
          f"next run): 2 iterations + checkpoint in {first:.2f} s (process "
          f"start included), then 1 resumed without --distributed; launches "
          f"{counts}; env_steps_per_s on the shared card "
          f"{', '.join(format(r['env_steps_per_s'], ',.0f') for r in recs)}"
          f" [{card}]")
    mesh_rates = ", ".join(format(r["env_steps_per_s"], ",.0f")
                           for r in mesh_recs)
    print(f"[cli] torchrun --nproc-per-node 1 ... train --distributed "
          f"(the sharded default path, defaults, T=32, NCCL, graphed; on a card "
          f"shared with the --shard-map run): 2 iterations in {mesh_s:.2f} "
          f"s (process start included); losses "
          f"{', '.join(format(r['loss'], '.6f') for r in mesh_recs)}; "
          f"env_steps_per_s on the shared card {mesh_rates} [{card}]")
    hetero_rates = ", ".join(format(r["env_steps_per_s"], ",.0f")
                             for r in hetero_recs)
    print(f"[cli] torchrun --nproc-per-node 1 ... train --distributed "
          f"--agent-config {HETERO_SPEC} --rollout 32 (the hetero trainer's "
          f"sharded default path, NCCL, graphed; on a card shared with the "
          f"runs above): 2 iterations in {hetero_s:.2f} s (process start "
          f"included); losses "
          f"{', '.join(format(r['loss'], '.6f') for r in hetero_recs)}; "
          f"env_steps_per_s on the shared card {hetero_rates} [{card}]")
    print(f"[cli] torchrun --nproc-per-node 2 ... train --distributed "
          f"--agent-config (views 7/5/7/5) --device cpu (gloo, B=64, T=8, "
          f"on the host): 2 iterations in {ranks_s:.2f} s, both ranks logged "
          f"the same metrics, losses {ranks_losses}")
    print(f"[cli] torchrun --nproc-per-node 2 ... train --distributed "
          f"--model-shards 2 --device cpu (gloo, a (1, 2) mesh: the two "
          f"ranks of the model axis repeat one step, B=64, T=8, on the "
          f"host): 2 iterations in {model_s:.2f} s, both ranks logged the "
          f"same metrics, losses {model_losses}")
    return dict(env_steps_per_s=[r["env_steps_per_s"] for r in recs],
                losses=[r["loss"] for r in recs], counts=counts,
                first_s=first, mesh_s=mesh_s, hetero_s=hetero_s,
                hetero_losses=[r["loss"] for r in hetero_recs],
                ranks_s=ranks_s, model_shards_s=model_s,
                mesh_losses=[r["loss"] for r in mesh_recs],
                mesh_env_steps_per_s=[r["env_steps_per_s"]
                                      for r in mesh_recs])


#: the port's examples and the flags of their short runs on the card
EXAMPLES = (("torch_random_rollout.py", ("--max-steps", "30")),
            ("torch_batched_rollout.py", ("--iters", "3")),
            ("torch_custom_env.py", ("--max-steps", "30")),
            ("torch_hetero_population.py", ("--iters", "1", "--rollout",
                                            "8")))


def phase_examples(card):
    """Each of the port's examples (``examples/torch_*.py``, the JAX
    package's four scripts) once on the card at a short depth, in
    processes of their own started together (a registered env's episode
    of 30 steps, 3 steps of 16,384 batched envs, a custom scenario's
    episode of 30 steps, 1 train step of the mixed hetero population at
    T = 8):
    each must exit 0 and print its result lines. Every process is killed
    if one fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    want = {"torch_random_rollout.py": "episode returns:",
            "torch_batched_rollout.py": "iter 2:",
            "torch_custom_env.py": "episode returns:",
            "torch_hetero_population.py": "trained in one step"}
    procs, t0 = [], time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name, flags in EXAMPLES:
                procs.append((name, flags, subprocess.Popen(
                    [sys.executable, os.path.join(root, "examples", name),
                     *flags], cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                    env=dict(os.environ, PYTHONPATH=root, TMPDIR=tmp))))
            out = {}
            for name, flags, proc in procs:
                log = proc.communicate(timeout=600)[0]
                out[name] = time.perf_counter() - t0
                if proc.returncode != 0 or want[name] not in log:
                    raise AssertionError(f"example {name} exited "
                                         f"{proc.returncode}:\n{log[-3000:]}")
                last = [x for x in log.splitlines() if x.strip()][-2:]
                print(f"[examples] {name} {' '.join(flags)}: "
                      f"done {out[name]:.1f} s after the start (four "
                      f"processes sharing the card); {' | '.join(last)} "
                      f"[{card}]")
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    return out


def _to(tree, dev):
    """A trajectory or carry (tensors in lists, tuples, dicts and
    EnvStates; None kept) on ``dev``."""
    from marlgrid_tpu_torch.core.state import EnvState

    if isinstance(tree, EnvState):
        return tree.map(lambda x: x.to(dev))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return None if tree is None else tree.to(dev)


def reference_hetero(seed, name):
    """A hetero train step at a small size in float32 (``HETERO_PATHS``'s
    population with B = 16, T = 8, hidden 32, board pool 4, episodes of 12
    steps): the card's rollout, then the card's and the CPU's update of that
    trajectory (and, recurrent, the carry that entered it) from the same
    weights and key, held to ``TRAIN_TOL[name]`` as
    :func:`reference_train` holds the homogeneous steps. The mixed
    population's image group is float32 end to end on both devices (K3 is
    exact) and is held to ``TRAIN_TOL['image']``; its step runs without the
    global-norm clip, whose one factor over every group would carry the
    encode group's bf16 differences into the image group's step (the
    all-encode step keeps the clip)."""
    import dataclasses

    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo, ppo_hetero
    from marlgrid_tpu_torch.parallel import ppo_hetero_mixed as mixed
    from marlgrid_tpu_torch.parallel import ppo_hetero_rnn as hrnn
    from marlgrid_tpu_torch.parallel import train as train_mod

    flags, plane_major = HETERO_PATHS[name]
    ep, cfg = cli_config(*flags, "--envs", "16", "--rollout", "8",
                         "--hidden", "32", "--board-pool", "4",
                         "--max-steps", "12")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if name == "hetero-mixed":
        cfg = dataclasses.replace(cfg, max_grad_norm=math.inf)
    devs = {"card": "cuda", "cpu": "cpu"}
    with embed_v2(plane_major):
        made = {who: train_mod.init(ep, cfg,
                                    torch.Generator().manual_seed(seed),
                                    torch.device(dev))
                for who, dev in devs.items()}
    rollout, update = {
        "hetero": (ppo_hetero.make_rollout_hetero,
                   ppo_hetero.make_update_hetero),
        "hetero-rnn": (ppo_hetero.make_rollout_hetero,
                       hrnn.make_update_hetero_rnn),
        "hetero-mixed": (mixed.make_rollout_hetero_mixed,
                         mixed.make_update_hetero_mixed)}[name]
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             device="cuda")
    h0 = made["card"][2]
    _, key, traj, last, _ = rollout(ep, cfg, made["card"][0],
                                    device="cuda")(env, rng.fold_in(key, 2),
                                                   h0)
    w0 = {k: v.clone() for k, v in made["cpu"][0].state_dict().items()}
    ms, grads, ws = {}, {}, {}
    for who, (net, opt, _) in made.items():
        dev = devs[who]
        _record_first_grads(net, opt, grads.setdefault(who, {}))
        up = update(ep, cfg, net, opt, device=dev)
        args = (_to(traj, dev),) + ((_to(h0, dev),) if h0 is not None
                                    else ()) + (last.to(dev), key.to(dev))
        ms[who] = {k: float(v) for k, v in up(*args).items()}
        ws[who] = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    kinds = [n.kind for n in made["cpu"][0]]

    def part_of(k):
        # state_dict names of the group list start with the group's index
        if kinds[int(k.split(".")[0])] == "mlp":
            return "encode groups", TRAIN_TOL[name]
        return "image groups", TRAIN_TOL["image"]

    _check_reference(f"{name} train step ({len(kinds)} groups, B=16, T=8)",
                     TRAIN_TOL[name], ms, grads, ws, w0, part_of)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write every number of this run to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    clock = {}

    def stamp(label):
        """Print and keep the run's elapsed seconds after a phase."""
        clock[label] = time.perf_counter() - t_start
        print(f"[clock] {label}: done at {clock[label]:.1f} s", flush=True)

    phase_build()
    stamp("build")
    ck_root = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        return run_phases(args, card, stamp, clock, t_start, ck_root)
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)


def run_phases(args, card, stamp, clock, t_start, ck_root):
    """Every phase after the build (see the module docstring); the CLI
    phases keep their checkpoints under ``ck_root`` for the evaluate
    phase."""
    from marlgrid_tpu_torch.core import obs
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors

    k1_err = phase_transpose()
    tim_hash = phase_threefry(args.seed, card)
    gc = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   observation_style="encode",
                   agent_colors=default_agent_colors(4))
    pals = obs.encode_palettes(gc)
    errs = dict(transpose_bk=k1_err, onehot_embed_fwd=phase_embed(pals),
                onehot_embed_bwd=phase_embed_bwd(pals),
                onehot_embed2_fwd=phase_embed2(pals),
                onehot_embed2_bwd=phase_embed2_bwd(pals),
                compose_image_b=phase_sprite(args.seed))
    host_errs, tim_host = phase_host_shapes(pals, card)
    for name, err in host_errs.items():
        errs[name] = max(errs[name], err)
    stamp("kernel phases")
    phase_reference(args.seed)
    for name in HETERO_PATHS:
        reference_hetero(args.seed, name)
    rounding = phase_rounding_ops(card)
    stamp("reference")
    roll = phase_rollout(args.seed, card)
    tim_k4 = phase_transpose_traj(roll["traj_obs"], card)
    train = phase_train(args.seed, card)
    ckpts = {"mlp": (f"{ck_root}/mlp", False),
             "--rnn gru (plane-major)": (f"{ck_root}/gru", True),
             "hetero 7/5/7/5": (f"{ck_root}/hetero", False),
             "--torso cnn": (f"{ck_root}/cnn", False),
             "--shard-map (torchrun)": (f"{ck_root}/shard_map", False)}
    cli = phase_cli(card, T32, want_counts(
        transpose_bk=33, onehot_embed_fwd=41, onehot_embed_bwd=8), spc=2,
        keep=ckpts["mlp"][0])
    phase_cli_cpu_resume(card)
    stamp("rollout, K4, train")
    image = phase_image(args.seed, card)
    cli_image = phase_cli(card, ("--obs", "image") + T32, want_counts(
        transpose_bk=41, compose_image_b=41))
    rnn = phase_rnn(args.seed, card)
    rnn_image = phase_rnn_image(args.seed, card)
    cli_rnn = phase_cli(card, ("--rnn", "gru") + T32, want_counts(
        transpose_bk=33, onehot_embed2_fwd=41, onehot_embed2_bwd=8),
        plane_major=True, keep=ckpts["--rnn gru (plane-major)"][0])
    stamp("image, recurrent")
    rows = {name: phase_rows(args.seed, card, name) for name in ROW_PATHS}
    cli_cnn = phase_cli(card, ROW_PATHS["cnn"][0] + T32, path_counts(
        *cli_config(*ROW_PATHS["cnn"][0], *T32), plane_major=False),
        keep=ckpts["--torso cnn"][0])
    tools = phase_cli_tools(card)
    stamp("row store, CLI tools")
    hetero = {name: phase_hetero(args.seed, card, name)
              for name in HETERO_PATHS}
    for v in hetero.values():
        for kname, err in v["embed_errs"].items():
            errs[kname] = max(errs[kname], err)
    cli_hetero = phase_cli(card, HETERO_PATHS["hetero"][0] + T32,
                           hetero_counts(*cli_config(
                               *HETERO_PATHS["hetero"][0], *T32),
                               plane_major=False),
        keep=ckpts["hetero 7/5/7/5"][0])
    stamp("hetero")
    shard_ranks = phase_shard_map_ranks(args.seed, card)
    tp_ranks = phase_tp_ranks(args.seed, card)
    cli_shard = phase_cli_distributed(card, ckpts["--shard-map (torchrun)"][0])
    stamp("shard_map and tp ranks, torchrun CLI")
    host_api = phase_host_api(args.seed, card)
    examples = phase_examples(card)
    stamp("host API, examples")
    evaluation = phase_evaluate(ckpts, card)
    stamp("evaluate")
    prof = phase_profile(roll, train, image, rnn, hetero, card)
    stamp("profile")
    graphs = {name: phase_graphs(args.seed, card, name,
                                 profile=GRAPH_PATHS[name][2] == 4096)
              for name in GRAPH_PATHS}
    for name, eager in (("encode", "train_step"), ("rnn", "rnn_train_step"),
                        ("hetero-rnn", "hetero_rnn_train_step")):
        g, e = graphs[name]["graphed"]["profile"], prof[eager]
        if g["device_busy_s"] <= 0:
            continue                  # profile_stages said: not measured
        print(f"[graphs] {name} step (B=4096), profiled: eager (T="
              f"{e['T']}) wall {e['wall_s'] * 1e3:.1f} ms, busy "
              f"{e['device_busy_s'] * 1e3:.1f} ms, idle share "
              f"{1 - e['device_busy_s'] / e['wall_s']:.3f}, {e['device_ops']} "
              f"device ops; graphed (T={graphs[name]['T']}) wall "
              f"{g['wall_s'] * 1e3:.1f} ms, "
              f"busy "
              f"{g['device_busy_s'] * 1e3:.1f} ms, idle "
              f"{(g['wall_s'] - g['device_busy_s']) * 1e3:.1f} ms, idle share "
              f"{1 - g['device_busy_s'] / g['wall_s']:.3f}, "
              f"{g['device_ops']} device ops [{card}]")
    stamp("graphs")
    shard = phase_shard_map(args.seed, card)
    for name, what in (("encode", "gspmd encode"), ("rnn", "gspmd rnn"),
                       ("encode", "tp encode")):
        g, m = graphs[name]["graphed"], shard[what]
        gp, mp_ = g["profile"], m["profile"]
        if gp and gp["device_busy_s"] > 0 and mp_["device_busy_s"] > 0:
            kind = ("tensor-parallel step (n_model=1" if what.startswith("tp")
                    else "mesh= step (D=1")
            print(f"[gspmd] {what}: graphed {kind}, NCCL) busy "
                  f"{mp_['device_busy_s'] * 1e3:.1f} ms in "
                  f"{mp_['device_ops']} device ops, replays "
                  f"{', '.join(f'{t:.3f}' for t in m['replay_s'])} s, "
                  f"allocated {m['rise_gb']:.3f} GB above its run's start "
                  f"(eager call, capture, replays); the unsharded graphed "
                  f"step's "
                  f"(graphs phase) busy {gp['device_busy_s'] * 1e3:.1f} ms "
                  f"in {gp['device_ops']} ops "
                  f"({mp_['device_busy_s'] / gp['device_busy_s']:.4f}x busy),"
                  f" replays {', '.join(f'{t:.3f}' for t in g['seconds'][2:])}"
                  f" s, {g['rise_gb']:.3f} GB above its run's start "
                  f"[{card}]")
    stamp("shard_map")
    env = phase_env_only(args.seed, card)
    env_img = phase_env_only(args.seed, card, "image")
    stamp("env-only")
    vector = phase_vector(args.seed, card, env["env_steps_per_s"])
    stamp("vector")
    timer_check = phase_timer_check(card)
    tim = phase_timings(roll, card, args.seed)
    tim["compose_image_b"] = phase_timings_k3(image, env_img, card,
                                              args.seed)
    tim.update(phase_timings_k5(roll, rnn, card, args.seed))
    tim.update(phase_timings_5x5(hetero, card, args.seed))
    tim["embed_variant"] = phase_embed_roofline(roll, tim, pals, card,
                                                args.seed)
    # K3's error: the sprite phase's and that of the three timed shapes;
    # K5's: their phases' and that of their timed shapes
    errs["compose_image_b"] = float(max(
        [errs["compose_image_b"]]
        + [k["max_abs_err"] for k in tim["compose_image_b"].values()]))
    for name in ("onehot_embed_fwd", "onehot_embed2_fwd"):
        errs[name] = max([errs[name]] + [
            tim[f"{name}{where}"]["max_abs_err"]
            for where in ("", "_update", "_5x5")])
    errs["onehot_embed2_bwd"] = max([errs["onehot_embed2_bwd"]] + [
        tim[f"onehot_embed2_bwd{where}"]["max_abs_err"]
        for where in ("", "_5x5")])

    # launches: per train step on the train path (K1, K2f, K2b), on the
    # image train path (K3, which runs K1 73 times a step too) and on the
    # recurrent encode path with the plane-major embed (K5f, K5b); K3's,
    # K2f's and K5f's times are those at the update's shape, where most of
    # their time goes (the other shapes' are in --json). K4 and K6 are
    # probes that no train path launches ("launches" 0, "probe_launches"
    # their phases' count); K6 has one entry per mode, at the update's
    # shape.
    tim["transpose_traj"] = tim_k4
    kernels = []
    for name, src, line, path in (
            ("transpose_bk", "transpose.cu", "transpose.py:41", train),
            ("onehot_embed_fwd", "embed_fwd.cu", "embed.py:245", train),
            ("onehot_embed_bwd", "embed_bwd.cu", "embed.py:264", train),
            ("compose_image_b", "sprite.cu", "sprite.py:280", image),
            ("onehot_embed2_fwd", "embed_fwd.cu", "embed2.py:120", rnn),
            ("onehot_embed2_bwd", "embed_bwd.cu", "embed2.py:149", rnn)):
        k = tim[name]
        if name == "compose_image_b":
            k = k["update"]
        elif name in ("onehot_embed_fwd", "onehot_embed2_fwd"):
            k = tim[f"{name}_update"]
        kernels.append(dict(
            name=name, route="cuda", source=f"marlgrid_tpu_torch/csrc/{src}",
            replaces=f"marlgrid_tpu/ops/{line}",
            launches=path["counts"][name], max_abs_err=errs[name],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
        if "library_mm_ms" in k:
            kernels[-1]["library_mm_ms"] = k["library_mm_ms"]
    probes = [("transpose_traj", "transpose.cu",
               "marlgrid_tpu/ops/transpose.py:67", tim_k4,
               tim_k4["probe_launches"])]
    for mode in ("full", "build", "gemm"):
        probes.append((f"embed_variant_{mode}", "embed_fwd.cu",
                       "scripts/embed_roofline.py:104",
                       tim["embed_variant"][f"{mode} update's shape"],
                       tim["embed_variant"]["probe_launches"]))
    for name, src, replaces, k, n_probe in probes:
        kernels.append(dict(
            name=name, route="cuda", source=f"marlgrid_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, probe_launches=n_probe,
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"]))
        for extra in ("mma_bound_ms", "copy_ms"):
            if extra in k:
                kernels[-1][extra] = k[extra]
    # the hash: the acting cell's Gumbel draw, the widest; launches of the
    # eager train step
    k = tim_hash["bits one key (4, 32768, 7)"]
    kernels.append(dict(
        name=HASH, route="cuda", source="marlgrid_tpu_torch/csrc/threefry.cu",
        replaces="none: jax.random's threefry2x32, which XLA fuses",
        launches=train["counts"][HASH], max_abs_err=0.0, ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None))
    stamp("timings and probes")
    print(f"[timer] time_ms: {TIMER['runs']} checked runs, "
          f"{TIMER['retried']} repeated because the card's hold ended before "
          f"the host had queued the launches; longest hold "
          f"{TIMER['max_hold_ms']:.1f} ms; {TIMER['waiting']} timed "
          f"functions wait on the card themselves (unchecked)")
    total_s = time.perf_counter() - t_start
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, kernels=kernels,
                           rollout_counts=roll["counts"],
                           rollout_env_steps_per_s=roll["env_steps_per_s"],
                           rollout_first_call_s=roll["first_s"],
                           rollout_call_s=roll["steady_s"],
                           train_env_steps_per_s=train["env_steps_per_s"],
                           train_step_s=train["seconds"],
                           train_metrics=train["metrics"], cli=cli,
                           image=dict(
                               rollout_counts=image["rollout_counts"],
                               rollout_first_call_s=image["rollout_first_s"],
                               counts=image["counts"],
                               env_steps_per_s=image["env_steps_per_s"],
                               step_s=image["seconds"],
                               metrics=image["metrics"],
                               peak_gb=image["peak_gb"]),
                           cli_image=cli_image, rows=rows,
                           cli_cnn=cli_cnn, cli_tools=tools,
                           rnn={k: rnn[k] for k in (
                               "counts", "seconds", "metrics", "peak_gb",
                               "env_steps_per_s")},
                           rnn_image=rnn_image, cli_rnn=cli_rnn,
                           hetero={n: {k: v[k] for k in (
                               "counts", "seconds", "metrics", "peak_gb",
                               "env_steps_per_s")} for n, v in hetero.items()},
                           cli_hetero=cli_hetero,
                           env_only={k: env[k] for k in (
                               "env_steps_per_s", "seconds", "counts")},
                           env_only_image={k: env_img[k] for k in (
                               "env_steps_per_s", "seconds", "counts")},
                           profile=prof, graphs=graphs, timings=tim,
                           threefry=tim_hash,
                           host_shape_timings=tim_host, rounding=rounding,
                           vector=vector, host_api=host_api,
                           shard_map=shard, shard_map_ranks=shard_ranks,
                           tp_ranks=tp_ranks, timer_check=timer_check,
                           timer=TIMER,
                           cli_shard_map=cli_shard, examples=examples,
                           evaluate=evaluation, clock_s=clock,
                           total_s=total_s), f,
                      indent=1)
    print(f"[done] all phases passed in {total_s:.1f} s; rollout "
          f"{roll['env_steps_per_s']:,.0f} env-steps/s, train "
          f"{train['env_steps_per_s']:,.0f}, image train "
          f"{image['env_steps_per_s']:,.0f}, recurrent train "
          f"{rnn['env_steps_per_s']:,.0f}, recurrent image train "
          f"{rnn_image['env_steps_per_s']:,.0f}, "
          + "".join(f"{n} train {v['env_steps_per_s']:,.0f}, "
                    for n, v in list(rows.items()) + list(hetero.items()))
          + "graphed train "
          + "".join(f"{n} {v['graphed']['env_steps_per_s']:,.0f} "
                    f"(eager {v['eager']['env_steps_per_s']:,.0f}, "
                    f"B={v['B']}), "
                    for n, v in graphs.items())
          + f"env-only "
          f"{env['env_steps_per_s']:,.0f}, image env-only "
          f"{env_img['env_steps_per_s']:,.0f}, graphed rollout_fn "
          + ", ".join(f"{k} {v['env_steps_per_s']:,.0f}"
                      for k, v in vector.items())
          + f" env-steps/s; host step "
          + ", ".join(f"{v['step_ms']:.2f}" for v in host_api.values())
          + " ms; evaluate step "
          + ", ".join(f"{v['step_ms']:.2f}" for v in evaluation.values())
          + f" ms on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
