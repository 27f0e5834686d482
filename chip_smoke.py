#!/usr/bin/env python3
"""Smoke run of the PyTorch port (marlgrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--json PATH]

Needs one CUDA card (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports nothing of JAX. Phases, each raising on failure:

1. build every kernel from marlgrid_tpu_torch/csrc/ (one nvcc per source,
   in parallel) and print the build seconds and ptxas' report;
2. K1 (transpose_bk) against its plain version, bit-exact;
3. K2f (onehot_embed forward) against its plain version computed in
   float32 and rounded to bf16, within 1 bf16 ulp; K2b (its weight
   gradient) against its plain version at the update's shape, both fed the
   same bf16 dout, within 1e-3 of max |dW|, deterministic, and reached
   through the embed's autograd Function; K3 (compose_image_b, the sprite
   composite) against its plain version, bit-exact, on the ids of real
   views (goal_cycle at the rollout's shape, cluttered, doorkey with hidden
   keys and a view offset; prestige over all 8 levels) in the standard,
   (N, B) and s2d layouts, and on random ids in its other two variants;
   K5f (onehot_embed2, the plane-major embed, float32 out) against its
   plain version at the rollout's and the update's shapes within 1e-5 of
   max |out|, and K5b (its three tables' gradients) at the update's shape
   within 1e-3 of max |dW_p|, deterministic, through its autograd Function;
4. the env engine and the observations (encode and image) on the card
   against the same code on the CPU (which the tests hold bit-equal to the
   JAX package), the mlp and cnn_s2d policies' logits on the card against
   the CPU's, and a small float32 train step of each path (feedforward
   encode and image; recurrent: GRU encode on the plane-major embed, LSTM
   encode, GRU image): the card's rollout and update against the CPU's
   update of the same trajectory from the same weights;
5. the rollout path: a PPO rollout at the train default's full width
   (goal_cycle 13x13, 4 agents, 7x7 encode, B = 4096, T = 64, hidden 128,
   board pool 256, stagger, the compact embed palettes) through
   ``make_rollout``, with the launch counts read around it;
6. the train path: ``make_train_step`` at the same width (2 epochs x 4
   minibatches), four train steps, with the launch counts of K1, K2f, K2b
   and K3 read around each (65 / 73 / 8 / 0) and train env-steps/s; then
   the training CLI at its defaults, two iterations with a checkpoint and
   one resumed from it;
7. the image train path at the same width (``--obs image``: 7x7 views of
   8-pixel tiles, the cnn_s2d torso, re-rendered minibatches): one rollout
   (65 launches each of K1 and K3) and four train steps (73 each, K2f and
   K2b none), with train env-steps/s, each step's mean episode return and
   the peak device memory; then the CLI with ``--obs image``, two
   iterations with a checkpoint and one resumed from it;
8. the recurrent train paths at the same width: ``--rnn gru`` with the
   plane-major embed (``MARLGRID_TPU_EMBED_V2=1``), four train steps with
   65 / 73 / 8 launches of K1 / K5f / K5b and none of K2f, K2b, K3 per
   step, and ``--rnn gru --obs image``, four steps with 73 each of K1 and
   K3; each with train env-steps/s, its losses and its peak device memory;
   then the ``--rnn gru`` CLI, two iterations with a checkpoint (the carry
   included) and one resumed from it;
9. torch.profiler over a short rollout, one train step, one image train
   step and one recurrent train step, by stage;
10. the env-only phase at bench.py's config (cluttered 15x15, 3 agents,
   25 clutter, B = 32768, T = 16 random actions, board pool 256), with
   encode and with image observations;
11. the kernels' times with CUDA events at the rollout's and the update's
   shapes (K3 also at the image env-only shape), beside their bound, their
   plain version's and one PyTorch call's time.

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
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters=50, warmup=5):
    """(device ms, host ms) per call of ``fn``, means over ``iters`` calls.

    Device time: CUDA events around ``iters`` back-to-back calls that the
    host queued while the card was held busy by ``torch.cuda._sleep``, so
    the host's launch cost (Python, checks, ctypes) does not show in it.
    Host time: wall clock per call with the card idle, synchronized at the
    end — what a caller pays per call when the kernel is this small.
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
    # hold the card for about twice the host's queueing time (>= 2 GHz
    # cycles per ns is an overestimate of the clock, so it only lasts longer)
    torch.cuda._sleep(int(2 * host_ms * 1e-3 * iters * 2e9) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters, host_ms


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def kernel_wrappers():
    """Name -> wrapper of every kernel of the port; each wrapper counts its
    launches in ``.launches``."""
    from marlgrid_tpu_torch.ops import embed, embed2, sprite, transpose

    return {"transpose_bk": transpose.transpose_bk,
            "onehot_embed_fwd": embed.onehot_embed,
            "onehot_embed_bwd": embed.onehot_embed_bwd,
            "compose_image_b": sprite.compose_image_b,
            "onehot_embed2_fwd": embed2.onehot_embed2,
            "onehot_embed2_bwd": embed2.onehot_embed2_bwd}


def want_counts(**launches):
    """The launch counts a phase expects: ``launches`` by kernel name, and
    0 for every other kernel of the port."""
    want = dict.fromkeys(kernel_wrappers(), 0)
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
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


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


def phase_embed(palettes):
    from marlgrid_tpu_torch.ops import embed as E

    gen = torch.Generator().manual_seed(1)
    R, cells, S, H = 4, 49, 4096, 128
    worst = 0.0
    for name, pal in (("full", None), ("goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        w = (torch.randn(cells, sum(widths), H, generator=gen) * 0.05).to(
            torch.bfloat16).cuda()
        with torch.no_grad():
            out = E.onehot_embed(x, w, widths, values)
        sync()
        ref = E.onehot_embed_plain(x, w.float(), widths, values,
                                   torch.float32).to(torch.bfloat16)
        err = (out.float() - ref.float()).abs()
        # 1 bf16 ulp of the reference; 2**-20 absolute covers the float32
        # summation-order error where the sum cancels to near zero
        bad = err > bf16_ulp(ref) + 2.0 ** -20
        if out.shape != (R, S, H) or out.dtype != torch.bfloat16 or \
                bad.any():
            raise AssertionError(
                f"K2f ({name}) beyond 1 bf16 ulp at {int(bad.sum())} of "
                f"{bad.numel()} values (max abs err {float(err.max())})")
        worst = max(worst, float(err.max()))
        print(f"[K2f] {name} (R={R}, F={3 * cells}, S={S}, H={H}): max abs "
              f"err {float(err.max()):.3e}, within 1 bf16 ulp")
    return worst


def phase_embed_bwd(palettes):
    """K2b at the update's shape (R = 2048 blocks of S = 128 samples)
    against its plain version on the card. Both read the same bf16 dout
    and sum in float32; only the order of the sums over up to 262,144
    samples differs, so max |err| <= 1e-3 * max |dW|. Two launches on the
    same inputs give the same bits, and the embed's autograd Function
    returns K2b's gradient."""
    from marlgrid_tpu_torch.ops import embed as E

    gen = torch.Generator().manual_seed(2)
    R, cells, S, H = 2048, 49, 128, 128
    worst = 0.0
    for name, pal in (("full", None), ("goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        dout = torch.randn(R, S, H, generator=gen).to(torch.bfloat16).cuda()
        dw = E.onehot_embed_bwd(x, dout, widths, values)
        again = E.onehot_embed_bwd(x, dout, widths, values)
        sync()
        ref = E.onehot_embed_bwd_plain(x, dout, widths, values)
        err = float((dw - ref).abs().max())
        scale = float(ref.abs().max())
        if dw.shape != (cells, sum(widths), H) or dw.dtype != torch.float32 \
                or not err <= 1e-3 * scale:
            raise AssertionError(
                f"K2b ({name}): max abs err {err} beyond 1e-3 of max |dW| "
                f"{scale}, or shape {tuple(dw.shape)} {dw.dtype}")
        if not torch.equal(dw, again):
            raise AssertionError(f"K2b ({name}) differs between two launches")
        w = (torch.randn(cells, sum(widths), H, generator=gen) * 0.05).cuda()
        w.requires_grad_(True)
        n0 = E.onehot_embed_bwd.launches
        (g,) = torch.autograd.grad(E.onehot_embed(x, w, widths, values), w,
                                   dout)
        if E.onehot_embed_bwd.launches != n0 + 1 or not torch.equal(g, dw):
            raise AssertionError(f"K2b ({name}): the autograd Function did "
                                 f"not return K2b's gradient")
        worst = max(worst, err)
        print(f"[K2b] {name} (R={R}, F={3 * cells}, S={S}, H={H}): max abs "
              f"err {err:.3e} of max |dW| {scale:.3e} (tolerance 1e-3 of "
              f"it), deterministic, through the autograd Function")
    return worst


def _tables2(cells, widths, H, gen):
    """Three random float32 per-plane tables (cells, n_p, H) on the card."""
    return [(torch.randn(cells, n, H, generator=gen) * 0.05).cuda()
            for n in widths]


def phase_embed2(palettes):
    """K5f against its plain version on the card at the rollout's shape
    (R = 4, S = 4096) and the update's (R = 2048 rows of S = 128), with the
    full vocabularies and the goal_cycle palette, on codes with state codes
    above 19 and codes outside each vocabulary. Both read the tables as
    bf16 and sum in float32 without rounding the output; only the order of
    the sums differs, so max |err| <= 1e-5 * max |out|."""
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    gen = torch.Generator().manual_seed(3)
    cells, H = 49, 128
    worst = 0.0
    for R, S in ((4, 4096), (2048, 128)):
        for name, pal in (("full", None), ("goal_cycle palette", palettes)):
            widths, values = E.vocab(pal)
            x = _codes(R, cells, S, gen)
            ws = _tables2(cells, widths, H, gen)
            with torch.no_grad():
                out = E2.onehot_embed2(x, *ws, widths, values)
            sync()
            ref = E2.onehot_embed2_plain(x, *ws, widths, values)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if out.shape != (R, S, H) or out.dtype != torch.float32 or \
                    not err <= 1e-5 * scale:
                raise AssertionError(
                    f"K5f ({name}, R={R}, S={S}): max abs err {err} beyond "
                    f"1e-5 of max |out| {scale}, or {tuple(out.shape)} "
                    f"{out.dtype}")
            worst = max(worst, err)
            print(f"[K5f] {name} (R={R}, F={3 * cells}, S={S}, H={H}): max "
                  f"abs err {err:.3e} of max |out| {scale:.3e} (tolerance "
                  f"1e-5 of it)")
            del out, ref
    return worst


def phase_embed2_bwd(palettes):
    """K5b at the update's shape (R = 2048, S = 128) against its plain
    version on the card, both fed the same bf16 dout, per table within
    1e-3 of max |dW_p| (float32 sums over 262,144 samples in another
    order); two launches give the same bits, and the embed2 autograd
    Function returns K5b's gradients."""
    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    gen = torch.Generator().manual_seed(4)
    R, cells, S, H = 2048, 49, 128, 128
    worst = 0.0
    for name, pal in (("full", None), ("goal_cycle palette", palettes)):
        widths, values = E.vocab(pal)
        x = _codes(R, cells, S, gen)
        dout = torch.randn(R, S, H, generator=gen).to(torch.bfloat16).cuda()
        dws = E2.onehot_embed2_bwd(x, dout, widths, values)
        again = E2.onehot_embed2_bwd(x, dout, widths, values)
        sync()
        refs = E2.onehot_embed2_bwd_plain(x, dout, widths, values)
        errs = []
        for p, (dw, ref, n) in enumerate(zip(dws, refs, widths)):
            err = float((dw - ref).abs().max())
            scale = float(ref.abs().max())
            if dw.shape != (cells, n, H) or dw.dtype != torch.float32 or \
                    not err <= 1e-3 * scale:
                raise AssertionError(
                    f"K5b ({name}) table {p}: max abs err {err} beyond 1e-3 "
                    f"of max |dW| {scale}, or {tuple(dw.shape)} {dw.dtype}")
            if not torch.equal(dw, again[p]):
                raise AssertionError(f"K5b ({name}) table {p} differs "
                                     f"between two launches")
            errs.append((err, scale))
        ws = [w.requires_grad_(True) for w in _tables2(cells, widths, H, gen)]
        n0 = E2.onehot_embed2_bwd.launches
        gs = torch.autograd.grad(E2.onehot_embed2(x, *ws, widths, values),
                                 ws, dout.float())
        if E2.onehot_embed2_bwd.launches != n0 + 1 or not all(
                torch.equal(g, dw) for g, dw in zip(gs, dws)):
            raise AssertionError(f"K5b ({name}): the autograd Function did "
                                 f"not return K5b's gradients")
        worst = max([worst] + [e for e, _ in errs])
        print(f"[K5b] {name} (R={R}, F={3 * cells}, S={S}, H={H}): max abs "
              f"err per table "
              f"{', '.join(f'{e:.3e} of {m:.3e}' for e, m in errs)} "
              f"(tolerance 1e-3 of max |dW_p|), deterministic, through the "
              f"autograd Function")
    return worst


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
    standard, (N, B), s2d and (N, B) s2d layouts; then random ids at T = 16
    (tables read through the read-only cache) and T = 5 (single-byte
    stores), the kernel's other two variants."""
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
    for T, vs in ((16, 7), (5, 5)):
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
        pool = step.fresh_pool_tiled(ep, rng.fold_in(key, 7), 8, B)
        acts = rng.randint(rng.fold_in(key, 3), (T, B, 3), 0, 7)
        states, views = [], []
        for t in range(T):
            s, _, _, _ = step.step_autoreset_with_fresh_batch(
                ep, s, acts[t], step.rotate_fresh_batch(pool, t), salt=t)
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


def _train_config(kind, rnn=""):
    """The reference train step's small config (goal_cycle 13x13, 4
    agents, B = 16, T = 8, hidden 32, float32, 2 epochs x 4 minibatches):
    'encode' with the mlp torso and palettes, or 'image' with cnn_s2d;
    feedforward, or recurrent with ``rnn`` 'gru' or 'lstm'."""
    from marlgrid_tpu_torch.core import obs
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   max_steps=12, reward_decay=False, observation_style=kind,
                   agent_colors=default_agent_colors(4))
    if kind == "encode":
        return ep, ppo.PPOConfig(n_envs=16, rollout_len=8, hidden=32,
                                 board_pool=4, dtype=torch.float32, rnn=rnn,
                                 embed_palettes=obs.encode_palettes(ep))
    return ep, ppo.PPOConfig(n_envs=16, rollout_len=8, hidden=32,
                             board_pool=4, dtype=torch.float32,
                             torso="cnn_s2d", rnn=rnn)


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
}


def reference_train(seed, kind, rnn="", plane_major=False):
    """A train step at a small size in float32 (:func:`_train_config`):
    the card's rollout and update, and the CPU's update of the card's
    trajectory (feature-major codes, or the stored EnvStates that the image
    update re-renders) from the same weights and key. (The CPU does not
    roll out itself: a logit that differs by a rounding can flip a sampled
    action.) With ``rnn``, the recurrent step (``ppo_rnn``), its update fed
    the card's stored window carries too; ``plane_major`` builds both nets
    with the plane-major embed (K5f/K5b on the card). The tolerances of
    ``TRAIN_TOL``, per weight tensor:
    every metric within ``metrics``; the first minibatch's gradient within
    ``grad`` of its L2 norm; the weights after the step within ``weights``
    of the step's change in L2 norm (Adam moves a weight by about lr
    whatever the size of its gradient, so a gradient near zero may take
    the other sign). A layout, clip or optimizer fault would miss them by
    far more."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    ep, cfg = _train_config(kind, rnn)
    label = " ".join([kind] + [rnn] * bool(rnn)
                     + ["plane-major"] * plane_major)
    tol = TRAIN_TOL[label]
    devs = {"card": "cuda", "cpu": "cpu"}
    init = ppo_rnn.init_state_rnn if rnn else ppo.init_state
    with embed_v2(plane_major):
        made = {who: init(ep, cfg, torch.Generator().manual_seed(seed),
                          device=dev) for who, dev in devs.items()}
    nets = {who: m[:2] for who, m in made.items()}
    if kind == "encode" and nets["card"][0].torso0.plane_major != plane_major:
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
        first = grads.setdefault(who, {})
        opt.register_step_pre_hook(lambda o, a, k, net=net, first=first: (
            first.update({n: p.grad.detach().cpu().clone()
                          for n, p in net.named_parameters()})
            if not first else None))
        tr = {k: v.map(lambda x: x.to(dev)) if k == "obs" and
              kind == "image" else v.to(dev) for k, v in traj.items()}
        if rnn:
            update = ppo_rnn.make_update_rnn(ep, cfg, net, opt, device=dev)
            m = update(tr, ppo_rnn.map_carry(lambda x: x.to(dev), h0s),
                       last.to(dev), key.to(dev))
        else:
            update = ppo.make_update(ep, cfg, net, opt, device=dev)
            m = update(tr, last.to(dev), key.to(dev))
        ms[who] = {k: float(v) for k, v in m.items()}
        ws[who] = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    merr = max(abs(ms["card"][k] - ms["cpu"][k]) for k in ms["cpu"])
    if not merr <= tol["metrics"]:
        raise AssertionError(f"{label} train step metrics card vs CPU: {ms}")
    gerr = werr = 0.0
    for k, gc in grads["cpu"].items():
        e = float((grads["card"][k] - gc).norm() / gc.norm())
        d = float((ws["card"][k] - ws["cpu"][k]).norm()
                  / (ws["cpu"][k] - w0[k]).norm())
        if not (e <= tol["grad"] and d <= tol["weights"]):
            raise AssertionError(
                f"{label} train step {k}: first gradient {e:.3e} of its norm "
                f"apart, weights {d:.3e} of the step's change apart")
        gerr, werr = max(gerr, e), max(werr, d)
    print(f"[reference] float32 {label} train step ({cfg.torso}, B=16, T=8), "
          f"card vs CPU: metrics max abs err {merr:.3e} (tolerance "
          f"{tol['metrics']:g}); first minibatch's gradients within "
          f"{gerr:.3e} of their L2 norm (tolerance {tol['grad']:g}); weights "
          f"within {werr:.3e} of the step's change (tolerance "
          f"{tol['weights']:g}); loss {ms['card']['loss']:.5f} card, "
          f"{ms['cpu']['loss']:.5f} CPU")


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
        pool = step.fresh_pool_tiled(ep, rng.fold_in(key, 7), 8, B)
        acts = rng.randint(rng.fold_in(key, 3), (T, B, N), 0, 7)
        views = []
        for t in range(T):
            s, _, _, _ = step.step_autoreset_with_fresh_batch(
                ep, s, acts[t], step.rotate_fresh_batch(pool, t), salt=t)
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


def phase_train(seed, card, steps=4):
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
    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda")
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
          f"(want {want})")
    print(f"[train] B={B} T={T}, 2 epochs x 4 minibatches: "
          f"{', '.join(f'{t:.3f}' for t in secs)} s per step; median of "
          f"steps 1-{steps - 1}: {B * T / steady:,.0f} train env-steps/s "
          f"[{card}]")
    return dict(counts=counts, seconds=secs, metrics=metrics,
                env_steps_per_s=B * T / steady, step=step, env=env, key=key,
                ep=ep, cfg=cfg)


def phase_rnn(seed, card, steps=4):
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
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cuda")
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
                key=key, ep=ep, cfg=cfg, net=net)


def phase_rnn_image(seed, card, steps=4):
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
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cuda")
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


def cli_config(*flags):
    """(EnvParams, PPOConfig) that ``python -m
    marlgrid_tpu_torch.parallel.train`` builds from ``flags``: at no flags
    the train path's config (goal_cycle 13x13 with reward_decay off, 4
    agents, 7x7 views, B = 4096, T = 64, hidden 128, mlp torso with the
    palettes, 2 epochs x 4 minibatches, board pool 256); with ``--obs
    image`` the image train path's (8-pixel tiles, the cnn_s2d torso,
    recompute_image_obs, no palettes)."""
    from marlgrid_tpu_torch.parallel import train

    return train.build(train.parse_args(list(flags)))


def phase_image(seed, card, steps=4):
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

    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda")
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
                traj=traj, ep=ep, cfg=cfg)


def phase_cli(card, flags=(), want=None, plane_major=False):
    """The training CLI at its defaults plus ``flags`` (the train path's
    config, the image train path's with ``--obs image``, the recurrent
    one's with ``--rnn gru``) on the card: two iterations with a
    checkpoint, then one more resumed from it, the launch counts read around
    the resumed run (``want``). ``plane_major``: run with
    ``MARLGRID_TPU_EMBED_V2=1``. A ``--rnn`` checkpoint must hold the
    carry of the whole batch, which the resumed run restores."""
    import tempfile

    from marlgrid_tpu_torch.parallel import train
    from marlgrid_tpu_torch.utils import checkpoint

    flags = list(flags)
    with tempfile.TemporaryDirectory() as tmp:
        ck, log = f"{tmp}/ck", f"{tmp}/m.jsonl"
        t0 = time.perf_counter()
        with embed_v2(plane_major):
            train.main(flags + ["--iters", "2", "--metrics", log,
                                "--checkpoint-dir", ck, "--checkpoint-every",
                                "2"])
        first = time.perf_counter() - t0
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
            train.main(flags + ["--iters", "1", "--metrics", log, "--resume",
                                ck])
        counts = read_counts()
        recs += [json.loads(line) for line in open(log)]
    if counts != want:
        raise AssertionError(f"resumed CLI iteration {flags}: launches "
                             f"{counts}, want {want}")
    for r in recs:
        if not (math.isfinite(r["loss"]) and r["n_episodes"] > 0):
            raise AssertionError(f"CLI metrics {r}")
    print(f"[cli] python -m marlgrid_tpu_torch.parallel.train "
          f"{' '.join(flags) or '(defaults)'} (torso "
          f"{config['ppo']['torso']}): 2 iterations + checkpoint in "
          f"{first:.2f} s, then 1 resumed; launches {counts}; "
          f"env_steps_per_s "
          f"{', '.join(format(r['env_steps_per_s'], ',.0f') for r in recs)} "
          f"[{card}]")
    return dict(env_steps_per_s=[r["env_steps_per_s"] for r in recs],
                returns=[r["episode_return"] for r in recs], counts=counts)


def profile_stages(run, prefixes, card, title):
    """Where the time of ``run()`` goes, by stage: torch.profiler over one
    call. Device time is the sum of the kernels' (and copies') durations.
    A kernel counts for the stage label whose span on the card's timeline
    holds its start; a kernel outside every such span (the autograd engine
    launches the backward from its own thread, outside the main thread's
    labels) counts for the label whose span on the host's timeline holds
    its start. Host time is the stage label's span on the host."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_card if not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    out = dict(wall_s=wall, device_busy_s=busy, device_ops=len(kernels),
               stages={}, top={})
    if busy <= 0:
        print(f"[profile] {title}: the profiler saw no device time: not "
              f"measured")
        return out

    def spans_of(evs):
        sp = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in evs if e.name.startswith(prefixes))
        return [x[0] for x in sp], sp

    dev_starts, dev_spans = spans_of(e for e in on_card
                                     if e.is_user_annotation)
    host_events = [e for e in events if e.device_type == DeviceType.CPU]
    host_starts, host_spans = spans_of(host_events)

    def stage_of(t):
        for starts, spans in ((dev_starts, dev_spans),
                              (host_starts, host_spans)):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                return spans[i][2]
        return "(outside the stages)"

    stage = {}
    for e in kernels:
        d = stage.setdefault(stage_of(e.time_range.start), [0.0, 0])
        d[0] += e.time_range.elapsed_us() / 1e3
        d[1] += 1
        top = out["top"].setdefault(e.name[:90], [0.0, 0])
        top[0] += e.time_range.elapsed_us() / 1e3
        top[1] += 1
    host = {}
    for st, en, name in host_spans:
        host[name] = host.get(name, 0.0) + (en - st) / 1e3
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


def phase_profile(roll, train, image, rnn, card, T=8):
    """torch.profiler over a T-step rollout of the rollout path's config,
    over one train step of the train path, one of the image train path and
    one of the recurrent encode train path (``update.cell`` is its update's
    cell loop)."""
    import dataclasses

    from marlgrid_tpu_torch.parallel import ppo

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
    tr = profile_stages(lambda: train["step"](train["env"], train["key"]),
                        ("rollout.", "update."), card,
                        "one train step (B=4096, T=64)")
    im = profile_stages(lambda: image["step"](image["env"], image["key"]),
                        ("rollout.", "update."), card,
                        "one image train step (B=4096, T=64, cnn_s2d)")
    rn = profile_stages(lambda: rnn["step"](rnn["env"], rnn["h"], rnn["key"]),
                        ("rollout.", "update."), card,
                        "one recurrent train step (B=4096, T=64, GRU, "
                        "plane-major embed)")
    return dict(rollout=out, train_step=tr, image_train_step=im,
                rnn_train_step=rn)


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
        fresh = step.fresh_pool_tiled(ep, rng.fold_in(key, 0xF), pool, B)
        acc = torch.zeros((), device="cuda")
        for t in range(T):
            ks = rng.split(key)
            key, ak = ks[0], ks[1]
            a = rng.randint(ak, (B, 3), 0, 7)
            state, rew, done, _ = step.step_autoreset_with_fresh_batch(
                ep, state, a, step.rotate_fresh_batch(fresh, t), salt=t)
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


def _bound(k):
    t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = k["ops"] / F32_OPS_PER_S * 1e3
    k["bound_ms"] = max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


def time_k2f(codes, table, widths, values, where, card):
    """K2f beside its bound, its plain version and embedding_bag(sum) over
    each sample's F row indices (the one-call yardstick)."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E

    R, Fd, S = codes.shape
    cells, cw, H = table.shape
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    with torch.no_grad():
        k = dict(bytes=codes.numel() + table.numel() * 2 + R * S * H * 2,
                 ops=n_valid * H)
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
        kern = E.onehot_embed(codes, table, widths, values)
        gap = float((bag.float() - kern.float()).abs().max())
    _bound(k)
    print(f"[time] K2f at the {where} (R={R}, F={Fd}, S={S}, H={H}, "
          f"palette, {n_valid} of {codes.numel()} codes in the vocabulary):"
          f" {k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"{k['library_ms'] * 1e3:.2f} us (max abs diff to K2f "
          f"{gap:.3e}), bound {k['bound_ms'] * 1e3:.2f} us "
          f"({k['bound_by']}) [{card}]")
    return k


def time_k2b(codes, table, widths, values, card, seed):
    """K2b at the update's shape beside its bound, its plain version and
    the backward of embedding_bag(sum) over the same row indices (timed as
    forward + backward minus forward), with a bf16 dout like the one the
    update gives it."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E

    R, Fd, S = codes.shape
    cells, cw, H = table.shape
    gen = torch.Generator().manual_seed(seed)
    dout = (torch.randn(R, S, H, generator=gen) * 1e-3).to(
        torch.bfloat16).cuda()
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    k = dict(bytes=codes.numel() + dout.numel() * 2 + cells * cw * H * 4,
             ops=n_valid * H)
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
    _bound(k)
    print(f"[time] K2b at the update's shape (R={R}, F={Fd}, S={S}, H={H}, "
          f"palette, {n_valid} codes in the vocabulary): "
          f"{k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"backward {k['library_ms'] * 1e3:.2f} us (forward+backward "
          f"{both_ms * 1e3:.2f} us minus forward {fwd_ms * 1e3:.2f} us; its "
          f"bf16 gradient within {gap:.3e} of K2b's), bound "
          f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}) [{card}]")
    return k


def time_k5f(codes, ws, widths, values, where, card):
    """K5f beside its bound (codes in, bf16 tables in, float32 out; one add
    per in-vocabulary code per hidden unit), its plain version and
    embedding_bag(sum) over each sample's F row indices into the float32
    tables (the one-call yardstick)."""
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E
    from marlgrid_tpu_torch.ops import embed2 as E2

    R, Fd, S = codes.shape
    cells, H = Fd // 3, ws[0].shape[-1]
    cw = sum(widths)
    n_valid, bag_idx = _bag_rows(codes, widths, values, cells, cw)
    with torch.no_grad():
        k = dict(bytes=codes.numel() + cells * cw * H * 2 + R * S * H * 4,
                 ops=n_valid * H)
        k["ms"], k["host_ms"] = time_ms(
            lambda: E2.onehot_embed2(codes, *ws, widths, values))
        k["plain_ms"], _ = time_ms(lambda: E2.onehot_embed2_plain(
            codes, *ws, widths, values), iters=5, warmup=1)
        bag_w = torch.cat([E.pack_weights(*ws).float().reshape(cells * cw, H),
                           torch.zeros(1, H, device="cuda")])
        k["library_ms"], _ = time_ms(
            lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"))
        bag = F.embedding_bag(bag_idx, bag_w, mode="sum").reshape(R, S, H)
        kern = E2.onehot_embed2(codes, *ws, widths, values)
        ref = E2.onehot_embed2_plain(codes, *ws, widths, values)
        k["max_abs_err"] = float((kern - ref).abs().max())
        gap = float((bag - kern).abs().max())
        if not k["max_abs_err"] <= 1e-5 * float(ref.abs().max()):
            raise AssertionError(f"K5f at the {where}: max abs err "
                                 f"{k['max_abs_err']}")
    _bound(k)
    print(f"[time] K5f at the {where} (R={R}, F={Fd}, S={S}, H={H}, "
          f"palette, {n_valid} of {codes.numel()} codes in the vocabulary):"
          f" {k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"{k['library_ms'] * 1e3:.2f} us (float32 tables; max abs diff to "
          f"K5f {gap:.3e}), bound {k['bound_ms'] * 1e3:.2f} us "
          f"({k['bound_by']}) [{card}]")
    return k


def time_k5b(codes, ws, widths, values, card, seed):
    """K5b at the update's shape beside its bound, its plain version and
    the backward of embedding_bag(sum) over the same row indices into the
    float32 tables (forward + backward minus forward), with a bf16 dout."""
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
    k = dict(bytes=codes.numel() + dout.numel() * 2 + cells * cw * H * 4,
             ops=n_valid * H)
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
    kern = E2.onehot_embed2_bwd(codes, dout, widths, values)
    refs = E2.onehot_embed2_bwd_plain(codes, dout, widths, values)
    k["max_abs_err"] = max(float((a - b).abs().max())
                           for a, b in zip(kern, refs))
    if not all(float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
               for a, b in zip(kern, refs)):
        raise AssertionError(f"K5b at the update's shape: max abs err "
                             f"{k['max_abs_err']}")
    _bound(k)
    print(f"[time] K5b at the update's shape (R={R}, F={Fd}, S={S}, H={H}, "
          f"palette, {n_valid} codes in the vocabulary): "
          f"{k['ms'] * 1e3:.2f} us (host {k['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k['plain_ms'] * 1e3:.2f} us, embedding_bag "
          f"backward {k['library_ms'] * 1e3:.2f} us (forward+backward "
          f"{both_ms * 1e3:.2f} us minus forward {fwd_ms * 1e3:.2f} us), "
          f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}) [{card}]")
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
        onehot_embed2_bwd=time_k5b(codes, ws, widths, values, card, seed))


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
    print(f"[time] K3 at the {where} ({N * B} images of {vs * T}x{vs * T}x3,"
          f" {layout}): {k['ms'] * 1e3:.2f} us (host "
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
    k1["plain_ms"], _ = time_ms(lambda: T.transpose_bk_plain(x))
    k1["library_ms"], _ = time_ms(lambda: x.t().contiguous())
    _bound(k1)
    print(f"[time] K1 (4096, 196) int32: {k1['ms'] * 1e3:.2f} us (host "
          f"{k1['host_ms'] * 1e3:.2f} us per call), plain "
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

    from marlgrid_tpu_torch.core import obs
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors

    t_start = time.perf_counter()
    phase_build()
    k1_err = phase_transpose()
    gc = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   observation_style="encode",
                   agent_colors=default_agent_colors(4))
    pals = obs.encode_palettes(gc)
    errs = dict(transpose_bk=k1_err, onehot_embed_fwd=phase_embed(pals),
                onehot_embed_bwd=phase_embed_bwd(pals),
                onehot_embed2_fwd=phase_embed2(pals),
                onehot_embed2_bwd=phase_embed2_bwd(pals),
                compose_image_b=phase_sprite(args.seed))
    phase_reference(args.seed)
    roll = phase_rollout(args.seed, card)
    train = phase_train(args.seed, card)
    cli = phase_cli(card, (), want_counts(
        transpose_bk=65, onehot_embed_fwd=73, onehot_embed_bwd=8))
    image = phase_image(args.seed, card)
    cli_image = phase_cli(card, ("--obs", "image"), want_counts(
        transpose_bk=73, compose_image_b=73))
    rnn = phase_rnn(args.seed, card)
    rnn_image = phase_rnn_image(args.seed, card)
    cli_rnn = phase_cli(card, ("--rnn", "gru"), want_counts(
        transpose_bk=65, onehot_embed2_fwd=73, onehot_embed2_bwd=8),
        plane_major=True)
    prof = phase_profile(roll, train, image, rnn, card)
    env = phase_env_only(args.seed, card)
    env_img = phase_env_only(args.seed, card, "image")
    tim = phase_timings(roll, card, args.seed)
    tim["compose_image_b"] = phase_timings_k3(image, env_img, card,
                                              args.seed)
    tim.update(phase_timings_k5(roll, rnn, card, args.seed))
    # K3's error: the sprite phase's and that of the three timed shapes;
    # K5's: their phases' and that of their timed shapes
    errs["compose_image_b"] = float(max(
        [errs["compose_image_b"]]
        + [k["max_abs_err"] for k in tim["compose_image_b"].values()]))
    errs["onehot_embed2_fwd"] = max(
        errs["onehot_embed2_fwd"], tim["onehot_embed2_fwd"]["max_abs_err"],
        tim["onehot_embed2_fwd_update"]["max_abs_err"])
    errs["onehot_embed2_bwd"] = max(errs["onehot_embed2_bwd"],
                                    tim["onehot_embed2_bwd"]["max_abs_err"])

    # launches: per train step on the train path (K1, K2f, K2b), on the
    # image train path (K3, which runs K1 73 times a step too) and on the
    # recurrent encode path with the plane-major embed (K5f, K5b); K3's and
    # K5f's times are those at the update's shape, where most of their time
    # goes (the other shapes' are in --json)
    kernels = []
    for name, src, line, path in (
            ("transpose_bk", "transpose.cu", "transpose.py:41", train),
            ("onehot_embed_fwd", "embed.cu", "embed.py:245", train),
            ("onehot_embed_bwd", "embed_bwd.cu", "embed.py:264", train),
            ("compose_image_b", "sprite.cu", "sprite.py:280", image),
            ("onehot_embed2_fwd", "embed2.cu", "embed2.py:120", rnn),
            ("onehot_embed2_bwd", "embed2.cu", "embed2.py:149", rnn)):
        k = tim[name]
        if name == "compose_image_b":
            k = k["update"]
        elif name == "onehot_embed2_fwd":
            k = tim["onehot_embed2_fwd_update"]
        kernels.append(dict(
            name=name, route="cuda", source=f"marlgrid_tpu_torch/csrc/{src}",
            replaces=f"marlgrid_tpu/ops/{line}",
            launches=path["counts"][name], max_abs_err=errs[name],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
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
                           cli_image=cli_image,
                           rnn={k: rnn[k] for k in (
                               "counts", "seconds", "metrics", "peak_gb",
                               "env_steps_per_s")},
                           rnn_image=rnn_image, cli_rnn=cli_rnn,
                           env_only={k: env[k] for k in (
                               "env_steps_per_s", "seconds", "counts")},
                           env_only_image={k: env_img[k] for k in (
                               "env_steps_per_s", "seconds", "counts")},
                           profile=prof, timings=tim, total_s=total_s), f,
                      indent=1)
    print(f"[done] all phases passed in {total_s:.1f} s; rollout "
          f"{roll['env_steps_per_s']:,.0f} env-steps/s, train "
          f"{train['env_steps_per_s']:,.0f}, image train "
          f"{image['env_steps_per_s']:,.0f}, recurrent train "
          f"{rnn['env_steps_per_s']:,.0f}, recurrent image train "
          f"{rnn_image['env_steps_per_s']:,.0f}, env-only "
          f"{env['env_steps_per_s']:,.0f}, image env-only "
          f"{env_img['env_steps_per_s']:,.0f} env-steps/s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
