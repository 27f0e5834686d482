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
   through the embed's autograd Function;
4. the env engine and the observations on the card against the same code
   on the CPU (which the tests hold bit-equal to the JAX package), the
   policy's logits on the card against the CPU's, and a small float32
   train step: the card's rollout and update against the CPU's update of
   the same trajectory from the same weights;
5. the rollout path: a PPO rollout at the train default's full width
   (goal_cycle 13x13, 4 agents, 7x7 encode, B = 4096, T = 64, hidden 128,
   board pool 256, stagger, the compact embed palettes) through
   ``make_rollout``, with the launch counts of K1 and K2f read around it;
6. the train path: ``make_train_step`` at the same width (2 epochs x 4
   minibatches), four train steps, with the launch counts of K1, K2f and
   K2b read around each (65 / 73 / 8) and train env-steps/s; then the
   training CLI at its defaults, two iterations with a checkpoint and one
   resumed from it;
7. torch.profiler over a short rollout and over one train step, by stage;
8. the env-only phase at bench.py's config (cluttered 15x15, 3 agents,
   25 clutter, B = 32768, T = 16 random actions, board pool 256);
9. the kernels' times with CUDA events at the rollout's and the update's
   shapes, beside their bound, their plain version's and one PyTorch
   call's time.

The last lines of standard output are the card's name and power limit, a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
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
    reference_train(seed)


def reference_train(seed):
    """A train step at a small size in float32 (goal_cycle 13x13, 4 agents,
    B = 16, T = 8, hidden 32, palettes, 2 epochs x 4 minibatches): the
    card's rollout and update, and the CPU's update of the card's
    trajectory from the same weights and key. (The CPU does not roll out
    itself: a logit that differs by a bf16 rounding can flip a sampled
    action.) On the card K2f reads the table and writes its output in
    bf16 and K2b reads dout in bf16, where the CPU stays in float32. A
    hidden unit whose input sits within that rounding of zero takes the
    other side of its ReLU, which changes a whole dout entry: on an H100
    the first minibatch's embed gradient differed by 4 % of its max.
    So the tolerances, per weight tensor: every metric within 1e-2; the
    first minibatch's gradient within 0.15 of its L2 norm; the weights
    after the step within 0.3 of the step's change in L2 norm (Adam moves
    a weight by about lr whatever the size of its gradient, so a gradient
    near zero may take the other sign). A layout, clip or optimizer fault
    would miss them by far more."""
    from marlgrid_tpu_torch.core import obs, rng
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   max_steps=12, reward_decay=False,
                   observation_style="encode",
                   agent_colors=default_agent_colors(4))
    cfg = ppo.PPOConfig(n_envs=16, rollout_len=8, hidden=32, board_pool=4,
                        dtype=torch.float32,
                        embed_palettes=obs.encode_palettes(ep))
    devs = {"card": "cuda", "cpu": "cpu"}
    nets = {who: ppo.init_state(ep, cfg, torch.Generator().manual_seed(seed),
                                device=dev) for who, dev in devs.items()}
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             device="cuda")
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
        update = ppo.make_update(ep, cfg, net, opt, device=dev)
        m = update({k: v.to(dev) for k, v in traj.items()}, last.to(dev),
                   key.to(dev))
        ms[who] = {k: float(v) for k, v in m.items()}
        ws[who] = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    merr = max(abs(ms["card"][k] - ms["cpu"][k]) for k in ms["cpu"])
    if not merr <= 1e-2:
        raise AssertionError(f"train step metrics card vs CPU: {ms}")
    gerr = werr = 0.0
    for k, gc in grads["cpu"].items():
        e = float((grads["card"][k] - gc).norm() / gc.norm())
        d = float((ws["card"][k] - ws["cpu"][k]).norm()
                  / (ws["cpu"][k] - w0[k]).norm())
        if not (e <= 0.15 and d <= 0.3):
            raise AssertionError(
                f"train step {k}: first gradient {e:.3e} of its norm apart, "
                f"weights {d:.3e} of the step's change apart")
        gerr, werr = max(gerr, e), max(werr, d)
    print(f"[reference] float32 train step (B=16, T=8), card vs CPU: "
          f"metrics max abs err {merr:.3e} (tolerance 1e-2); first "
          f"minibatch's gradients within {gerr:.3e} of their L2 norm "
          f"(tolerance 0.15); weights within {werr:.3e} of the step's "
          f"change (tolerance 0.3); loss {ms['card']['loss']:.5f} card, "
          f"{ms['cpu']['loss']:.5f} CPU")


def phase_rollout(seed, card):
    from marlgrid_tpu_torch.core import obs, rng
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.models import ActorCritic
    from marlgrid_tpu_torch.ops import embed, transpose
    from marlgrid_tpu_torch.parallel import ppo

    # python -m marlgrid_tpu.parallel.train's defaults (train.py:28-71 and
    # :194-253): goal_cycle gets reward_decay=False and the palettes
    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   max_steps=250, view_size=7, observation_style="encode",
                   reward_decay=False, agent_colors=default_agent_colors(4))
    pals = obs.encode_palettes(ep)
    cfg = ppo.PPOConfig(n_envs=4096, rollout_len=64, hidden=128,
                        board_pool=256, embed_palettes=pals)
    B, T, N = cfg.n_envs, cfg.rollout_len, ep.n_agents
    net = ActorCritic(cfg, ep.view_size, torch.Generator().manual_seed(seed),
                      device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    rollout = ppo.make_rollout(ep, cfg, net, device="cuda")
    sync()

    transpose.transpose_bk.launches = 0
    embed.onehot_embed.launches = 0
    t0 = time.perf_counter()
    env, key2, traj, last = rollout(env, rng.fold_in(key, 2))
    sync()
    dt = time.perf_counter() - t0
    counts = {"transpose_bk": transpose.transpose_bk.launches,
              "onehot_embed_fwd": embed.onehot_embed.launches}
    print(f"[rollout] launches on the main path: {counts} "
          f"(want {T + 1} each)")
    for name, n in counts.items():
        if n != T + 1:
            raise AssertionError(f"{name}: {n} launches, want {T + 1}")

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
    """The train path at the rollout phase's full width: ``make_train_step``
    (rollout + 2 epochs x 4 minibatches of 2048 blocks of 128 samples),
    ``steps`` calls, the launch counts read around each call."""
    from marlgrid_tpu_torch.core import obs, rng
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.ops import embed, transpose
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   max_steps=250, view_size=7, observation_style="encode",
                   reward_decay=False, agent_colors=default_agent_colors(4))
    cfg = ppo.PPOConfig(n_envs=4096, rollout_len=64, hidden=128,
                        board_pool=256, embed_palettes=obs.encode_palettes(ep))
    B, T = cfg.n_envs, cfg.rollout_len
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(seed),
                              device="cuda")
    key = rng.PRNGKey(seed, device="cuda")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), stagger=True,
                             device="cuda")
    key = rng.fold_in(key, 2)
    step = ppo.make_train_step(ep, cfg, net, opt, device="cuda")
    w0 = [p.detach().clone() for p in net.parameters()]
    want = {"transpose_bk": T + 1,
            "onehot_embed_fwd": T + 1 + cfg.n_epochs * cfg.n_minibatches,
            "onehot_embed_bwd": cfg.n_epochs * cfg.n_minibatches}
    secs, metrics = [], []
    for i in range(steps):
        sync()
        transpose.transpose_bk.launches = 0
        embed.onehot_embed.launches = 0
        embed.onehot_embed_bwd.launches = 0
        t0 = time.perf_counter()
        env, key, m = step(env, key)
        sync()
        secs.append(time.perf_counter() - t0)
        counts = {"transpose_bk": transpose.transpose_bk.launches,
                  "onehot_embed_fwd": embed.onehot_embed.launches,
                  "onehot_embed_bwd": embed.onehot_embed_bwd.launches}
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


def phase_cli(card):
    """The training CLI at its defaults (the train path's config) on the
    card: two iterations with a checkpoint, then one more resumed from it,
    the launch counts read around the resumed run."""
    import tempfile

    from marlgrid_tpu_torch.ops import embed, transpose
    from marlgrid_tpu_torch.parallel import train
    from marlgrid_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ck, log = f"{tmp}/ck", f"{tmp}/m.jsonl"
        t0 = time.perf_counter()
        train.main(["--iters", "2", "--metrics", log, "--checkpoint-dir", ck,
                    "--checkpoint-every", "2"])
        first = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(log)]
        if checkpoint.steps(ck) != [2] or \
                checkpoint.load_config(ck)["ppo"]["n_envs"] != 4096:
            raise AssertionError("the CLI wrote no full-width checkpoint")
        transpose.transpose_bk.launches = 0
        embed.onehot_embed.launches = 0
        embed.onehot_embed_bwd.launches = 0
        train.main(["--iters", "1", "--metrics", log, "--resume", ck])
        counts = (transpose.transpose_bk.launches,
                  embed.onehot_embed.launches,
                  embed.onehot_embed_bwd.launches)
        recs += [json.loads(line) for line in open(log)]
    if counts != (65, 73, 8):
        raise AssertionError(f"resumed CLI iteration: launches {counts}, "
                             f"want (65, 73, 8)")
    for r in recs:
        if not (math.isfinite(r["loss"]) and r["n_episodes"] > 0):
            raise AssertionError(f"CLI metrics {r}")
    print(f"[cli] python -m marlgrid_tpu_torch.parallel.train (defaults): 2 "
          f"iterations + checkpoint in {first:.2f} s, then 1 resumed; "
          f"launches K1/K2f/K2b {counts}; env_steps_per_s "
          f"{', '.join(format(r['env_steps_per_s'], ',.0f') for r in recs)} "
          f"[{card}]")


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


def phase_profile(roll, train, card, T=8):
    """torch.profiler over a T-step rollout of the rollout path's config,
    and over one train step of the train path."""
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
    return dict(rollout=out, train_step=tr)


def phase_env_only(seed, card):
    from marlgrid_tpu_torch.core import grid_gen, obs, rng, step
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.ops import transpose

    # bench.py's config (build_params, main's defaults)
    ep = EnvParams(width=15, height=15, n_agents=3, scenario="cluttered",
                   n_clutter=25, max_steps=250, view_size=7,
                   observation_style="encode",
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
            acc = acc + rew.sum() + o.float().mean()
        return state, key, acc

    state, key, acc = run(state, key)          # warm-up
    sync()
    reps = []
    for _ in range(3):
        transpose.transpose_bk.launches = 0
        t0 = time.perf_counter()
        state, key, acc = run(state, key)
        checksum = float(acc)
        reps.append(time.perf_counter() - t0)
        n = transpose.transpose_bk.launches
        if n != T:
            raise AssertionError(f"env-only phase: {n} K1 launches, "
                                 f"want {T}")
        if checksum != checksum or abs(checksum) == float("inf"):
            raise AssertionError("env-only checksum is not finite")
    dt = sorted(reps)[1]
    print(f"[env] cluttered 15x15, 3 agents, B={B}, T={T}, pool {pool}: "
          f"{', '.join(f'{r:.3f}' for r in reps)} s; median "
          f"{B * T / dt:,.0f} env-steps/s, K1 launches {n} per run "
          f"[{card}]")
    return dict(env_steps_per_s=B * T / dt, seconds=reps, k1_launches=n)


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
                onehot_embed_bwd=phase_embed_bwd(pals))
    phase_reference(args.seed)
    roll = phase_rollout(args.seed, card)
    train = phase_train(args.seed, card)
    phase_cli(card)
    prof = phase_profile(roll, train, card)
    env = phase_env_only(args.seed, card)
    tim = phase_timings(roll, card, args.seed)

    # launches: per train step on the train path, which runs every kernel
    # (the rollout path's counts, K1 and K2f 65 each, are in --json)
    kernels = []
    for name, src, line in (
            ("transpose_bk", "transpose.cu", "transpose.py:41"),
            ("onehot_embed_fwd", "embed.cu", "embed.py:245"),
            ("onehot_embed_bwd", "embed_bwd.cu", "embed.py:264")):
        k = tim[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"marlgrid_tpu_torch/csrc/{src}",
            replaces=f"marlgrid_tpu/ops/{line}",
            launches=train["counts"][name], max_abs_err=errs[name],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, kernels=kernels,
                           rollout_counts=roll["counts"],
                           rollout_env_steps_per_s=roll["env_steps_per_s"],
                           rollout_first_call_s=roll["first_s"],
                           rollout_call_s=roll["steady_s"],
                           train_env_steps_per_s=train["env_steps_per_s"],
                           train_step_s=train["seconds"],
                           train_metrics=train["metrics"],
                           env_only=env, profile=prof, timings=tim,
                           total_s=time.perf_counter() - t_start), f,
                      indent=1)
    print(f"[done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s; rollout "
          f"{roll['env_steps_per_s']:,.0f} env-steps/s, train "
          f"{train['env_steps_per_s']:,.0f} env-steps/s, env-only "
          f"{env['env_steps_per_s']:,.0f} env-steps/s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
