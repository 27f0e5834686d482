#!/usr/bin/env python3
"""Smoke run of the PyTorch port (marlgrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--json PATH]

Needs one CUDA card (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports nothing of JAX. Phases, each raising on failure:

1. build every kernel from marlgrid_tpu_torch/csrc/ (one nvcc per source,
   in parallel) and print the build seconds and ptxas' report;
2. K1 (transpose_bk) against its plain version, bit-exact;
3. K2f (onehot_embed forward) against its plain version computed in
   float32 and rounded to bf16, within 1 bf16 ulp;
4. the env engine and the observations on the card against the same code
   on the CPU (which the tests hold bit-equal to the JAX package), and the
   policy's logits on the card against the CPU's;
5. the main path: a PPO rollout at the train default's full width
   (goal_cycle 13x13, 4 agents, 7x7 encode, B = 4096, T = 64, hidden 128,
   board pool 256, stagger, the compact embed palettes) through
   ``make_rollout``, with the launch counts of both kernels read around it;
6. the env-only phase at bench.py's config (cluttered 15x15, 3 agents,
   25 clutter, B = 32768, T = 16 random actions, board pool 256);
7. the kernels' times with CUDA events at the rollout's shapes, beside
   their bound, their plain version's and one PyTorch call's time.

The last lines of standard output are the card's name and power limit, a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
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
    w.requires_grad_(True)
    try:
        E.onehot_embed(x, w, widths, values)
    except NotImplementedError:
        print("[K2f] a table that needs a gradient raises, as it must")
    else:
        raise AssertionError("K2f ran with a table that needs a gradient")
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
                obs=traj2["obs"][-1].contiguous(), net=net, ep=ep, cfg=cfg,
                env=env, key=key2)


def phase_profile(roll, card, T=8):
    """Where a rollout step's time goes: torch.profiler over a T-step
    rollout of the main path's config. Device time is the sum of the
    kernels' (and copies') durations, each assigned to the rollout stage
    label whose span on the card's timeline holds its start; host time is
    the stage label's span on the host."""
    import bisect
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from marlgrid_tpu_torch.parallel import ppo

    cfg = dataclasses.replace(roll["cfg"], rollout_len=T)
    rollout = ppo.make_rollout(roll["ep"], cfg, roll["net"], device="cuda")
    rollout(roll["env"], roll["key"])                  # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(roll["env"], roll["key"])
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in on_card if e.is_user_annotation)
    kernels = [e for e in on_card if not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    out = dict(T=T, wall_s=wall, device_busy_s=busy,
               device_ops_per_step=len(kernels) / T, stages={}, top={})
    if busy <= 0:
        print("[profile] the profiler saw no device time: not measured")
        return out
    print(f"[profile] T={T} rollout: wall {wall * 1e3:.1f} ms, kernels "
          f"busy {busy * 1e3:.1f} ms (device idle share "
          f"{1 - busy / wall:.3f}), {len(kernels) / T:.0f} device ops per "
          f"step [{card}]")
    starts = [sp[0] for sp in spans]
    stage = {}
    for e in kernels:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        name = spans[i][2] if i >= 0 and e.time_range.start <= \
            spans[i][1] else "(outside the stages)"
        d = stage.setdefault(name, [0.0, 0])
        d[0] += e.time_range.elapsed_us() / 1e3
        d[1] += 1
        top = out["top"].setdefault(e.name[:90], [0.0, 0])
        top[0] += e.time_range.elapsed_us() / 1e3
        top[1] += 1
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(
                "rollout."):
            host[e.name] = host.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    for name in sorted(set(stage) | set(host)):
        dev_ms, n = stage.get(name, (0.0, 0))
        out["stages"][name] = dict(host_ms=host.get(name, 0.0),
                                   device_ms=dev_ms, device_ops=n)
        print(f"[profile]   {name:22s} host {host.get(name, 0.0):8.2f} ms,"
              f" device {dev_ms:7.2f} ms in {n:6d} ops")
    for name, (ms, n) in sorted(out["top"].items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   device {ms:7.2f} ms x{n:5d}  {name[:70]}")
    return out


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


def phase_timings(roll, card):
    import torch.nn.functional as F

    from marlgrid_tpu_torch.ops import embed as E, transpose as T

    # K1 at the rollout's shape: (B, K) = (4096, 4 * 49)
    x = torch.randint(0, 2 ** 20, (4096, 196), dtype=torch.int32,
                      device="cuda")
    k1 = dict(bytes=2 * x.numel() * 4, ops=0)
    k1["ms"], k1["host_ms"] = time_ms(lambda: T.transpose_bk(x))
    k1["plain_ms"], _ = time_ms(lambda: T.transpose_bk_plain(x))
    k1["library_ms"], _ = time_ms(lambda: x.t().contiguous())

    # K2f on the rollout's last observation with the rollout's weights
    net = roll["net"]
    codes = roll["obs"]                                  # (4, 147, 4096)
    emb = net.torso0
    table = emb.table().detach().to(torch.bfloat16).contiguous()
    widths, values = emb.widths, emb.values
    R, Fd, S = codes.shape
    cells, cw, H = table.shape
    lut = torch.as_tensor(E.slot_table(widths, values), device="cuda").long()
    plane = torch.arange(Fd, device="cuda") // cells
    slot = lut[plane[None, :, None], codes.long()]       # (R, F, S)
    n_valid = int((slot >= 0).sum())
    with torch.no_grad():
        k2 = dict(bytes=codes.numel() + table.numel() * 2 + R * S * H * 2,
                  ops=n_valid * H)
        k2["ms"], k2["host_ms"] = time_ms(
            lambda: E.onehot_embed(codes, table, widths, values))
        k2["plain_ms"], _ = time_ms(lambda: E.onehot_embed_plain(
            codes, table, widths, values, torch.bfloat16), iters=10)
        # the one-call yardstick: embedding_bag(sum) over each sample's 147
        # row indices into the flattened table, a zero row for "no row"
        cell = torch.arange(Fd, device="cuda") % cells
        rows = torch.where(slot >= 0, cell[None, :, None] * cw + slot,
                           cells * cw)
        bag_idx = rows.permute(0, 2, 1).reshape(R * S, Fd).contiguous()
        bag_w = torch.cat([table.reshape(cells * cw, H),
                           torch.zeros(1, H, dtype=table.dtype,
                                       device="cuda")])
        k2["library_ms"], _ = time_ms(
            lambda: F.embedding_bag(bag_idx, bag_w, mode="sum"))
        bag = F.embedding_bag(bag_idx, bag_w, mode="sum").reshape(R, S, H)
        kern = E.onehot_embed(codes, table, widths, values)
        gap = float((bag.float() - kern.float()).abs().max())
        print(f"[time] embedding_bag vs K2f on the rollout's obs: max abs "
              f"diff {gap:.3e} ({n_valid} of {slot.numel()} codes in "
              f"the vocabulary)")
    for k in (k1, k2):
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / F32_OPS_PER_S * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print("[time] device time per call (launches queued behind a busy "
          "card); host time per call with the card idle")
    print(f"[time] K1 (4096, 196) int32: {k1['ms'] * 1e3:.2f} us (host "
          f"{k1['host_ms'] * 1e3:.2f} us per call), plain "
          f"{k1['plain_ms'] * 1e3:.2f} us, x.t().contiguous() "
          f"{k1['library_ms'] * 1e3:.2f} us, bound "
          f"{k1['bound_ms'] * 1e3:.2f} us ({k1['bound_by']}) [{card}]")
    print(f"[time] K2f (R={R}, F={Fd}, S={S}, H={H}, palette): "
          f"{k2['ms'] * 1e3:.2f} us (host {k2['host_ms'] * 1e3:.2f} us per "
          f"call), plain {k2['plain_ms'] * 1e3:.2f} us, "
          f"embedding_bag {k2['library_ms'] * 1e3:.2f} us, bound "
          f"{k2['bound_ms'] * 1e3:.2f} us ({k2['bound_by']}) [{card}]")
    return k1, k2


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
    k2_err = phase_embed(obs.encode_palettes(gc))
    phase_reference(args.seed)
    roll = phase_rollout(args.seed, card)
    prof = phase_profile(roll, card)
    env = phase_env_only(args.seed, card)
    k1, k2 = phase_timings(roll, card)

    kernels = [
        dict(name="transpose_bk", route="cuda",
             source="marlgrid_tpu_torch/csrc/transpose.cu",
             replaces="marlgrid_tpu/ops/transpose.py:41",
             launches=roll["counts"]["transpose_bk"], max_abs_err=k1_err,
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"]),
        dict(name="onehot_embed_fwd", route="cuda",
             source="marlgrid_tpu_torch/csrc/embed.cu",
             replaces="marlgrid_tpu/ops/embed.py:245",
             launches=roll["counts"]["onehot_embed_fwd"], max_abs_err=k2_err,
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"]),
    ]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, kernels=kernels,
                           rollout_env_steps_per_s=roll["env_steps_per_s"],
                           rollout_first_call_s=roll["first_s"],
                           rollout_call_s=roll["steady_s"],
                           env_only=env, profile=prof,
                           timings=dict(transpose_bk=k1,
                                        onehot_embed_fwd=k2),
                           total_s=time.perf_counter() - t_start), f,
                      indent=1)
    print(f"[done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s; rollout "
          f"{roll['env_steps_per_s']:,.0f} env-steps/s, env-only "
          f"{env['env_steps_per_s']:,.0f} env-steps/s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
