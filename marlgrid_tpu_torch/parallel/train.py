"""Training entry point of the PyTorch port: PPO on one device, on
'encode' observations with the mlp torso or on 'image'/'rich' observations
with the 'cnn_s2d' (default) or 'cnn_image' torso, feedforward or, with
``--rnn gru|lstm``, recurrent (``parallel/ppo_rnn.py``).

Usage:
    python -m marlgrid_tpu_torch.parallel.train --scenario goal_cycle \
        --grid-size 13 --agents 4 --envs 4096 --iters 100 \
        [--obs image|rich [--torso cnn_image] [--observe rewards,...]] \
        [--rnn gru|lstm [--bptt-window L]] [--device cpu]

``MARLGRID_TPU_EMBED_V2=1`` in the environment routes the mlp torso's embed
through the plane-major kernels (K5f, K5b), as it does for the JAX CLI.

The flags and defaults are those of ``python -m marlgrid_tpu.parallel.train``
plus ``--device`` (default ``cuda``). A flag whose path the port does not
have yet exits with the name of the ROADMAP slice that brings it. The
weights are drawn from ``torch.Generator().manual_seed(--seed)`` (the JAX
CLI draws them from its key); the env batch and the step keys follow the
JAX CLI's key plumbing. Metrics go out as JSONL, one line per logged
iteration, with the JAX CLI's fields; checkpoints are ``utils/checkpoint.py``
directories with the run's ``config.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core import obs as obs_mod, rng
from ..core.state import EnvParams, EnvState, FIELDS, default_agent_colors
from ..device import resolve
from ..utils import checkpoint as ckpt_mod
from ..utils.metrics import MetricsLogger
from . import ppo, ppo_rnn

#: (is it asked for, flag, the ROADMAP slice that brings it) for each flag
#: with no path in the port yet
LATER = (
    (lambda a: a.torso == "cnn", "--torso cnn",
     "Slice C (pixels): the encode cnn torso"),
    (lambda a: a.obs == "encode" and a.torso in ("cnn_image", "cnn_s2d"),
     "--torso cnn_image|cnn_s2d with --obs encode",
     "Slice C (pixels): the row-major obs store"),
    (lambda a: bool(a.agent_config), "--agent-config",
     "Slice E (heterogeneous populations)"),
    (lambda a: a.shard_map, "--shard-map",
     "Slice G (multi-device)"),
    (lambda a: a.distributed, "--distributed",
     "Slice G (multi-device)"),
    (lambda a: a.model_shards != 1, "--model-shards > 1",
     "Slice G (multi-device)"),
    (lambda a: bool(a.profile_dir), "--profile-dir",
     "Slice F (host API and tools)"),
    (lambda a: a.debug_nans, "--debug-nans",
     "Slice F (host API and tools)"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", default="goal_cycle")
    p.add_argument("--grid-size", type=int, default=13)
    p.add_argument("--agents", type=int, default=4)
    p.add_argument("--view-size", type=int, default=7)
    p.add_argument("--max-steps", type=int, default=250)
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--rollout", type=int, default=64)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--obs", default="encode",
                   choices=["encode", "image", "rich"],
                   help="observation style fed to the learner")
    p.add_argument("--observe", default="",
                   help="comma list of rich-obs extra fields: "
                        "rewards,position,orientation")
    p.add_argument("--torso", default=None,
                   choices=["mlp", "cnn", "cnn_image", "cnn_s2d"],
                   help="policy torso (default: mlp for encode obs, "
                        "cnn_s2d for image/rich; the port has no 'cnn')")
    p.add_argument("--rnn", default="", choices=["", "gru", "lstm"],
                   help="recurrent policy cell: sequence-aware PPO with "
                        "env-block minibatches and done-masked hidden state "
                        "(parallel/ppo_rnn.py)")
    p.add_argument("--bptt-window", type=int, default=0,
                   help="truncated-BPTT window for --rnn: chunk the T-step "
                        "sequences into L-step windows (must divide "
                        "--rollout; 0 = full sequences)")
    p.add_argument("--agent-config", default=None,
                   help="JSON list of per-agent kwargs (not in the port "
                        "yet)")
    p.add_argument("--hidden", type=int, default=128,
                   help="policy hidden width (PPOConfig.hidden)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--board-pool", type=int, default=256,
                   help="fresh-board layout pool per rollout (1 = every env "
                        "resetting on a step gets ONE layout)")
    p.add_argument("--no-stagger", action="store_true",
                   help="disable staggered initial episode phases")
    p.add_argument("--overlap", action="store_true",
                   help="double-buffered rollout/update: iteration t's "
                        "update consumes iteration t-1's trajectory "
                        "(optimized one iteration stale)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="train iterations run between logs and checkpoints "
                        "(a Python loop here; metrics then have "
                        "steps-per-call granularity)")
    p.add_argument("--no-embed-palette", action="store_true",
                   help="disable the compact per-scenario one-hot "
                        "vocabularies for the encode embed")
    p.add_argument("--prestige-beta", type=float, default=None,
                   help="per-step decay of the prestige display "
                        "accumulator (default 0.95)")
    p.add_argument("--prestige-scale", type=float, default=None,
                   help="prestige units per sprite dim level (default 2.0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-shards", type=int, default=1)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--log-every", type=int, default=1,
                   help="fetch+print metrics every K iters (fetching waits "
                        "for the device)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not in the port yet)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--shard-map", action="store_true",
                   help="explicit-collective train step (not in the port "
                        "yet)")
    p.add_argument("--profile-dir", default=None,
                   help="profiler trace output dir (not in the port yet)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN (not in the port yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p.parse_args(argv)


def build(args):
    """(EnvParams, PPOConfig) from the flags, as the JAX CLI builds them."""
    for unsupported, flag, slice_ in LATER:
        if unsupported(args):
            raise SystemExit(f"{flag}: not in the PyTorch port yet; it comes "
                             f"with ROADMAP {slice_}")
    if args.bptt_window and not args.rnn:
        raise SystemExit("--bptt-window is a --rnn option")
    if args.bptt_window and args.rollout % args.bptt_window:
        raise SystemExit(f"--bptt-window {args.bptt_window} must divide "
                         f"--rollout {args.rollout}")
    if args.rnn and args.overlap:
        raise SystemExit("--rnn does not compose with --overlap (the "
                         "double-buffered variant is feedforward)")
    torso = args.torso or ("cnn_s2d" if args.obs in ("image", "rich")
                           else "mlp")
    if args.obs != "encode" and torso == "mlp":
        raise SystemExit(f"--obs {args.obs}: the pov is an image; train it "
                         f"with --torso cnn_s2d or cnn_image")
    observe = {f.strip() for f in args.observe.split(",") if f.strip()}
    if not observe <= {"rewards", "position", "orientation"}:
        raise SystemExit(
            f"--observe: unknown field(s) "
            f"{sorted(observe - {'rewards', 'position', 'orientation'})} "
            f"(valid: rewards,position,orientation)")
    ep = EnvParams(
        width=args.grid_size, height=args.grid_size, n_agents=args.agents,
        scenario=args.scenario, max_steps=args.max_steps,
        view_size=args.view_size, observation_style=args.obs,
        observe_rewards="rewards" in observe,
        observe_position="position" in observe,
        observe_orientation="orientation" in observe,
        reward_decay=args.scenario != "goal_cycle",
        agent_colors=default_agent_colors(args.agents))
    if args.prestige_beta is not None:
        ep = ep.replace(prestige_beta=args.prestige_beta)
    if args.prestige_scale is not None:
        ep = ep.replace(prestige_scale=args.prestige_scale)
    if observe and args.obs != "rich":
        print(f"warning: --observe {args.observe!r} is consumed by the "
              f"'rich' observation style only; --obs {args.obs} trains "
              f"WITHOUT these features (use --obs rich)", flush=True)
    cfg = ppo.PPOConfig(n_envs=args.envs, rollout_len=args.rollout,
                        lr=args.lr, torso=torso, n_epochs=args.epochs,
                        n_minibatches=args.minibatches, hidden=args.hidden,
                        board_pool=args.board_pool, rnn=args.rnn,
                        bptt_window=args.bptt_window)
    if args.resume and not args.no_embed_palette:
        # the weights' shapes must match the checkpoint's vocabularies
        ck_cfg = ckpt_mod.load_config(args.resume)
        if ck_cfg is None or ck_cfg.get("ppo", {}).get(
                "embed_palettes") is None:
            args.no_embed_palette = True
    if args.obs == "encode" and torso == "mlp" and not args.no_embed_palette:
        pals = obs_mod.encode_palettes(ep)
        if pals is not None:
            cfg = dataclasses.replace(cfg, embed_palettes=pals)
    return ep, cfg


def main(argv=None):
    args = parse_args(argv)
    ep, cfg = build(args)
    dev = resolve(args.device)
    key = rng.PRNGKey(args.seed, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    h = None
    if cfg.rnn:
        net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, gen, device=dev)
    else:
        net, opt = ppo.init_state(ep, cfg, gen, device=dev)
    env_state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                                   stagger=not args.no_stagger, device=dev)
    key = rng.fold_in(key, 2)
    if args.resume:
        # load on the CPU: load_state_dict moves each tensor where it
        # belongs (Adam keeps its step counts on the CPU)
        tree = ckpt_mod.restore(args.resume, map_location="cpu")
        net.load_state_dict(tree["net"])
        opt.load_state_dict(tree["opt"])
        if "env_state" in tree and "key" in tree:
            env_state = EnvState(**tree["env_state"]).map(
                lambda t: t.to(dev))
            key = tree["key"].to(dev)
            if h is not None and "h" in tree:
                h = ppo_rnn.map_carry(lambda t: t.to(dev), tree["h"])
        else:
            print("warning: the checkpoint holds no env state and key"
                  + (" or carry" if h is not None else "")
                  + "; they restart fresh", flush=True)

    spc = max(1, args.steps_per_call)
    prev = None
    if cfg.rnn:
        step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device=dev)
        if spc > 1:
            step = ppo_rnn.multi_step_rnn(step, spc)
    elif args.overlap:
        step, prime = ppo.make_train_step(ep, cfg, net, opt, device=dev,
                                          overlap=True)
        env_state, prev, key = prime(env_state, key)
    else:
        step = ppo.make_train_step(ep, cfg, net, opt, device=dev)
    log = MetricsLogger(args.metrics)
    run_config = dict(format=1, env_params=ep.to_dict(),
                      ppo=ppo.ppo_config_to_dict(cfg))

    env_steps_per_iter = cfg.n_envs * cfg.rollout_len * spc
    n_calls = max(1, args.iters // spc)
    if n_calls * spc != args.iters:
        print(f"warning: --iters {args.iters} is not a multiple of "
              f"--steps-per-call {spc}; running {n_calls * spc} iterations "
              f"({n_calls} calls)", flush=True)
    t0 = time.time()
    last_logged = -1
    for it in range(n_calls):
        if cfg.rnn:
            env_state, h, key, metrics = step(env_state, h, key)
        else:
            for _ in range(spc):
                if args.overlap:
                    env_state, prev, key, metrics = step(env_state, prev,
                                                         key)
                else:
                    env_state, key, metrics = step(env_state, key)
        if (it + 1) % args.log_every == 0 or it == n_calls - 1:
            metrics = {k: float(v) for k, v in metrics.items()}
            n_it = it - last_logged
            last_logged = it
            dt = (time.time() - t0) / n_it
            t0 = time.time()
            log.log((it + 1) * spc - 1,
                    env_steps=(it + 1) * env_steps_per_iter,
                    env_steps_per_s=env_steps_per_iter / dt,
                    agent_steps_per_s=env_steps_per_iter * ep.n_agents / dt,
                    **metrics)
        if (args.checkpoint_dir and args.checkpoint_every
                and (it + 1) % args.checkpoint_every == 0):
            payload = dict(net=net.state_dict(), opt=opt.state_dict(),
                           env_state={f: getattr(env_state, f)
                                      for f in FIELDS},
                           key=key)
            if h is not None:
                payload["h"] = h
            ckpt_mod.save(args.checkpoint_dir, payload, step=it + 1,
                          config=run_config)
    log.close()
    return net


if __name__ == "__main__":
    main()
