"""The reference's side of the one argument table: a frozen copy of the
train CLI's parser (``marlgrid_tpu_torch/parallel/train.py::parse_args``,
every flag with its default) and of its ``build`` for one policy shared by
the agents. A configuration's ``args`` become one argv
(:func:`cli_flags`) that the program's parser and this one
both read, so every flag reaches both sides or neither: a flag this parser
does not know stops the run, and so does one whose path the reference does
not have (:data:`NOT_FOLLOWED`).
"""
from __future__ import annotations

import argparse
import dataclasses

from .mgref.core import obs as obs_mod
from .mgref.core.state import EnvParams, default_agent_colors
from .mgref.parallel import ppo

#: flags whose path the reference does not have, with the value that keeps
#: a run on the path it has
NOT_FOLLOWED = {"agent_config": None, "overlap": False, "steps_per_call": 1,
                "shard_map": False, "model_shards": 1, "resume": None,
                "distributed": False}


def cli_flags(args: dict, traffic: dict, seed: int) -> list:
    """The train CLI's argv for a configuration's ``args`` at the traffic's
    batch (``envs``, over all ranks) and length. ``stagger`` and
    ``embed_palette`` (default true) map to ``--no-stagger`` and
    ``--no-embed-palette``; any other key ``k`` to ``--k`` (``_`` as
    ``-``) with its value, which the parsers refuse if they do not know
    it."""
    argv = ["--envs", str(traffic["envs"]), "--rollout",
            str(traffic["rollout"]), "--seed", str(seed & 0xFFFFFFFF)]
    for k, v in args.items():
        if k in ("stagger", "embed_palette"):
            if not v:
                argv.append(f"--no-{k.replace('_', '-')}")
        elif v not in ("", None):
            argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def parse_args(argv):
    p = argparse.ArgumentParser(prog="reference")
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
                   choices=["encode", "image", "rich"])
    p.add_argument("--observe", default="")
    p.add_argument("--torso", default=None,
                   choices=["mlp", "cnn", "cnn_image", "cnn_s2d"])
    p.add_argument("--rnn", default="", choices=["", "gru", "lstm"])
    p.add_argument("--bptt-window", type=int, default=0)
    p.add_argument("--agent-config", default=None)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--board-pool", type=int, default=256)
    p.add_argument("--no-stagger", action="store_true")
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--steps-per-call", type=int, default=1)
    p.add_argument("--no-embed-palette", action="store_true")
    p.add_argument("--prestige-beta", type=float, default=None)
    p.add_argument("--prestige-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-shards", type=int, default=1)
    p.add_argument("--metrics", default=None)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--shard-map", action="store_true")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for k, keep in NOT_FOLLOWED.items():
        if getattr(args, k) != keep:
            raise ValueError(f"--{k.replace('_', '-')}: the reference does "
                             f"not follow this path (a loop module of its "
                             f"own would bring its reference)")
    return args


def build(args, dtype):
    """``(EnvParams, PPOConfig)`` from the flags, as the train CLI builds
    them for one shared policy, the policy computing in ``dtype``."""
    torso = args.torso or ("cnn_s2d" if args.obs in ("image", "rich")
                           else "mlp")
    observe = {f.strip() for f in args.observe.split(",") if f.strip()}
    if not observe <= {"rewards", "position", "orientation"}:
        raise ValueError(f"--observe {args.observe!r}")
    ep = EnvParams(
        width=args.grid_size, height=args.grid_size,
        n_agents=args.agents, scenario=args.scenario,
        max_steps=args.max_steps, view_size=args.view_size,
        observation_style=args.obs,
        observe_rewards="rewards" in observe,
        observe_position="position" in observe,
        observe_orientation="orientation" in observe,
        reward_decay=args.scenario != "goal_cycle",
        agent_colors=default_agent_colors(args.agents))
    if args.prestige_beta is not None:
        ep = ep.replace(prestige_beta=args.prestige_beta)
    if args.prestige_scale is not None:
        ep = ep.replace(prestige_scale=args.prestige_scale)
    cfg = ppo.PPOConfig(n_envs=args.envs, rollout_len=args.rollout,
                        lr=args.lr, torso=torso, n_epochs=args.epochs,
                        n_minibatches=args.minibatches, hidden=args.hidden,
                        board_pool=args.board_pool, rnn=args.rnn,
                        bptt_window=args.bptt_window, dtype=dtype)
    if args.obs == "encode" and torso == "mlp" and not args.no_embed_palette:
        pals = obs_mod.encode_palettes(ep)
        if pals is not None:
            cfg = dataclasses.replace(cfg, embed_palettes=pals)
    return ep, cfg
