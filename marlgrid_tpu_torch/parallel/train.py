"""Training entry point of the PyTorch port: PPO on one device, on
'encode' observations with the mlp torso or on 'image'/'rich' observations
with the 'cnn_s2d' (default) or 'cnn_image' torso, feedforward or, with
``--rnn gru|lstm``, recurrent (``parallel/ppo_rnn.py``). With
``--agent-config`` (a JSON list of per-agent ``GridAgentInterface`` kwargs)
the agents that share an observation config form a group with its own
policy: all-encode groups train through ``parallel/ppo_hetero.py`` (with
``--rnn``, ``ppo_hetero_rnn.py``), groups of mixed styles through
``ppo_hetero_mixed.py``.

Usage:
    python -m marlgrid_tpu_torch.parallel.train --scenario goal_cycle \
        --grid-size 13 --agents 4 --envs 4096 --iters 100 \
        [--obs image|rich [--torso cnn_image] [--observe rewards,...]] \
        [--rnn gru|lstm [--bptt-window L]] \
        [--agent-config '[{"view_size":7},{"view_size":5}]'] [--device cpu]

    # data-parallel over ranks, one process a card (the sharded default
    # path; --shard-map for the explicit-collective step; --model-shards N
    # lays the K ranks out as a (K / N, N) mesh):
    torchrun --nproc-per-node K -m marlgrid_tpu_torch.parallel.train \
        --distributed [--shard-map] [--rnn gru] [--model-shards N] ...

``MARLGRID_TPU_EMBED_V2=1`` in the environment routes the mlp torso's embed
through the plane-major kernels (K5f, K5b), as it does for the JAX CLI.

On the card a train call replays one CUDA graph of the whole step, wired as
the JAX CLI wires its jitted steps (:func:`make_call`): the trainer's
``make_train_step*(..., jit=True)`` for one step per call, ``ppo.multi_step``
(``ppo_rnn.multi_step_rnn``, ``ppo.multi_step_overlap``) of the raw step for
``--steps-per-call k``, the captured step replayed k times. The first call
runs eagerly and the second captures. ``--profile-dir`` traces calls 2-4 as
they run, graph replays on the card: the capture remembers which graph
nodes each ``rollout.*`` / ``update.*`` stage added, and the trace, its
stage maps and ``utils/profiling.py::hotspots`` read the replays by stage.

The flags and defaults are those of ``python -m marlgrid_tpu.parallel.train``
plus ``--device`` (default ``cuda``). The
weights are drawn from ``torch.Generator().manual_seed(--seed)`` (the JAX
CLI draws them from its key); the env batch and the step keys follow the
JAX CLI's key plumbing. Metrics go out as JSONL, one line per logged
iteration, with the JAX CLI's fields; checkpoints are ``utils/checkpoint.py``
directories with the run's ``config.json``.

``--distributed`` makes one rank per process (``mesh.init_distributed``:
NCCL on the card, gloo on the CPU; ``--coordinator host:port`` with
``--num-processes`` and ``--process-id``, or torchrun's variables), and a
run trains over ``parallel/mesh.py``'s data axis of all of them, as the
JAX CLI trains over its mesh: feedforward (``--overlap`` too), recurrent
(image and rich obs too) and hetero populations (``--agent-config``) on
the sharded default path, ``ppo.make_train_step(mesh=...)``,
``ppo_rnn.make_train_step_rnn(mesh=...)`` and the hetero trainers'
``make_train_step_hetero*(mesh=...)``, which compute the unsharded step
of the global batch.
``--shard-map`` trains with ``ppo.make_train_step_shard_map`` (with
``--rnn``, ``ppo_rnn.make_train_step_rnn_shard_map``) instead: D = 1 in
one process, or one rank per process under ``--distributed``. On either,
every rank draws the weights from ``--seed`` and takes rank 0's, with its
optimizer state, through ``mesh.broadcast_from`` (the counterpart of the
JAX CLI's replicated ``device_put``); each rank logs the same metrics to
its own ``--metrics``; rank 0 writes the checkpoints, the env state (and
``h``) gathered in global env order, so a checkpoint holds the global
batch and ``--resume`` slices it for any D that divides ``--envs``.

``--model-shards N`` lays the ranks out as ``parallel/mesh.py``'s (world /
N, N) ('data', 'model') mesh, as the JAX CLI's ``make_mesh(n_model=N)``
does: the data axis is world / N ranks, and the N ranks of a model group
hold the same env slice and repeat one another's work, the learner state
being replicated over the whole mesh (the JAX CLI commits it to ``P()``;
the CLI applies no tensor parallelism). A world size that N does not
divide (one process, without ``--distributed``) exits with JAX's
``make_mesh`` message, before any process group is made where the world
size is known (``--num-processes``, or torchrun's ``WORLD_SIZE``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..agents import GridAgentInterface, agents_to_params_fields
from ..core import constants as C, obs as obs_mod, rng
from ..core.state import EnvParams, EnvState, FIELDS, default_agent_colors
from ..device import resolve
from ..utils import checkpoint as ckpt_mod
from ..utils import profiling
from ..utils.metrics import MetricsLogger
from ..vector import obs_groups
from . import mesh as mesh_mod
from . import ppo, ppo_hetero, ppo_hetero_mixed, ppo_hetero_rnn, ppo_rnn

#: the scenarios whose palettes the tests sweep; a custom scenario's palette
#: is checked when training starts (core/obs.py::validate_encode_palette)
BUILTIN_SCENARIOS = ("empty", "cluttered", "doorkey", "goal_cycle")


#: the calls that --profile-dir traces (0-based), as the JAX CLI does
TRACED = range(2, 5)


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
                        "cnn_s2d for image/rich; 'cnn' is 3x3 convs on "
                        "one-hot encode planes)")
    p.add_argument("--rnn", default="", choices=["", "gru", "lstm"],
                   help="recurrent policy cell: sequence-aware PPO with "
                        "env-block minibatches and done-masked hidden state "
                        "(parallel/ppo_rnn.py)")
    p.add_argument("--bptt-window", type=int, default=0,
                   help="truncated-BPTT window for --rnn: chunk the T-step "
                        "sequences into L-step windows (must divide "
                        "--rollout; 0 = full sequences)")
    p.add_argument("--agent-config", default=None,
                   help="JSON list of per-agent GridAgentInterface kwargs "
                        "(one object per agent; unset kwargs take the "
                        "scalar flags): heterogeneous populations, one "
                        "policy per observation group")
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
                   help="train iterations per call (ppo.multi_step: on the "
                        "card one captured step replayed k times); metrics "
                        "then have steps-per-call granularity")
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
                   help="join a torch.distributed process group first "
                        "(parallel/mesh.py::init_distributed; one rank per "
                        "process and card)")
    p.add_argument("--coordinator", default=None,
                   help="with --distributed: coordinator host:port, or an "
                        "init URL such as file:///path (default: "
                        "auto-detect from the cluster env, torchrun's "
                        "variables)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--shard-map", action="store_true",
                   help="explicit-collective train step (hand-written "
                        "pmean/psum over the ranks of the 'data' axis, "
                        "parallel/mesh.py)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace output dir: calls 2-4 as they "
                        "run (graph replays on the card), by stage "
                        "(utils/profiling.py)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN: after each call, raise "
                        "FloatingPointError at the first non-finite loss "
                        "metric or parameter")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p.parse_args(argv)


def check_mesh(world: int, n_model: int):
    """Exit with JAX's ``make_mesh`` message unless ``world`` ranks make a
    (world // n_model, n_model) mesh."""
    n_data = world // n_model
    if n_data * n_model != world:
        raise SystemExit(f"{n_data}x{n_model} mesh != {world} devices")


def build(args):
    """(EnvParams, PPOConfig) from the flags, as the JAX CLI builds them."""
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
    if args.rnn and args.obs == "encode" and torso != "mlp" \
            and not args.agent_config:
        # the JAX CLI stops at init_state_rnn's assert
        raise SystemExit(f"--rnn --torso {torso}: encode recurrent PPO uses "
                         f"the mlp feature-major path")
    if args.obs != "encode" and torso == "mlp":
        raise SystemExit(f"--obs {args.obs}: the pov is an image; train it "
                         f"with --torso cnn_s2d or cnn_image")
    observe = {f.strip() for f in args.observe.split(",") if f.strip()}
    if not observe <= {"rewards", "position", "orientation"}:
        raise SystemExit(
            f"--observe: unknown field(s) "
            f"{sorted(observe - {'rewards', 'position', 'orientation'})} "
            f"(valid: rewards,position,orientation)")
    if args.agent_config:
        ep = EnvParams(
            width=args.grid_size, height=args.grid_size,
            scenario=args.scenario, max_steps=args.max_steps,
            reward_decay=args.scenario != "goal_cycle",
            **agents_to_params_fields(agent_list(args, observe)))
    else:
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
    if ep.has_hetero_obs:
        if args.overlap or args.shard_map:
            raise SystemExit("heterogeneous agent configs train on the GSPMD "
                             "path (no --overlap/--shard-map): without "
                             "--overlap (the double-buffered variant is the "
                             "shared-policy step's) and without --shard-map")
        if args.rnn and is_mixed(ep):
            raise SystemExit("hetero recurrent training is encode-only "
                             "(ppo_hetero_rnn.py); mixed-style groups train "
                             "feedforward (drop --rnn)")
    elif args.rnn and args.shard_map and args.obs != "encode":
        raise SystemExit("--rnn --shard-map is the encode path; image "
                         "recurrent runs use the default GSPMD mesh")
    elif args.overlap and args.shard_map:
        raise SystemExit("--overlap + --shard-map not supported")
    if observe and not any(ep.agent_obs_style(i) == "rich"
                           for i in range(ep.n_agents)):
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
    if (args.obs == "encode" and torso == "mlp" and not ep.has_hetero_obs
            and not args.no_embed_palette):
        # hetero groups keep the full vocabularies, as the JAX CLI does
        pals = obs_mod.encode_palettes(ep)
        if pals is not None:
            if ep.scenario not in BUILTIN_SCENARIOS:
                # a custom palette must cover every code the obs show, or
                # the embed would zero the missing ones silently
                obs_mod.validate_encode_palette(
                    ep, device=resolve(args.device))
            cfg = dataclasses.replace(cfg, embed_palettes=pals)
    return ep, cfg


def agent_list(args, observe):
    """The ``--agent-config`` agents: one GridAgentInterface per JSON object,
    its unset kwargs taken from the scalar flags (the colors from the
    default per-index order). Exits with the JAX CLI's messages on bad
    JSON, a spec that is not a non-empty list of objects, or an agent's bad
    kwargs."""
    try:
        spec = json.loads(args.agent_config)
    except ValueError as e:
        raise SystemExit(f"--agent-config: invalid JSON ({e})")
    if not isinstance(spec, list) or not spec \
            or not all(isinstance(kw, dict) for kw in spec):
        raise SystemExit("--agent-config must be a non-empty JSON list "
                         "of per-agent kwargs objects")
    colors = default_agent_colors(len(spec))
    agents = []
    for i, kw in enumerate(spec):
        kw = dict(kw)
        kw.setdefault("color", C.COLOR_NAMES[colors[i]])
        kw.setdefault("view_size", args.view_size)
        kw.setdefault("observation_style", args.obs)
        kw.setdefault("observe_rewards", "rewards" in observe)
        kw.setdefault("observe_position", "position" in observe)
        kw.setdefault("observe_orientation", "orientation" in observe)
        try:
            agents.append(GridAgentInterface(**kw))
        except (TypeError, KeyError, AssertionError) as e:
            raise SystemExit(f"--agent-config agent {i}: {e}")
    return agents


def is_mixed(ep: EnvParams) -> bool:
    """Whether some observation group of a hetero population renders
    pixels (the mixed-style trainer's case)."""
    return any(gp.observation_style != "encode" for _, gp in obs_groups(ep))


def init(ep: EnvParams, cfg, generator, dev):
    """``(net, optimizer, h)`` of the trainer that ``ep`` and ``cfg`` select
    (``h`` None for feedforward; a hetero population's ``net`` is the
    ModuleList of its groups' policies)."""
    if ep.has_hetero_obs and cfg.rnn:
        return ppo_hetero_rnn.init_state_hetero_rnn(ep, cfg, generator,
                                                    device=dev)
    if ep.has_hetero_obs:
        init_fn = (ppo_hetero_mixed.init_state_hetero_mixed if is_mixed(ep)
                   else ppo_hetero.init_state_hetero)
        return init_fn(ep, cfg, generator, device=dev) + (None,)
    if cfg.rnn:
        return ppo_rnn.init_state_rnn(ep, cfg, generator, device=dev)
    return ppo.init_state(ep, cfg, generator, device=dev) + (None,)


def make_step(ep: EnvParams, cfg, net, opt, dev, jit=True, **shards):
    """The train step of the trainer that ``ep`` and ``cfg`` select
    (without ``--overlap``): graphed on the card with ``jit=True``, the raw
    eager step with ``jit=False``. ``shards``: this rank's step on its envs
    over a Mesh, ``mesh=`` for the sharded default path or ``axis=`` for
    ``--shard-map``'s explicit-collective step (``make_train_step``'s
    keywords)."""
    if ep.has_hetero_obs and cfg.rnn:
        return ppo_hetero_rnn.make_train_step_hetero_rnn(
            ep, cfg, net, opt, device=dev, jit=jit, **shards)
    if ep.has_hetero_obs:
        make = (ppo_hetero_mixed.make_train_step_hetero_mixed if is_mixed(ep)
                else ppo_hetero.make_train_step_hetero)
        return make(ep, cfg, net, opt, device=dev, jit=jit, **shards)
    if cfg.rnn:
        return ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device=dev,
                                           jit=jit, **shards)
    return ppo.make_train_step(ep, cfg, net, opt, device=dev, jit=jit,
                               **shards)


def make_call(ep: EnvParams, cfg, net, opt, dev, spc: int, overlap=False,
              **shards):
    """``(step, prime)``: what one train call runs, wired as the JAX CLI
    wires it. ``spc`` steps per call: the graphed step (``jit=True``) for
    one, ``ppo.multi_step`` (``ppo_rnn.multi_step_rnn`` for the recurrent
    trainers, ``ppo.multi_step_overlap`` with ``overlap``) of the raw step
    for more. ``prime`` is the overlap step's priming rollout, else
    None. ``shards``: :func:`make_step`'s."""
    if overlap:
        raw, prime = ppo.make_train_step(ep, cfg, net, opt, device=dev,
                                         overlap=True, jit=spc == 1,
                                         **shards)
        return (ppo.multi_step_overlap(raw, spc) if spc > 1 else raw), prime
    if spc == 1:
        return make_step(ep, cfg, net, opt, dev, **shards), None
    multi = ppo_rnn.multi_step_rnn if cfg.rnn else ppo.multi_step
    return multi(make_step(ep, cfg, net, opt, dev, jit=False, **shards),
                 spc), None


def check_finite(iteration: int, metrics, net):
    """``--debug-nans``: raise ``FloatingPointError`` naming ``iteration``
    and the first non-finite tensor among the call's metrics and then the
    net's parameters (in ``named_parameters`` order). One host sync when
    every value is finite."""
    named = ([(f"metric {k!r}", v) for k, v in metrics.items()]
             + [(f"parameter {n!r}", p) for n, p in net.named_parameters()])
    bad = torch.stack([~torch.isfinite(t).all() for _, t in named])
    if bool(bad.any()):
        raise FloatingPointError(
            f"--debug-nans: non-finite {named[int(bad.int().argmax())][0]} "
            f"after iteration {iteration}")


def _state_dict(net):
    """The weights to checkpoint: the net's state_dict, or a hetero
    population's list of per-group state_dicts."""
    if isinstance(net, torch.nn.ModuleList):
        return [n.state_dict() for n in net]
    return net.state_dict()


def _load_state_dict(net, sd):
    if isinstance(net, torch.nn.ModuleList):
        for n, s in zip(net, sd, strict=True):
            n.load_state_dict(s)
    else:
        net.load_state_dict(sd)


def load_optimizer(opt, sd):
    """Load an Adam ``state_dict`` into ``opt`` and keep ``opt``'s own form
    (capturable on the card, plain on the CPU) whatever device wrote it:
    ``load_state_dict`` takes the saved groups' flags, so a checkpoint
    written on the CPU would leave the card's Adam uncapturable (a graphed
    step then fails to capture), and one written on the card would make
    the CPU's refuse to step. With the flag set, Adam's step counts land
    on the parameters' device."""
    for group in sd["param_groups"]:
        group["capturable"] = opt.defaults["capturable"]
    opt.load_state_dict(sd)


def _carry_map(fn, h):
    """``fn`` on each tensor of a carry (a tensor, an LSTM's pair, or a
    hetero dict of either)."""
    if isinstance(h, dict):
        return {g: _carry_map(fn, x) for g, x in h.items()}
    return ppo_rnn.map_carry(fn, h)


def carry_dim(ep: EnvParams, cfg) -> int:
    """The env axis of the run's carry leaves: 0 for the recurrent image
    path's (B, N, H), 1 for the encode path's (N, B, H) and for a hetero
    population's (n_g, B, H)."""
    if cfg.rnn and not ep.has_hetero_obs:
        return ppo_rnn.carry_env_dim(ep, cfg)
    return 1


def local_carry(mesh, h, dim: int = 1):
    """This rank's slice of a global carry along its env axis ``dim``
    (:func:`carry_dim`)."""
    if mesh is None or h is None:
        return h
    return _carry_map(lambda t: mesh_mod.shard(mesh, t, dim), h)


def main(argv=None):
    args = parse_args(argv)
    world = (args.num_processes or os.environ.get("WORLD_SIZE")
             if args.distributed else 1)
    if world:
        check_mesh(int(world), args.model_shards)
    if args.distributed:
        # before anything touches the card: the rank picks its card here
        dev = mesh_mod.init_distributed(args.device, args.coordinator,
                                        args.num_processes, args.process_id)
    else:
        dev = resolve(args.device)
    try:
        return train(args, dev)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


def train(args, dev):
    ep, cfg = build(args)
    # the mesh: --shard-map's, or every rank of --distributed (the sharded
    # default path), the ranks laid out (world / N, N) by --model-shards N
    sharded = args.shard_map or args.distributed
    if args.distributed:
        check_mesh(torch.distributed.get_world_size(), args.model_shards)
    mesh = (mesh_mod.make_mesh(n_model=args.model_shards, device=dev)
            if sharded else None)
    key = rng.PRNGKey(args.seed, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    net, opt, h = init(ep, cfg, gen, dev)
    hdim = carry_dim(ep, cfg)
    h = local_carry(mesh, h, hdim)
    env_state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                                   stagger=not args.no_stagger, device=dev,
                                   mesh=mesh)
    key = rng.fold_in(key, 2)
    if args.resume:
        # load on the CPU: load_state_dict moves each tensor where it
        # belongs (Adam's step counts onto the card, where it is
        # capturable). Everything is restored before the first call, so a
        # graphed step captures the restored tensors. A checkpoint holds
        # the global batch: a rank takes its slice.
        tree = ckpt_mod.restore(args.resume, map_location="cpu")
        _load_state_dict(net, tree["net"])
        load_optimizer(opt, tree["opt"])
        if "env_state" in tree and "key" in tree:
            env_state = EnvState(**tree["env_state"]).map(
                lambda t: t.to(dev))
            if mesh is not None:
                env_state = env_state.map(lambda t: mesh_mod.shard(mesh, t))
            key = tree["key"].to(dev)
            if h is not None and "h" in tree:
                h = local_carry(mesh, _carry_map(lambda t: t.to(dev),
                                                 tree["h"]), hdim)
        else:
            print("warning: the checkpoint holds no env state and key"
                  + (" or carry" if h is not None else "")
                  + "; they restart fresh", flush=True)
    if mesh is not None:
        # every rank starts from rank 0's weights and optimizer state
        mesh_mod.broadcast_from(mesh, list(net.state_dict().values()) + [
            t for st in opt.state.values() for t in st.values()
            if torch.is_tensor(t)], world=True)

    spc = max(1, args.steps_per_call)
    prev = None
    # make_train_step's keyword picks the path: axis= for --shard-map's
    # explicit collectives, mesh= for the sharded default path
    shards = {} if mesh is None else {
        "axis" if args.shard_map else "mesh": mesh}
    step, prime = make_call(ep, cfg, net, opt, dev, spc, args.overlap,
                            **shards)
    if prime is not None:
        env_state, prev, key = prime(env_state, key)
    prof = None
    log = MetricsLogger(args.metrics)
    run_config = dict(format=1, env_params=ep.to_dict(),
                      ppo=ppo.ppo_config_to_dict(cfg))

    env_steps_per_iter = cfg.n_envs * cfg.rollout_len * spc
    n_calls = max(1, args.iters // spc)
    if n_calls * spc != args.iters:
        print(f"warning: --iters {args.iters} is not a multiple of "
              f"--steps-per-call {spc}; running {n_calls * spc} iterations "
              f"({n_calls} calls)", flush=True)
    def whole(t, dim=0):
        """A copy of the global batch's ``t`` (env axis ``dim``)."""
        return (t if mesh is None else mesh_mod.gather(mesh, t, dim)).clone()

    t0 = time.time()
    last_logged = -1
    for it in range(n_calls):
        if args.profile_dir and it == TRACED[0]:
            prof = profiling.start(cuda=dev.type == "cuda")
        if cfg.rnn:
            env_state, h, key, metrics = step(env_state, h, key)
        elif args.overlap:
            env_state, prev, key, metrics = step(env_state, prev, key)
        else:
            env_state, key, metrics = step(env_state, key)
        if args.debug_nans:
            check_finite((it + 1) * spc - 1, metrics, net)
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
        if prof is not None and it == TRACED[-1]:
            profiling.stop(prof, args.profile_dir)
            prof = None
        if (args.checkpoint_dir and args.checkpoint_every
                and (it + 1) % args.checkpoint_every == 0):
            # a graphed step's carry is its static buffers, which the next
            # call overwrites: the checkpoint clones it (under a mesh, the
            # global batch gathered from every rank, which rank 0 writes)
            payload = dict(net=_state_dict(net), opt=opt.state_dict(),
                           env_state={f: whole(getattr(env_state, f))
                                      for f in FIELDS},
                           key=key.clone())
            if h is not None:
                payload["h"] = _carry_map(lambda t: whole(t, hdim), h)
            if mesh is None or mesh.rank == 0:
                ckpt_mod.save(args.checkpoint_dir, payload, step=it + 1,
                              config=run_config)
    if prof is not None:
        # the run ended inside the traced calls: the JAX CLI never stops
        # its trace then, and writes none
        profiling.stop(prof)
        print(f"warning: --profile-dir: the run ended before call "
              f"{TRACED[-1]}; no trace written", flush=True)
    log.close()
    return net


if __name__ == "__main__":
    main()
