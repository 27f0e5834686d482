"""The reference side of a mixed-style population's check: the per-agent
build of the train CLI's ``--agent-config`` (which ``cli.py`` refuses, as
its shared-policy reference does not follow it), and the mixed trainer's
calls followed or put in the program's place
(``mgref/parallel/ppo_hetero_mixed.py``).

:func:`build` reads the same argv the program's parser reads
(``cli.cli_flags``): every flag but ``--agent-config`` goes through the
frozen parser, and the agent list is folded into the EnvParams fields as
the port's ``agents.py`` folds it (``GridAgentInterface``'s defaults, the
scalar flags for the unset kwargs, the default colors by index). The
groups keep the full encode vocabulary, as the CLI gives hetero groups.

Departures from the port's path: the agent kwargs are checked for their
names only (the port's ``GridAgentInterface`` also refuses an even view);
the eager one-card step alone, as everywhere in the reference.
"""
from __future__ import annotations

import contextlib
import json

import torch

from . import cli, follow
from .mgref.core import constants as C
from .mgref.core.state import EnvParams, default_agent_colors
from .mgref.parallel import ppo, ppo_hetero, ppo_hetero_mixed

#: ``GridAgentInterface``'s keyword arguments and defaults (the scalar
#: flags fill ``view_size``, ``observation_style`` and ``observe_*``)
AGENT_DEFAULTS = dict(view_tile_size=8, view_offset=0,
                      see_through_walls=False, hide_item_types=(),
                      prestige_beta=0.95, prestige_scale=2.0, spawn_delay=0)
#: an agent kwarg -> the EnvParams table that holds it where agents differ
TABLES = (("view_size", "agent_view_sizes"),
          ("view_tile_size", "agent_view_tile_sizes"),
          ("observation_style", "agent_obs_styles"),
          ("view_offset", "agent_view_offsets"),
          ("see_through_walls", "agent_see_through_walls"),
          ("hide_item_types", "agent_hide_item_types"),
          ("observe_rewards", "agent_observe_rewards"),
          ("observe_position", "agent_observe_positions"),
          ("observe_orientation", "agent_observe_orientations"),
          ("prestige_beta", "agent_prestige_betas"),
          ("prestige_scale", "agent_prestige_scales"))


def split_argv(argv):
    """``(argv without --agent-config, its JSON value)``."""
    i = argv.index("--agent-config")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def agents_fields(spec, args, observe) -> dict:
    """EnvParams fields of the agent list ``spec`` (a list of kwargs
    objects): values every agent shares land in the scalar fields, values
    that differ fill the per-agent tables."""
    colors = default_agent_colors(len(spec))
    agents = []
    for i, kw in enumerate(spec):
        known = set(AGENT_DEFAULTS) | {t for t, _ in TABLES} | {"color"}
        if set(kw) - known:
            raise ValueError(f"--agent-config agent {i}: unknown kwargs "
                             f"{sorted(set(kw) - known)}")
        a = dict(AGENT_DEFAULTS, view_size=args.view_size,
                 observation_style=args.obs,
                 observe_rewards="rewards" in observe,
                 observe_position="position" in observe,
                 observe_orientation="orientation" in observe)
        a.update(kw)
        a["color_idx"] = (C.COLOR_TO_IDX[kw["color"]] if "color" in kw
                          else colors[i])
        a["hide_item_types"] = tuple(
            C.TYPE_TO_IDX[t] if isinstance(t, str) else int(t)
            for t in a["hide_item_types"])
        for k in ("prestige_beta", "prestige_scale"):
            a[k] = float(a[k])
        agents.append(a)
    a0 = agents[0]
    fields = {}
    for attr, table in TABLES:
        vals = tuple(a[attr] for a in agents)
        if any(v != vals[0] for v in vals[1:]):
            fields[table] = vals
    return dict(
        fields, n_agents=len(agents),
        agent_colors=tuple(a["color_idx"] for a in agents),
        spawn_delays=tuple(int(a["spawn_delay"]) for a in agents),
        **{k: a0[k] for k in ("prestige_beta", "prestige_scale",
                              "view_size", "view_tile_size", "view_offset",
                              "observation_style", "observe_rewards",
                              "observe_position", "observe_orientation",
                              "see_through_walls", "hide_item_types")})


def build(config: dict, traffic: dict, seed: int = 0):
    """``(EnvParams, PPOConfig)`` of a configuration with ``agent_config``
    at the traffic's batch and length, the policy computing in the
    configuration's dtype (full vocabularies: no encode palette)."""
    rest, spec = split_argv(cli.cli_flags(config["args"], traffic, seed))
    args = cli.parse_args(rest)
    observe = {f.strip() for f in args.observe.split(",") if f.strip()}
    ep = EnvParams(width=args.grid_size, height=args.grid_size,
                   scenario=args.scenario, max_steps=args.max_steps,
                   reward_decay=args.scenario != "goal_cycle",
                   **agents_fields(json.loads(spec), args, observe))
    if args.prestige_beta is not None:
        ep = ep.replace(prestige_beta=args.prestige_beta)
    if args.prestige_scale is not None:
        ep = ep.replace(prestige_scale=args.prestige_scale)
    torso = args.torso or ("cnn_s2d" if args.obs in ("image", "rich")
                           else "mlp")
    cfg = ppo.PPOConfig(n_envs=args.envs, rollout_len=args.rollout,
                        lr=args.lr, torso=torso, n_epochs=args.epochs,
                        n_minibatches=args.minibatches, hidden=args.hidden,
                        board_pool=args.board_pool, rnn=args.rnn,
                        bptt_window=args.bptt_window,
                        dtype=getattr(torch, config["dtype"]))
    if cfg.rnn:
        raise ValueError("the mixed-style reference is feedforward")
    return ep, cfg


def make_net(ep, cfg, weights, device, quant=None):
    """``(nets, optimizer)`` of the reference with ``weights`` loaded;
    ``quant`` rounds every operand of the policies' products (the
    control)."""
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device=device)
    nets.load_state_dict(weights)
    if quant is not None:
        for m in nets.modules():
            m.quant = quant
    return nets, opt


def half_batch_loss(parts, cfg):
    """A planted fault: ``ppo_hetero.group_loss`` with the union's
    statistics over every sample but each term over the first half of each
    group's samples alone."""
    advs = [lab["adv"] for _, _, lab in parts]
    n = sum(a.numel() for a in advs)
    mean = sum(a.sum() for a in advs) / n
    std = torch.sqrt(sum(((a - mean) ** 2).sum() for a in advs) / n) + 1e-8
    sums, half = [0.0] * 4, 0
    for logits, value, lab in parts:
        terms = ppo.ppo_terms(logits, value, lab, (lab["adv"] - mean) / std,
                              cfg)
        k = terms[0].numel() // 2
        half += k
        sums = [s + x.reshape(-1)[:k].sum() for s, x in zip(sums, terms)]
    pg, vf, ent, dev = (s / half for s in sums)
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)


@contextlib.contextmanager
def planted(fault: str):
    """The reference with a planted fault: ``half_batch`` (each group's
    loss over half of each minibatch)."""
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    saved = ppo_hetero.group_loss
    ppo_hetero.group_loss = half_batch_loss
    try:
        yield
    finally:
        ppo_hetero.group_loss = saved


def _step(ep, cfg, nets, opt, device):
    return ppo_hetero_mixed.make_train_step_hetero_mixed(ep, cfg, nets, opt,
                                                         device=device)


def run_calls(ep, cfg, weights, key, stagger, device, n=3, quant=None):
    """The reference's first ``n`` train steps from the run's inputs, in
    the program's place, kept as a run keeps the program's first calls
    (``follow.run_calls``)."""
    nets, opt = make_net(ep, cfg, weights, device, quant)
    named = list(nets.named_parameters())
    state, key = follow.start(ep, cfg, key, stagger, device)
    step = _step(ep, cfg, nets, opt, device)
    kept = dict(starts=[], losses=[], adam=[],
                beta1=opt.param_groups[0]["betas"][0])
    for _ in range(n):
        kept["starts"].append(follow.snapshot(nets, opt, state, key, None))
        state, key, m = step(state, key)
        kept["losses"].append(float(m["loss"]))
        kept["adam"].append(follow.adam_state(opt, named))
    kept["final"] = {k: p.detach().clone() for k, p in named}
    return kept


def follow_calls(ep, cfg, starts, device):
    """One reference train step from each of a run's call starts:
    ``dict(losses, adam, after)`` (``follow.follow_calls``)."""
    from .mgref.core.state import EnvState

    out = dict(losses=[], adam=[], after=[])
    for s in starts:
        nets, opt = make_net(ep, cfg, s["weights"], device)
        named = list(nets.named_parameters())
        for k, p in named:
            if k in s["opt"]:
                opt.state[p] = {a: v.clone() if torch.is_tensor(v) else v
                                for a, v in s["opt"][k].items()}
        state = EnvState(**{f: v.clone() for f, v in s["state"].items()})
        step = _step(ep, cfg, nets, opt, device)
        _, _, m = step(state, s["key"].clone())
        out["losses"].append(float(m["loss"]))
        out["adam"].append(follow.adam_state(opt, named))
        out["after"].append({k: p.detach().clone() for k, p in named})
    return out


def readings(config, traffic, seed, dev, kept):
    """The numbers a mixed train cell compares (``follow.train_readings``
    and ``start_mismatch``): each kept call against the reference's step
    from its own start, the first start against the run's inputs."""
    from .. import inputs

    ep, cfg = build(config, traffic, seed)
    with follow.plain_float32():
        ref = follow_calls(ep, cfg, kept["starts"], dev)
    out = follow.train_readings(kept, ref)
    out["start_mismatch"] = follow.start_mismatch(
        ep, cfg, kept, kept["weights"], inputs.make_key(seed, dev),
        follow.stagger(config), dev)
    return out
