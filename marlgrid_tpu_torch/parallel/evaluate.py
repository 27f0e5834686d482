"""Evaluate a trained checkpoint: greedy or sampled episodes, a stats line
and, optionally, a video (PyTorch port of ``marlgrid_tpu/parallel/
evaluate.py``).

It restores a checkpoint of the port's training CLI (``utils/checkpoint.py``:
``step_N.pt`` beside ``config.json``), drives the host env
(``wrapper.MultiGridEnv``) with the trained policy on ``--device`` (default
``cuda``), and prints the JAX CLI's JSON stats line. A checkpoint describes
itself, so the path is all it needs:

    python -m marlgrid_tpu_torch.parallel.evaluate --checkpoint ckpts \
        --episodes 5 --out eval.gif

Env and model flags given explicitly are checked against ``config.json``
and a mismatch exits (a shape-coincident mismatch would restore the wrong
policy); ``--max-steps`` is the evaluation's own override. A checkpoint
without ``config.json`` is rebuilt from the flags and the historical
defaults. All five families evaluate: the mlp and recurrent policies
(``models.ActorCritic``, ``RecurrentActorCritic``: K2f, or K5f for a
plane-major checkpoint, on the card), the 'cnn' and 'cnn_image' torsos on
encode obs (row-major codes; an encode 'cnn_s2d' checkpoint is refused,
as the JAX evaluate fails on it), the hetero populations (a policy per
observation group, with the recurrent carry dict) and mixed styles (the
cnn_s2d relabel done on the host, :func:`style_obs_batch`). Actions are the
argmax of the logits, or with ``--sample`` a categorical draw on the key
``PRNGKey(seed + 1)`` split each step, as the JAX CLI draws them.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import rng
from ..core.state import EnvParams, default_agent_colors
from ..device import resolve
from ..utils import checkpoint as ckpt_mod
from ..utils.video import GridRecorder
from ..vector import obs_groups
from ..wrapper import MultiGridEnv
from . import ppo, ppo_hetero_mixed, train


def parse_args(argv=None):
    # env and model flags default to None: "take it from the checkpoint's
    # config.json"; one given explicitly must match it. Checkpoints without
    # config.json fall back to the historical defaults below.
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--ckpt-step", type=int, default=None)
    p.add_argument("--scenario", default=None)
    p.add_argument("--grid-size", type=int, default=None)
    p.add_argument("--agents", type=int, default=None)
    p.add_argument("--view-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="eval episode cap (overrides the training value)")
    p.add_argument("--obs", default=None,
                   choices=["encode", "image", "rich"])
    p.add_argument("--observe", default=None,
                   help="comma list of rich-obs fields (match the "
                        "training run): rewards,position,orientation")
    p.add_argument("--torso", default=None)
    p.add_argument("--rnn", default=None, choices=["", "gru", "lstm"])
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--envs", type=int, default=None,
                   help="n_envs of the TRAINING run (checked against the "
                        "checkpoint's config)")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample", action="store_true",
                   help="sample actions from the policy (default: argmax)")
    p.add_argument("--out", default=None, help="video path (.gif / .mp4)")
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    return p.parse_args(argv)


# historical flag defaults, used only for checkpoints with no config.json
_FALLBACKS = dict(scenario="goal_cycle", grid_size=13, agents=4,
                  view_size=7, max_steps=250, obs="encode", observe="",
                  rnn="", hidden=128, envs=4096)


def _parse_observe(s):
    observe = {f.strip() for f in s.split(",") if f.strip()}
    if not observe <= {"rewards", "position", "orientation"}:
        raise SystemExit(
            f"--observe: unknown field(s) "
            f"{sorted(observe - {'rewards', 'position', 'orientation'})} "
            f"(valid: rewards,position,orientation)")
    return observe


def resolve_config(args):
    """(eval EnvParams, PPOConfig) from the checkpoint's config.json.

    Explicit flags are checked against the config: a mismatch on anything
    that shapes the policy exits. ``--max-steps`` alone overrides (it
    shapes nothing restored). Checkpoints without config.json rebuild
    everything from the flags with the historical defaults."""
    cfgj = ckpt_mod.load_config(args.checkpoint)
    if cfgj is None:
        for k, v in _FALLBACKS.items():
            if getattr(args, k) is None:
                setattr(args, k, v)
        observe = _parse_observe(args.observe)
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
        torso = args.torso or ("cnn_s2d" if args.obs in ("image", "rich")
                               else "mlp")
        cfg = ppo.PPOConfig(n_envs=args.envs, hidden=args.hidden,
                            torso=torso, rnn=args.rnn)
        return ep, cfg

    ep = EnvParams.from_dict(cfgj["env_params"])
    cfg = ppo.ppo_config_from_dict(cfgj["ppo"])
    checks = [
        ("scenario", args.scenario, ep.scenario),
        ("grid-size", args.grid_size, ep.width),
        ("agents", args.agents, ep.n_agents),
        ("view-size", args.view_size, ep.view_size),
        ("obs", args.obs, ep.observation_style),
        ("torso", args.torso, cfg.torso),
        ("rnn", args.rnn, cfg.rnn),
        ("hidden", args.hidden, cfg.hidden),
        ("envs", args.envs, cfg.n_envs),
    ]
    if args.observe is not None:
        want = {f for f, on in
                [("rewards", ep.observe_rewards),
                 ("position", ep.observe_position),
                 ("orientation", ep.observe_orientation)] if on}
        checks.append(("observe", ",".join(sorted(_parse_observe(
            args.observe))), ",".join(sorted(want))))
    mism = [f"  --{n} {g!r} != checkpoint config {w!r}"
            for n, g, w in checks if g is not None and g != w]
    if mism:
        raise SystemExit(
            "evaluate: flag(s) contradict the checkpoint's config.json "
            "(the checkpoint is self-describing — just omit them):\n"
            + "\n".join(mism))
    if args.max_steps is not None and args.max_steps != ep.max_steps:
        print(f"note: eval max_steps={args.max_steps} overrides the "
              f"training value {ep.max_steps}", flush=True)
        ep = ep.replace(max_steps=args.max_steps)
    args.obs = ep.observation_style
    args.torso, args.rnn = cfg.torso, cfg.rnn
    return ep, cfg


def restore_policy(args, ep: EnvParams, cfg: ppo.PPOConfig):
    """``(net, h0)``: the policy of a training-CLI checkpoint on
    ``args.device`` (a hetero population's ``net`` is the ModuleList of
    its groups' policies), and ``h0()`` the episode's first recurrent
    carry (None for feedforward; ``{group: carry}`` for hetero)."""
    dev = resolve(args.device)
    net, _, _ = train.init(ep, cfg, torch.Generator().manual_seed(0), dev)
    tree = ckpt_mod.restore(args.checkpoint, step=args.ckpt_step,
                            map_location=dev)
    train._load_state_dict(net, tree["net"])

    def lead(n, torso):
        # the mlp torso's outputs keep a sample axis (S = 1)
        return (n, 1) if torso == "mlp" else (n,)

    def h0():
        if not cfg.rnn:
            return None
        if ep.has_hetero_obs:
            return {g: net[g].initial_carry(lead(len(idxs), "mlp"))
                    for g, (idxs, _) in enumerate(obs_groups(ep))}
        return net.initial_carry(lead(ep.n_agents, cfg.torso))

    return net, h0


def style_obs_batch(entries, ep, style, torso, device="cuda"):
    """Host per-agent obs entries of one style -> (policy input, aux or
    None) on ``device``: the mlp torso's feature-major codes (n, 3*vs*vs, 1)
    uint8 (one sample per agent row), the row-major codes (n, vs, vs, 3)
    of any other torso on encode obs, or the pov batch (n, h, w, c) uint8,
    relabeled space-to-depth on the host for the cnn_s2d torso (the host
    env emits standard-layout images), with the 'rich' features (n, d) as
    training normalizes them. Raises for encode obs with the cnn_s2d
    torso, where the JAX evaluate fails. Shared by the homogeneous and the
    per-group hetero paths, so their feature order cannot diverge."""
    dev = resolve(device)
    aux = None
    if style == "rich":
        pov = np.stack([o["pov"] for o in entries])
        rows = []
        for o in entries:
            r = []
            if "reward" in o:
                r.append(o["reward"])
            if "position" in o:
                r += [o["position"][0] / max(ep.width - 1, 1),
                      o["position"][1] / max(ep.height - 1, 1)]
            if "orientation" in o:
                r += [1.0 if d == o["orientation"] else 0.0
                      for d in range(4)]
            rows.append(r)
        if rows and rows[0]:
            aux = torch.as_tensor(np.asarray(rows, np.float32), device=dev)
    else:
        pov = np.stack(entries)
    if torso == "mlp":
        n = pov.shape[0]
        codes = pov.transpose(0, 3, 1, 2).reshape(n, -1, 1)
        return torch.as_tensor(codes.astype(np.uint8), device=dev), aux
    if torso == "cnn_s2d":
        if style == "encode":
            # the JAX evaluate relabels the (n, vs, vs, 3) codes as if they
            # were pixels here, and that reshape cannot succeed
            raise ValueError(
                "evaluate: an encode checkpoint with the cnn_s2d torso has "
                "no host obs batch: the JAX evaluate's space-to-depth "
                "relabel of its (n, vs, vs, 3) codes fails (ROADMAP Queue "
                "3, JAX at fault)")
        n, hh, ww, c = pov.shape
        pov = pov.reshape(n, hh // 4, 4, ww // 4, 4, c) \
            .transpose(0, 1, 3, 2, 4, 5).reshape(n, hh // 4, ww // 4,
                                                 16 * c)
    return torch.as_tensor(np.ascontiguousarray(pov), device=dev), aux


def policy_logits(net, obs, aux, h):
    """``(logits (n, A) float32, h')`` of one policy on one step's batch
    (``h`` None for feedforward)."""
    if h is None:
        logits, _ = net(obs, aux)
    else:
        logits, _, h = net(obs, h, aux)
    return logits.reshape(obs.shape[0], -1), h


def make_actor(args, ep: EnvParams, cfg: ppo.PPOConfig, net):
    """``act(obs_list, h, key) -> (actions (N,) int64 on the device, h')``:
    one step of the policy (or of each group's policy) on the host env's
    observations."""
    dev = resolve(args.device)

    def choose(logits, key):
        return (rng.categorical(key, logits) if args.sample
                else torch.argmax(logits, dim=-1))

    if not ep.has_hetero_obs:
        @torch.no_grad()
        def act(obs_list, h, key):
            obs, aux = style_obs_batch(obs_list, ep, args.obs, cfg.torso,
                                       dev)
            logits, h = policy_logits(net, obs, aux, h)
            return choose(logits, key), h

        return act

    groups = obs_groups(ep)
    styles = [gp.observation_style for _, gp in groups]
    torsos = [ppo_hetero_mixed.group_cfg(cfg, gp).torso
              if gp.observation_style != "encode" else "mlp"
              for _, gp in groups]

    @torch.no_grad()
    def act(obs_list, h, key):
        acts = torch.zeros(ep.n_agents, dtype=torch.int64, device=dev)
        h_new = {} if h is not None else None
        for g, (idxs, _) in enumerate(groups):
            obs, aux = style_obs_batch([obs_list[i] for i in idxs], ep,
                                       styles[g], torsos[g], dev)
            logits, hg = policy_logits(net[g], obs, aux,
                                       None if h is None else h[g])
            if h is not None:
                h_new[g] = hg
            acts[list(idxs)] = choose(logits, rng.fold_in(key, g))
        return acts, h_new

    return act


def main(argv=None):
    """Run the evaluation and print the stats line; returns the stats with
    the episodes' total ``steps`` and the loop's wall ``seconds``."""
    args = parse_args(argv)
    ep, cfg = resolve_config(args)
    dev = resolve(args.device)
    net, h0 = restore_policy(args, ep, cfg)
    act = make_actor(args, ep, cfg, net)

    env = MultiGridEnv(params=ep, seed=args.seed, device=dev)
    rec = GridRecorder(env, tile_size=args.tile_size) if args.out else env

    key = rng.PRNGKey(args.seed + 1, device=dev)
    returns, lengths = [], []
    t0 = time.perf_counter()
    for _ in range(args.episodes):
        obs_list = rec.reset()
        h = h0()
        done = False
        total = np.zeros(ep.n_agents)
        steps = 0
        while not done:
            ks = rng.split(key)
            key, ak = ks[0], ks[1]
            a, h = act(obs_list, h, ak)
            obs_list, rew, done, _ = rec.step(a.cpu().numpy())
            total += np.asarray(rew)
            steps += 1
        returns.append(float(total.sum()))
        lengths.append(steps)
    seconds = time.perf_counter() - t0
    if args.out:
        rec.export_video(args.out, fps=args.fps)
    stats = {
        "episodes": args.episodes,
        "mean_return": float(np.mean(returns)),
        "returns": returns,
        "mean_length": float(np.mean(lengths)),
        "video": args.out,
    }
    print(json.dumps(stats))
    return dict(stats, steps=int(sum(lengths)), seconds=seconds)


if __name__ == "__main__":
    main()
