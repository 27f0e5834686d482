"""Heterogeneous-agent PPO, the parts the mixed-style trainer uses, frozen
from the port's ``parallel/ppo_hetero.py``: the observation groups, each
group's observations from one painted board, the union-normalized loss, a
group's rows of the label tables, and the feedforward rollout.

The agents that share a per-agent observation config form a group
(:func:`obs_groups`, the port's ``vector.obs_groups``), and each group has
a policy of its own. The board is painted once a step and each group
renders only its own observers against it; group g samples its actions
from ``categorical(fold_in(step key, g), logits_g)`` and a static row
permutation puts the groups' (n_g, B) rows back into agent order.

Departures from the port's path: one device and the eager step only (no
mesh, no CUDA graph, no recurrent carry); the kernels are their plain
versions (``mgref/ops``); the stages are ``record_function`` labels
without the style children the port's stage spans add.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ..core import obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import const, resolve
from .ppo import (PPOConfig, _stack_states, pool_size, ppo_terms, rich_aux)

_LABELS = ("act", "logp", "val", "adv", "ret")


def obs_groups(params: EnvParams):
    """The agents grouped by their per-agent observation config:
    ``[(idxs, gp), ...]`` in order of first appearance, ``idxs`` the agent
    indices that share the homogeneous params ``gp``."""
    groups = {}
    for i in range(params.n_agents):
        groups.setdefault(params.agent_obs_params(i), []).append(i)
    return [(tuple(idxs), gp) for gp, idxs in groups.items()]


def group_obs(env_params: EnvParams, groups, torsos, state,
              pixels_only=False):
    """The policies' inputs, one ``(x, aux)`` per group, from one painted
    board (with the prestige levels when a group renders pixels): encode
    groups' feature-major codes (n_g, F_g, B) uint8, the pixel groups'
    (n_g, B, ...) images (s2d when the group's torso is 'cnn_s2d') with the
    'rich' features (n_g, B, d) or None. ``pixels_only``: None in place of
    every encode group's input."""
    B = state.batch_size
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    packed = obs_mod.pack_grid_with_agents(env_params, state,
                                           with_lvl=pixels)
    out = []
    for (idxs, gp), torso in zip(groups, torsos):
        if gp.observation_style == "encode" and pixels_only:
            out.append(None)
        elif gp.observation_style == "encode":
            bm = obs_mod.all_obs_encode_b(gp, state, bminor=True,
                                          observers=idxs, packed=packed)
            out.append((bm.permute(1, 0, 2, 3, 4).reshape(
                len(idxs), -1, B).to(torch.uint8), None))
        else:
            pov = obs_mod.all_obs_image_b(gp, state, bminor=True,
                                          s2d=torso == "cnn_s2d",
                                          observers=idxs, packed=packed)
            aux = (rich_aux(gp, state) if gp.observation_style == "rich"
                   else None)
            if aux is not None:
                cols = const(idxs, torch.int64, aux.device)
                aux = aux[:, cols].permute(1, 0, 2)
            out.append((pov, aux))
    return out


def group_loss(parts, cfg: PPOConfig):
    """The clipped PPO objective over several groups' samples: ``parts``
    is a list of ``(logits, value, lab)``, one per group, aligned sample
    for sample. The advantages are normalized with the mean and population
    std of the union of the groups' samples; each term is summed over every
    sample of every group and divided by their total count -> ``(total,
    {pg_loss, vf_loss, entropy, ratio_dev})``."""
    advs = [lab["adv"] for _, _, lab in parts]
    n = sum(a.numel() for a in advs)
    mean = sum(a.sum() for a in advs) / n
    std = torch.sqrt(sum(((a - mean) ** 2).sum() for a in advs) / n) + 1e-8
    sums = [0.0] * 4
    for logits, value, lab in parts:
        terms = ppo_terms(logits, value, lab, (lab["adv"] - mean) / std, cfg)
        sums = [s + x.sum() for s, x in zip(sums, terms)]
    pg, vf, ent, dev = (s / n for s in sums)
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)


def label_rows(x, idxs):
    """Rows ``idxs`` (a group's agents) of a (T, N, B) label table."""
    return x[:, const(idxs, torch.int64, x.device)]


def make_rollout_hetero(env_params: EnvParams, cfg: PPOConfig, nets, groups,
                        torsos, device="cuda", store_states=False):
    """Build ``rollout(env_state, key) -> (env_state, key, traj,
    last_value)``. Per step t: every group's policy acts on its
    observations (:func:`group_obs`), group g samples its actions from
    ``categorical(fold_in(step key, g), logits_g)``, the groups' rows go
    back into agent order, and the envs step with the pool autoreset
    (``board_pool`` layouts, rotated by t, salt t).

    ``traj``: ``obs``, a list over groups of (T, n_g, F_g, B) uint8 codes
    (None for a pixel group); ``act``/``logp``/``val``/``rew`` (T, N, B);
    ``done``/``ep_*`` (T, B); with ``store_states``, ``state``, the
    pre-step EnvStates with (T, B, ...) leaves. ``last_value`` is (N, B).
    """
    dev = resolve(device)
    B, T = cfg.n_envs, cfg.rollout_len
    K = pool_size(cfg, B)
    perm = [i for idxs, _ in groups for i in idxs]
    inv = const(sorted(range(len(perm)), key=perm.__getitem__), torch.int64,
                dev)
    encode = [gp.observation_style == "encode" for _, gp in groups]

    def rows(parts):
        """Per-group (n_g, B) parts -> (N, B) in agent order."""
        return torch.cat(parts, 0)[inv]

    def obs_of(state):
        with record_function("rollout.obs"):
            return group_obs(env_params, groups, torsos, state)

    def policy(obs):
        with record_function("rollout.policy"):
            outs = [net(x, aux) for net, (x, aux) in zip(nets, obs)]
            return [o[0] for o in outs], [o[1] for o in outs]

    @torch.no_grad()
    def rollout(env_state, key):
        key = key.to(dev)
        obs = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        with record_function("rollout.fresh_pool"):
            pool = step_mod.fresh_pool(env_params, fk, K)
        names = ("act", "logp", "val", "rew", "done", "ep_ret", "ep_len",
                 "ep_cyc")
        steps = {k: [] for k in names}
        codes = [[] for _ in groups]
        states = []
        for t in range(T):
            logits, values = policy(obs)
            with record_function("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                acts, logps = [], []
                for g, lg in enumerate(logits):
                    a = rng.categorical(rng.fold_in(ak, g), lg)   # (n_g, B)
                    acts.append(a)
                    logps.append(F.log_softmax(lg, -1).gather(
                        -1, a[..., None])[..., 0])
                act = rows(acts)
            with record_function("rollout.env_step"):
                fresh_t = step_mod.fresh_pool_rows(pool, t, 0, B)
                stepped, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state, act.T, fresh_t,
                        env_offset=0, salt=t)
            # the stored obs is the PRE-step one, paired with the action
            for g, (x, _) in enumerate(obs):
                if encode[g]:
                    codes[g].append(x)
            if store_states:
                states.append(env_state)
            for k, v in zip(names, (
                    act.to(torch.int32), rows(logps), rows(values),
                    rew.T, done, info["episode_return"],
                    info["episode_length"], info["episode_cycles"])):
                steps[k].append(v)
            env_state = stepped
            obs = obs_of(env_state)
        _, values = policy(obs)
        traj = {k: torch.stack(v) for k, v in steps.items()}
        traj["obs"] = [torch.stack(c) if c else None for c in codes]
        if store_states:
            traj["state"] = _stack_states(states)
        return env_state, key, traj, rows(values)

    return rollout
