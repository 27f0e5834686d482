"""Mixed-style heterogeneous PPO, frozen from the port's
``parallel/ppo_hetero_mixed.py``: encode, image and rich observation groups
training together, each with a policy of its own under one Adam and one
global-norm clip.

- Per-group torsos (:func:`group_cfg`): mlp for encode groups, 'cnn_s2d'
  or 'cnn_image' for pixel groups.
- The trajectory stores each encode group's uint8 codes and, when a group
  needs pixels, the pre-step EnvStates once; the update re-renders each
  minibatch's pixel observations from the stored states.
- Minibatches are (step, env-chunk) blocks shared by every group
  (``ppo.state_block_size``), under one permutation; the advantages are
  normalized over the union of the groups' samples
  (``ppo_hetero.group_loss``, looked up on its module when a loss is
  taken, so that a planted fault can stand in for it).

Departures from the port's path: one device and the eager step only (no
mesh, no CUDA graph, no ``Share`` of a minibatch over ranks); the kernels
are their plain versions; no warning for dropped blocks; the stages are
``record_function`` labels without the style children.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..core import rng
from ..core.state import EnvParams
from ..device import resolve
from ..models import ActorCritic
from . import ppo_hetero
from .ppo import (PPOConfig, aux_dim, episode_metrics, make_optimizer,
                  run_epochs, shuffled_blocks, state_block_size, step_labels)
from .ppo_hetero import _LABELS, group_obs, label_rows, obs_groups


def mixed_groups(env_params: EnvParams):
    """The trainable observation groups (any mix of encode, image and rich
    styles)."""
    groups = obs_groups(env_params)
    for idxs, gp in groups:
        if gp.observation_style not in ("encode", "image", "rich"):
            raise ValueError(f"mixed hetero PPO: agents {list(idxs)} use "
                             f"unsupported style {gp.observation_style!r}")
    return groups


def group_cfg(cfg: PPOConfig, gp: EnvParams) -> PPOConfig:
    """A group's model config: the mlp torso for encode, else ``cfg``'s
    pixels torso, or 'cnn_s2d' when the view's side in pixels is a
    multiple of 4 and 'cnn_image' when it is not."""
    if gp.observation_style == "encode":
        return dataclasses.replace(cfg, torso="mlp")
    side = gp.view_size * gp.view_tile_size
    torso = cfg.torso if cfg.torso in ("cnn_s2d", "cnn_image") else (
        "cnn_s2d" if side % 4 == 0 else "cnn_image")
    if torso == "cnn_s2d" and side % 4:
        torso = "cnn_image"
    return dataclasses.replace(cfg, torso=torso)


def torsos(cfg: PPOConfig, groups):
    return [group_cfg(cfg, gp).torso for _, gp in groups]


def init_state_hetero_mixed(env_params: EnvParams, cfg: PPOConfig,
                            generator=None, device="cuda"):
    """``(nets, optimizer)``: one style-appropriate ActorCritic per
    observation group in a ``ModuleList``, weights drawn from
    ``generator`` group after group, and Adam over all of them."""
    nets = torch.nn.ModuleList()
    for _, gp in mixed_groups(env_params):
        rich = gp.observation_style == "rich"
        nets.append(ActorCritic(group_cfg(cfg, gp), gp.view_size, generator,
                                device=device, tile_size=gp.view_tile_size,
                                aux_dim=aux_dim(gp) if rich else 0))
    return nets, make_optimizer(nets, cfg)


def make_rollout_hetero_mixed(env_params: EnvParams, cfg: PPOConfig, nets,
                              device="cuda"):
    """``ppo_hetero.make_rollout_hetero`` for a mixed population: the
    encode groups' codes and, with any pixel group, the pre-step EnvStates
    stored."""
    groups = mixed_groups(env_params)
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    return ppo_hetero.make_rollout_hetero(
        env_params, cfg, nets, groups, torsos(cfg, groups), device=device,
        store_states=pixels)


def make_update_hetero_mixed(env_params: EnvParams, cfg: PPOConfig, nets,
                             optimizer, device="cuda"):
    """Build ``update(traj, last_value, key) -> metrics``: GAE on (T, N*B);
    G = T * (B // c) (step, env-chunk) blocks of c envs
    (``ppo.state_block_size``, halved further for tiny batches): per group
    (G, n_g, c) labels and, for encode groups, (G, n_g, F_g, c) codes; the
    states' (G, c, ...) leaves; per epoch one permutation of the G blocks.
    A minibatch's loss: the encode groups' policies on their stored codes,
    the pixel groups' on a re-render of their observers from the
    minibatch's S = mb * c states, labels aligned to the render's (n_g, S)
    order, and ``ppo_hetero.group_loss``."""
    dev = resolve(device)
    groups = mixed_groups(env_params)
    B, T = cfg.n_envs, cfg.rollout_len
    tors = torsos(cfg, groups)
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    c = state_block_size(B, T)
    while B // c * T < cfg.n_minibatches and c % 2 == 0:
        c //= 2                                    # tiny batches
    Bc = B // c
    G = T * Bc
    if G < cfg.n_minibatches:
        raise ValueError(f"mixed hetero PPO: {G} blocks, fewer than "
                         f"{cfg.n_minibatches} minibatches")
    used = G // cfg.n_minibatches * cfg.n_minibatches
    params = [p for p in nets.parameters() if p.requires_grad]

    def blocks(traj, last_value):
        per_step = step_labels(traj, last_value, cfg, False)   # (T, N, B)
        out = {}
        for g, (idxs, gp) in enumerate(groups):
            n_g = len(idxs)
            for k in _LABELS:
                out[k, g] = label_rows(per_step[k], idxs).reshape(
                    T, n_g, Bc, c).permute(0, 2, 1, 3).reshape(G, n_g, c)
            if gp.observation_style == "encode":
                out["obs", g] = traj["obs"][g].reshape(
                    T, n_g, -1, Bc, c).permute(0, 3, 1, 2, 4).reshape(
                        G, n_g, -1, c)
        if pixels:
            # (T, B, ...) -> (G, c, ...): block (t, k) holds envs
            # k*c ... (k+1)*c - 1 of step t, the labels' block order
            out["state"] = traj["state"].map(
                lambda x: x.reshape((G, c) + x.shape[2:]))
        return out

    def loss_fn(batch):
        obs = None
        if pixels:
            with record_function("update.render"):
                st = batch["state"].map(
                    lambda x: x.reshape((-1,) + x.shape[2:]))
                obs = group_obs(env_params, groups, tors, st,
                                pixels_only=True)
        parts = []
        with record_function("update.forward"):
            for g, net in enumerate(nets):
                if groups[g][1].observation_style == "encode":
                    # stored codes (mb, n_g, F_g, c): logits (mb, n_g, c, A)
                    logits, value = net(batch["obs", g])
                    lab = {k: batch[k, g] for k in _LABELS}
                else:
                    # the re-render's (n_g, S, ...): labels (mb, n_g, c)
                    # to its (n_g, S) order
                    logits, value = net(*obs[g])
                    n_g = len(groups[g][0])
                    lab = {k: batch[k, g].transpose(0, 1).reshape(n_g, -1)
                           for k in _LABELS}
                parts.append((logits, value, lab))
            return ppo_hetero.group_loss(parts, cfg)

    def update(traj, last_value, key):
        with record_function("update.gae"):
            blocked = blocks(traj, last_value)
        return run_epochs(shuffled_blocks(blocked, G, used, cfg), loss_fn,
                          params, optimizer, key, cfg, dev)

    return update


def make_train_step_hetero_mixed(env_params: EnvParams, cfg: PPOConfig,
                                 nets, optimizer, device="cuda"):
    """Build ``train_step(env_state, key) -> (env_state, key, metrics)``:
    :func:`make_rollout_hetero_mixed` then :func:`make_update_hetero_mixed`
    with the JAX step's key plumbing (the update takes the key the rollout
    returns; the key after the step is ``fold_in(that key, 1)``), run
    eagerly; ``nets`` and ``optimizer`` are updated in place."""
    dev = resolve(device)
    rollout = make_rollout_hetero_mixed(env_params, cfg, nets, device=dev)
    update = make_update_hetero_mixed(env_params, cfg, nets, optimizer,
                                      device=dev)

    def train_step(env_state, key):
        env_state, key, traj, last_value = rollout(env_state, key)
        metrics = episode_metrics(update(traj, last_value, key), traj)
        return env_state, rng.fold_in(key, 1), metrics

    return train_step
