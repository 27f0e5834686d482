"""Mixed-style heterogeneous PPO (PyTorch port): encode, image and rich
observation groups training together.

Counterpart of ``marlgrid_tpu/parallel/ppo_hetero_mixed.py`` on one device.
The reference lets every agent pick its own ``observation_style``: one agent
can learn from symbolic codes while another learns from rendered pixels.

- The board is painted once per step with the prestige levels
  (``with_lvl=True``; the encode renders ignore them) and every group
  renders only its own observers against it: encode groups through the
  feature-major window extraction (kernel K1), image and rich groups
  through the sprite composite (K1, then K3).
- Per-group torsos (:func:`group_cfg`): mlp for encode groups, 'cnn_s2d' or
  'cnn_image' for pixel groups, rich groups with their observe_* features
  after the conv flatten.
- The trajectory stores each encode group's uint8 codes and, when a group
  needs pixels, the pre-step EnvStates once; the update re-renders each
  minibatch's pixel observations from the stored states.
- Minibatches are (step, env-chunk) blocks shared by every group (the
  EnvState store's granularity, ``ppo.state_block_size``), under one
  permutation; the advantages are normalized over the union of the groups'
  samples (``ppo_hetero.group_loss``).

Feedforward only: recurrent hetero training is encode-only
(``ppo_hetero_rnn.py``). ``make_train_step_hetero_mixed(..., mesh=...)`` is
the JAX GSPMD step: the update gathers the codes and the EnvState store in
global env order, and each rank re-renders only its share of a
minibatch's blocks.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.state import EnvParams
from ..device import resolve
from ..models import ActorCritic
from ..utils.profiling import stage
from ..vector import obs_groups
from .mesh import Mesh, gather_env
from .ppo import (PPOConfig, Share, aux_dim, episode_metrics, make_optimizer,
                  run_epochs, shuffled_blocks, state_block_size, step_labels)
from .ppo_hetero import (_LABELS, graphed, group_loss, group_obs, label_rows,
                         make_rollout_hetero, styled, warn_dropped)


def mixed_groups(env_params: EnvParams):
    """The trainable observation groups (any mix of encode, image and rich
    styles); exits naming the agents of a group with another style."""
    groups = obs_groups(env_params)
    for idxs, gp in groups:
        if gp.observation_style not in ("encode", "image", "rich"):
            raise SystemExit(
                f"mixed hetero PPO: agents {list(idxs)} use unsupported "
                f"style {gp.observation_style!r}")
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
        torso = "cnn_image"            # s2d needs a block-4 side
    return dataclasses.replace(cfg, torso=torso)


def init_state_hetero_mixed(env_params: EnvParams, cfg: PPOConfig,
                            generator=None, device="cuda"):
    """``(nets, optimizer)``: one style-appropriate ActorCritic per
    observation group (:func:`group_cfg`) in a ``ModuleList``, weights
    drawn from ``generator`` group after group, and Adam over all of
    them."""
    if not env_params.has_hetero_obs:
        raise ValueError("init_state_hetero_mixed: the params hold no "
                         "per-agent observation configs")
    nets = torch.nn.ModuleList()
    for _, gp in mixed_groups(env_params):
        rich = gp.observation_style == "rich"
        nets.append(ActorCritic(group_cfg(cfg, gp), gp.view_size, generator,
                                device=device, tile_size=gp.view_tile_size,
                                aux_dim=aux_dim(gp) if rich else 0))
    return nets, make_optimizer(nets, cfg)


def _torsos(cfg: PPOConfig, groups):
    return [group_cfg(cfg, gp).torso for _, gp in groups]


def make_rollout_hetero_mixed(env_params: EnvParams, cfg: PPOConfig, nets,
                              device="cuda", mesh: Mesh = None):
    """``ppo_hetero.make_rollout_hetero`` for a mixed population: the
    encode groups' codes and, with any pixel group, the pre-step
    EnvStates stored (``mesh``: on this rank's envs, as there)."""
    groups = mixed_groups(env_params)
    if len(nets) != len(groups):
        raise ValueError(f"{len(nets)} nets for {len(groups)} observation "
                         f"groups")
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    return make_rollout_hetero(env_params, cfg, nets, device=device,
                               groups=groups, torsos=_torsos(cfg, groups),
                               store_states=pixels, mesh=mesh)


def make_update_hetero_mixed(env_params: EnvParams, cfg: PPOConfig, nets,
                             optimizer, device="cuda", mesh: Mesh = None):
    """Build ``update(traj, last_value, key) -> metrics``, the update half
    of the JAX ``make_train_step_hetero_mixed``: GAE on (T, N*B); G =
    T * (B // c) (step, env-chunk) blocks of c envs
    (``ppo.state_block_size``, halved further for tiny batches): per group
    (G, n_g, c) labels and, for encode groups, (G, n_g, F_g, c) codes; the
    states' (G, c, ...) leaves; per epoch one permutation of the G blocks.
    A minibatch's loss: the encode groups' policies on their stored codes,
    the pixel groups' on a re-render of their observers from the
    minibatch's S = mb * c states (one board painted with the levels; K1
    and K3 once per pixel group), labels aligned to the render's (n_g, S)
    order, and ``ppo_hetero.group_loss``. Each group's forward runs in the
    stage ``update.forward.encode`` or ``update.forward.pixels``
    (``ppo_hetero.styled``); the union's loss in ``update.forward`` itself.
    The backward is not split by style: autograd runs it as one call for
    every group, in ``update.backward``.

    ``mesh``: the unsharded update of the global batch, as
    ``ppo.make_update``'s mesh path: the labels, the encode groups' codes
    and the stored states gathered in global env order (one all-gather),
    the global trajectory's blocks (c and G from the global B), the same
    permutation on every rank, and each minibatch's blocks split over the
    ranks (``ppo.Share``): a rank re-renders the pixel groups of its
    ``ceil(mb / D)`` blocks only, and the union's statistics and the
    gradients are ``psum``'d."""
    dev = resolve(device)
    groups = mixed_groups(env_params)
    B, T = cfg.n_envs, cfg.rollout_len
    torsos = _torsos(cfg, groups)
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    c = state_block_size(B, T)
    while B // c * T < cfg.n_minibatches and c % 2 == 0:
        c //= 2                                    # tiny batches
    Bc = B // c
    G = T * Bc
    if G < cfg.n_minibatches:
        raise SystemExit(
            f"mixed hetero PPO: --rollout {T} x --envs {B} split into {G} "
            f"(step, env-chunk) blocks (chunks of {c} envs, halved while "
            f"even), fewer than --minibatches {cfg.n_minibatches}; pick "
            f"--envs with more factors of 2 or fewer minibatches")
    used = G // cfg.n_minibatches * cfg.n_minibatches
    params = [p for p in nets.parameters() if p.requires_grad]
    share = count = reduce = None
    if mesh is not None:
        # a block holds N * c samples; the weights are aligned per group
        share = Share(mesh, used // cfg.n_minibatches,
                      env_params.n_agents * c, lambda w: w, dev)
        count, reduce = share.count, mesh.psum

    def blocks(traj, last_value):
        per_step = step_labels(traj, last_value, cfg, False)   # (T, N, B)
        codes = {g: x for g, x in enumerate(traj["obs"]) if x is not None}
        states = traj.get("state")
        if mesh is not None:
            with stage("update.all_gather"):
                per_step, codes, states = gather_env(mesh, [
                    (per_step, 2), (codes, 3),
                    (() if states is None else states, 1)])
        out = {}
        for g, (idxs, gp) in enumerate(groups):
            n_g = len(idxs)
            for k in _LABELS:
                out[k, g] = label_rows(per_step[k], idxs).reshape(
                    T, n_g, Bc, c).permute(0, 2, 1, 3).reshape(G, n_g, c)
            if gp.observation_style == "encode":
                out["obs", g] = codes[g].reshape(
                    T, n_g, -1, Bc, c).permute(0, 3, 1, 2, 4).reshape(
                        G, n_g, -1, c)
        if pixels:
            # (T, B, ...) -> (G, c, ...): block (t, k) holds envs
            # k*c ... (k+1)*c - 1 of step t, the labels' block order
            out["state"] = states.map(
                lambda x: x.reshape((G, c) + x.shape[2:]))
        return out

    def loss_fn(batch):
        obs = None
        if pixels:
            with stage("update.render"):
                st = batch["state"].map(
                    lambda x: x.reshape((-1,) + x.shape[2:]))
                obs = group_obs(env_params, groups, torsos, st,
                                pixels_only=True)
        parts = []
        with stage("update.forward"):
            for g, net in enumerate(nets):
                with styled("update.forward", groups[g][1]):
                    if groups[g][1].observation_style == "encode":
                        # stored codes (mb, n_g, F_g, c): logits (mb, n_g,
                        # c, A)
                        logits, value = net(batch["obs", g])
                        lab = {k: batch[k, g] for k in _LABELS}
                        if share is not None:
                            lab["w"] = share.w[:, None, None]
                    else:
                        # the re-render's (n_g, S, ...): labels (mb, n_g,
                        # c) to its (n_g, S) order
                        logits, value = net(*obs[g])
                        n_g = len(groups[g][0])
                        lab = {k: batch[k, g].transpose(0, 1).reshape(
                            n_g, -1) for k in _LABELS}
                        if share is not None:
                            lab["w"] = share.w.repeat_interleave(c)
                parts.append((logits, value, lab))
            return group_loss(parts, cfg, mesh, count)

    @stage("update")
    def update(traj, last_value, key):
        with stage("update.gae"):
            blocked = blocks(traj, last_value)
        warn_dropped("mixed hetero PPO minibatching", G, used)
        return run_epochs(shuffled_blocks(blocked, G, used, cfg, share),
                          loss_fn, params, optimizer, key, cfg, dev, reduce)

    return update


def make_train_step_hetero_mixed(env_params: EnvParams, cfg: PPOConfig,
                                 nets, optimizer, device="cuda", jit=True,
                                 mesh: Mesh = None):
    """Build ``train_step(env_state, key) -> (env_state, key, metrics)``, the
    JAX ``make_train_step_hetero_mixed`` on one device:
    :func:`make_rollout_hetero_mixed` then :func:`make_update_hetero_mixed`,
    with the JAX step's key plumbing. ``nets`` and ``optimizer`` come from
    :func:`init_state_hetero_mixed` and are updated in place. ``jit`` as in
    ``ppo.make_train_step``: True (the default) gives one CUDA graph of the
    whole step on the card, its returned tensors donated; False the raw
    eager step (for ``ppo.multi_step``). ``mesh``: the JAX ``mesh=`` (GSPMD)
    step, as ``ppo_hetero.make_train_step_hetero``'s."""
    dev = resolve(device)
    rollout = make_rollout_hetero_mixed(env_params, cfg, nets, device=dev,
                                        mesh=mesh)
    update = make_update_hetero_mixed(env_params, cfg, nets, optimizer,
                                      device=dev, mesh=mesh)

    def train_step(env_state, key):
        env_state, key, traj, last_value, _ = rollout(env_state, key)
        metrics = episode_metrics(update(traj, last_value, key), traj, mesh)
        return env_state, rng.fold_in(key, 1), metrics

    return graphed(train_step,
                   "ppo_hetero_mixed.make_train_step_hetero_mixed", mesh, jit)
