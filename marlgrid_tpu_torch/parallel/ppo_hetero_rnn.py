"""Heterogeneous recurrent PPO (PyTorch port): one GRU or LSTM policy per
observation group.

Counterpart of ``marlgrid_tpu/parallel/ppo_hetero_rnn.py`` on one device:
the all-encode hetero machinery of ``ppo_hetero.py`` crossed with the
recurrent machinery of ``ppo_rnn.py``.

- One ``RecurrentActorCritic`` (mlp torso) per observation group, all under
  one Adam optimizer and one clip. The carry is a per-group dict
  ``{g: (n_g, B, H) leaves}``, part of the training state (checkpointed by
  the train CLI).
- The rollout is ``ppo_hetero.make_rollout_hetero`` with the carries: one
  painted board per step, each group's observers rendered against it, the
  done flags zeroing the carries.
- The update re-runs every group's stored sequences from the carry that
  entered the rollout (full sequences: truncated BPTT stays with the
  homogeneous trainer). Minibatches are whole-sequence env-chunk blocks
  (``ppo_rnn.sequence_block_size`` with one window) under ONE permutation
  shared by the groups, because the done flags of a block belong to every
  group's agents of its envs; the advantages are normalized over the union
  of the groups' samples (``ppo_hetero.group_loss``).

``make_train_step_hetero_rnn(..., mesh=...)`` is the JAX GSPMD step: each
rank keeps its slice of the carry (leaves (n_g, B / D, H)) through the
rollout, and the update gathers the trajectory and the entry carry in
global env order and splits each minibatch's env chunks over the ranks.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.state import EnvParams
from ..device import resolve
from ..models import RecurrentActorCritic
from ..utils.profiling import stage
from .mesh import Mesh, gather_env
from .ppo import (PPOConfig, Share, episode_metrics, make_optimizer,
                  run_epochs, shuffled_blocks, step_labels)
from .ppo_hetero import (_LABELS, graphed, group_loss, hetero_groups,
                         label_rows, make_rollout_hetero, warn_dropped)
from .ppo_rnn import map_carry, mask_carry_env1, sequence_block_size


def _check(env_params: EnvParams, cfg: PPOConfig):
    if not env_params.has_hetero_obs:
        raise ValueError("hetero recurrent PPO: the params hold no "
                         "per-agent observation configs")
    if cfg.rnn not in ("gru", "lstm"):
        raise ValueError(f"hetero recurrent PPO: rnn={cfg.rnn!r}, want "
                         f"'gru' or 'lstm'")
    if cfg.torso != "mlp":
        raise SystemExit(f"hetero recurrent PPO trains encode obs on the "
                         f"mlp path, not torso={cfg.torso!r}")
    if cfg.bptt_window:
        raise SystemExit("--bptt-window is homogeneous-only; hetero "
                         "recurrent updates re-run full sequences")
    return hetero_groups(env_params)


def init_state_hetero_rnn(env_params: EnvParams, cfg: PPOConfig,
                          generator=None, device="cuda"):
    """``(nets, optimizer, h)``: one RecurrentActorCritic per observation
    group in a ``ModuleList`` (weights drawn from ``generator`` group after
    group), Adam over all of them, and the zero carry dict
    ``{g: (n_g, B, H)}``."""
    groups = _check(env_params, cfg)
    nets = torch.nn.ModuleList(
        RecurrentActorCritic(cfg, gp.view_size, generator, device=device)
        for _, gp in groups)
    h = {g: net.initial_carry((len(idxs), cfg.n_envs))
         for g, (net, (idxs, _)) in enumerate(zip(nets, groups))}
    return nets, make_optimizer(nets, cfg), h


def make_update_hetero_rnn(env_params: EnvParams, cfg: PPOConfig, nets,
                           optimizer, device="cuda", mesh: Mesh = None):
    """Build ``update(traj, h0, last_value, key) -> metrics``, the update
    half of the JAX ``make_train_step_hetero_rnn``: GAE on (T, N*B), the
    trajectory cut into Gc = B // c env-chunk blocks of whole sequences
    (per group: codes (Gc, T, n_g, F_g, c), the entry carry (Gc, n_g, c, H)
    and (Gc, T, n_g, c) labels; the done flags (Gc, T, c)), and
    ``ppo.run_epochs`` with one permutation of the Gc blocks per epoch. A
    minibatch's loss runs each group's torso over all T steps in one batch,
    its cell T times from the stored carries with the done masking, its
    heads over all T outputs, and ``ppo_hetero.group_loss`` over the
    groups.

    ``mesh``: the unsharded update of the global batch, as
    ``ppo_rnn.make_update_rnn``'s mesh path: the labels, every group's
    codes, the done flags and the entry carry gathered in global env order
    (one all-gather), the global env-chunk blocks (c from the global B), the
    same permutation on every rank, and each minibatch's chunks split over
    the ranks (``ppo.Share``), the union's statistics and the gradients
    ``psum``'d."""
    dev = resolve(device)
    groups = _check(env_params, cfg)
    B, T = cfg.n_envs, cfg.rollout_len
    c = sequence_block_size(B, 1, cfg.n_minibatches)
    Gc = B // c
    if Gc < cfg.n_minibatches:
        raise SystemExit(
            f"hetero recurrent PPO: --envs {B} splits into {Gc} env-chunk "
            f"blocks of whole sequences (chunks of {c} envs, halved while "
            f"even), fewer than --minibatches {cfg.n_minibatches}; pick "
            f"--envs with more factors of 2 or fewer minibatches")
    used = Gc // cfg.n_minibatches * cfg.n_minibatches
    params = [p for p in nets.parameters() if p.requires_grad]
    share = count = reduce = None
    if mesh is not None:
        # loss terms (T, mb, n_g, c); a block holds T * N * c samples
        share = Share(mesh, used // cfg.n_minibatches,
                      T * env_params.n_agents * c,
                      lambda w: w[None, :, None, None], dev)
        count, reduce = share.count, mesh.psum

    def blocks(traj, h0, last_value):
        per_step = step_labels(traj, last_value, cfg, False)   # (T, N, B)
        codes, done = tuple(traj["obs"]), traj["done"]
        if mesh is not None:
            with stage("update.all_gather"):
                per_step, codes, done, h0 = gather_env(mesh, [
                    (per_step, 2), (codes, 3), (done, 1), (h0, 1)])
        out = {"done": done.reshape(T, Gc, c).permute(1, 0, 2)}
        for g, (idxs, _) in enumerate(groups):
            n_g = len(idxs)
            out["obs", g] = codes[g].reshape(
                T, n_g, -1, Gc, c).permute(3, 0, 1, 2, 4)
            out["h0", g] = map_carry(lambda x: x.reshape(
                n_g, Gc, c, -1).permute(1, 0, 2, 3), h0[g])
            for k in _LABELS:
                out[k, g] = label_rows(per_step[k], idxs).reshape(
                    T, n_g, Gc, c).permute(2, 0, 1, 3)
        return out

    def loss_fn(batch):
        done_t = batch["done"].transpose(0, 1)            # (T, mb, c)
        parts = []
        for g, net in enumerate(nets):
            with stage("update.forward"):
                # (T, mb, n_g, F, c) codes -> (T, mb, n_g, c, H)
                feats = net.features(batch["obs", g].transpose(0, 1)
                                     .contiguous())
            with stage("update.cell"):
                h, ys = batch["h0", g], []
                for t in range(T):
                    h, y = net.cell_step(feats[t], h)
                    h = mask_carry_env1(h, done_t[t], cfg.dtype)
                    ys.append(y)
            with stage("update.forward"):
                logits, value = net.heads(torch.stack(ys))
                # labels arrive (mb, T, n_g, c): to the logits' (T, mb, ...)
                lab = {k: batch[k, g].transpose(0, 1) for k in _LABELS}
                if share is not None:
                    lab["w"] = share.w
                parts.append((logits, value, lab))
        with stage("update.forward"):
            return group_loss(parts, cfg, mesh, count)

    @stage("update")
    def update(traj, h0, last_value, key):
        with stage("update.gae"):
            blocked = blocks(traj, h0, last_value)
        warn_dropped("hetero recurrent PPO minibatching", Gc, used)
        return run_epochs(shuffled_blocks(blocked, Gc, used, cfg, share),
                          loss_fn, params, optimizer, key, cfg, dev, reduce)

    return update


def make_train_step_hetero_rnn(env_params: EnvParams, cfg: PPOConfig, nets,
                               optimizer, device="cuda", jit=True,
                               mesh: Mesh = None):
    """Build ``train_step(env_state, h, key) -> (env_state, h, key,
    metrics)``, the JAX ``make_train_step_hetero_rnn`` on one device: the
    rollout of ``ppo_hetero.make_rollout_hetero`` with the carries, then
    :func:`make_update_hetero_rnn` from the carry that entered it, with the
    JAX step's key plumbing. ``nets`` and ``optimizer`` come from
    :func:`init_state_hetero_rnn` and are updated in place. ``jit`` as in
    ``ppo.make_train_step``: True (the default) gives one CUDA graph of the
    whole step on the card, its returned tensors donated; False the raw
    eager step (for ``ppo_rnn.multi_step_rnn``). ``mesh``: the JAX
    ``mesh=`` (GSPMD) step, as ``ppo_hetero.make_train_step_hetero``'s, on
    this rank's envs and its slice of the carry (``parallel/mesh.py``'s
    ``shard(mesh, h[g], 1)``), which stays on the rank."""
    dev = resolve(device)
    _check(env_params, cfg)
    rollout = make_rollout_hetero(env_params, cfg, nets, device=dev,
                                  mesh=mesh)
    update = make_update_hetero_rnn(env_params, cfg, nets, optimizer,
                                    device=dev, mesh=mesh)

    def train_step(env_state, h, key):
        h0 = h
        env_state, key, traj, last_value, h = rollout(env_state, key, h)
        metrics = episode_metrics(update(traj, h0, last_value, key), traj,
                                  mesh)
        return env_state, h, rng.fold_in(key, 1), metrics

    return graphed(train_step, "ppo_hetero_rnn.make_train_step_hetero_rnn",
                   mesh, jit)
