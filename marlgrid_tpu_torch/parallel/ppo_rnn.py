"""Recurrent PPO (PyTorch port): a GRU or LSTM policy on the batched env.

Counterpart of ``marlgrid_tpu/parallel/ppo_rnn.py`` on one device, for its
two paths:

- encode observations with the mlp torso: feature-major ``(N, 3*vs*vs, B)``
  uint8 codes end to end and carry leaves ``(N, B, H)``, as the feedforward
  encode path stores them;
- image and 'rich' observations with the 'cnn_s2d' or 'cnn_image' torso:
  the rollout renders every step (kernels K1 and K3), the trajectory stores
  the pre-step ``EnvState``, each minibatch re-renders its windows'
  observations (and ``rich_aux``), and the carry leaves are ``(B, N, H)``.

Both follow the JAX recipe. The rollout and the update drive the same
per-step function (``RecurrentActorCritic``), so at unchanged weights the
update's recomputed log-probs equal the rollout's (``ratio_dev`` ~ 0). The
T-step sequences split into W windows of L = ``bptt_window`` steps (L = T by
default); the rollout stores the carry entering each window and the update
re-runs every window from it, so gradients stop at window boundaries.
Minibatches are whole (window, env-chunk) sequence blocks; the update runs
the torso and the heads over all L steps of a minibatch in one batch and
loops only the cell. A done flag zeroes the carry of its env after the
step, in the rollout and in the update alike.

The network and the optimizer are stateful torch objects: the step
functions update them in place and take and return ``(env_state, h, key)``,
where the JAX step functions take and return params and opt_state too.
``make_train_step_rnn(..., jit=True)`` and ``multi_step_rnn`` run the step
as one CUDA graph on the card (``parallel/graph.py``).
``PPOConfig.cell_unroll`` (the JAX scan's unroll factor) is accepted and
changes nothing: the cell loop is a Python loop.
``make_train_step_rnn_shard_map`` is the explicit-collective variant over
the ranks of a ``parallel/mesh.py`` Mesh (encode only, as in JAX): each rank
trains on its envs and its slice of the carry, which no collective touches.
``make_train_step_rnn(..., mesh=...)`` is the JAX GSPMD step on both paths:
the ranks compute the unsharded step of the global batch together, each
keeping its slice of the carry through the rollout.
"""
from __future__ import annotations

import warnings

import torch
from torch.nn import functional as F

from ..core import obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import resolve
from ..models import RecurrentActorCritic
from ..utils.profiling import stage
from .graph import GraphedStep
from .mesh import Mesh, gather_env
from .ppo import (PPOConfig, Share, _stack_states, aux_dim,
                  capture_error_mode, data_axis, episode_metrics, local_batch,
                  make_optimizer, multi_step, pool_size, ppo_loss, rich_aux,
                  run_epochs, sample_actions, shuffled_blocks, step_labels)

_LABELS = ("act", "logp", "val", "adv", "ret")


def map_carry(fn, h):
    """``fn`` on each leaf of a carry (a tensor, or an LSTM's (c, h))."""
    return tuple(fn(x) for x in h) if isinstance(h, tuple) else fn(h)


def mask_carry_env1(h, done, dtype):
    """Zero the carry of the envs whose episode just ended (done (B,) or
    (mb, c), shared by the env's agents), for carry layouts with the env
    batch on dim 1: rollout leaves (N, B, H), update leaves (mb, N, c, H).
    The multiply runs in ``dtype``, the carry's."""
    keep = (~done).to(dtype)
    return map_carry(lambda x: x * keep[..., None, :, None]
                     if x.dim() == 4 else x * keep[None, :, None], h)


def _mask_carry_env0(h, done, dtype):
    """The same for the image path's env-leading carries: (B, N, H) with
    done (B,), or (mb, c, N, H) with done (mb, c)."""
    keep = (~done).to(dtype)[..., None, None]
    return map_carry(lambda x: x * keep, h)


def _image_path(env_params: EnvParams, cfg: PPOConfig,
                axis: Mesh = None) -> bool:
    """Which path a configuration takes: False for encode with the mlp
    torso, True for image or rich observations with a pixels torso. Raises
    for what the recurrent family does not take (with ``axis``, the image
    path, as the JAX step asserts)."""
    if cfg.rnn not in ("gru", "lstm"):
        raise ValueError(f"recurrent PPO: rnn={cfg.rnn!r}, want 'gru' or "
                         f"'lstm'")
    if env_params.has_hetero_obs:
        raise ValueError(
            "heterogeneous per-agent obs groups train through "
            "parallel/ppo_hetero_rnn.py, not the shared-policy recurrent "
            "step")
    style = env_params.observation_style
    if style == "encode":
        if cfg.torso != "mlp":
            raise ValueError(f"encode recurrent PPO uses the mlp "
                             f"feature-major path, not torso={cfg.torso!r}")
        return False
    if style not in ("image", "rich"):
        raise ValueError(f"recurrent PPO: unknown observation style "
                         f"{style!r}")
    assert axis is None, \
        "image/rich recurrent PPO is the GSPMD path (no shard_map variant)"
    if cfg.torso not in ("cnn_s2d", "cnn_image"):
        raise ValueError(f"{style} recurrent PPO uses a cnn_s2d or cnn_image "
                         f"torso, not {cfg.torso!r}")
    return True


def _windows(cfg: PPOConfig):
    """(L, W): the truncated-BPTT window and the windows per rollout."""
    T = cfg.rollout_len
    L = cfg.bptt_window or T
    if T % L:
        raise ValueError(f"bptt_window {L} must divide rollout_len {T}")
    return L, T // L


def sequence_block_size(B: int, W: int, n_minibatches: int,
                        image: bool = False) -> int:
    """The env-chunk width ``c`` of the update's (window, env-chunk)
    sequence blocks (G = W * B // c of them).

    Encode (JAX ``ppo_rnn.py:237-243``): halve B while the half stays
    >= 128 and the env chunks number fewer than 64. Images
    (``ppo_rnn.py:503-507``): halve while the half stays >= 16 and
    ``W * (B // c) * 2 <= 8192``. Then, for tiny batches, halve while the
    blocks are fewer than the minibatches. At B = 4096 with one window:
    c = 128 (G = 32) and c = 16 (G = 256)."""
    c = B
    if image:
        while c % 2 == 0 and c // 2 >= 16 and W * (B // c) * 2 <= 8192:
            c //= 2
    else:
        while c % 2 == 0 and c // 2 >= 128 and B // c < 64:
            c //= 2
    while W * (B // c) < n_minibatches and c % 2 == 0:
        c //= 2
    return c


def init_state_rnn(env_params: EnvParams, cfg: PPOConfig, generator=None,
                   device="cuda"):
    """``(net, optimizer, h)`` for the recurrent shared policy: the
    RecurrentActorCritic with weights drawn from ``generator`` (the JAX
    package draws them from a key), Adam as ``ppo.init_state`` makes it, and
    the zero carry of the whole batch, which is part of the training state
    from here on (train loop, checkpoints). Encode obs: the mlp torso,
    carry leaves (N, B, H); image/rich obs: a pixels torso, carry leaves
    (B, N, H)."""
    image = _image_path(env_params, cfg)
    rich = env_params.observation_style == "rich"
    net = RecurrentActorCritic(cfg, env_params.view_size, generator,
                               device=device,
                               tile_size=env_params.view_tile_size,
                               aux_dim=aux_dim(env_params) if rich else 0)
    N, B = env_params.n_agents, cfg.n_envs
    h = net.initial_carry((B, N) if image else (N, B))
    return net, make_optimizer(net, cfg), h


def make_rollout_rnn(env_params: EnvParams, cfg: PPOConfig, net,
                     device="cuda", axis: Mesh = None, mesh: Mesh = None):
    """Build ``rollout(env_state, h, key) -> (env_state, h, key, traj, h0s,
    last_value)``, the JAX ``rollout`` of ``make_train_step_rnn`` (one
    device).

    Per step t: the policy acts on the observation and the carry, actions
    come from ``categorical`` under the step's key, the envs step with the
    pool autoreset (``board_pool`` layouts, rotated by t, salt t), and the
    done flags zero the carry. ``h0s`` stacks the carry entering each of
    the W windows: (W, N, B, H) leaves on encode, (W, B, N, H) on images.
    ``traj`` is :func:`ppo.make_rollout`'s: feature-major codes (T, N, F, B)
    and (T, N, B) labels on encode; the pre-step EnvStates and (T, B, N)
    labels on images. The stages run under the rollout's stage spans
    (``ppo.make_rollout``). ``axis``: on this rank's B = n_envs / D
    envs and carry, with ``ppo.make_rollout``'s three changes (the rank
    folded into the fresh-board key, per-env action keys from the global
    env index, the global env offset). ``mesh``: on this rank's B envs and
    carry, with ``ppo.make_rollout``'s mesh changes (this rank's rows of
    the unsharded rollout of the global batch); the carry never leaves
    the rank.
    """
    dev = resolve(device)
    image = _image_path(env_params, cfg, axis)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    shards = data_axis(axis, mesh)
    B, T, N = local_batch(cfg, shards), cfg.rollout_len, env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    L, _ = _windows(cfg)
    K = pool_size(cfg, cfg.n_envs if mesh is not None else B)
    offset = 0 if shards is None else shards.data_index * B
    pool_offset = offset if mesh is not None else 0
    mask = _mask_carry_env0 if image else mask_carry_env1

    def obs_of(state):
        """(policy obs, rich features or None)."""
        with stage("rollout.obs"):
            if not image:
                bm = obs_mod.all_agent_obs_b(env_params, state, bminor=True)
                return bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(
                    torch.uint8), None
            img = obs_mod.all_agent_obs_b(pov_params, state, s2d=s2d)
            return img, (rich_aux(env_params, state) if rich else None)

    @torch.no_grad()
    @stage("rollout")
    def rollout(env_state, h, key):
        key = key.to(dev)
        obs, aux = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        if axis is not None:
            fk = rng.fold_in(fk, axis.data_index)
        with stage("rollout.fresh_pool"):
            pool = step_mod.fresh_pool(env_params, fk, K)
        names = ("obs", "act", "logp", "val", "rew", "done", "ep_ret",
                 "ep_len", "ep_cyc")
        steps = {k: [] for k in names}
        h0s = []
        for t in range(T):
            if t % L == 0:
                h0s.append(h)             # the carry entering the window
            with stage("rollout.policy"):
                logits, value, h = net(obs, h, aux)
            with stage("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                a = sample_actions(ak, logits, axis, B, 0 if image else 1,
                                   mesh)
                logp_a = F.log_softmax(logits, -1).gather(
                    -1, a[..., None])[..., 0]
            with stage("rollout.env_step"):
                fresh_t = step_mod.fresh_pool_rows(pool, t, pool_offset, B)
                stepped, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state, a if image else a.T,
                        fresh_t, env_offset=offset, salt=t)
                h = mask(h, done, cfg.dtype)
            with stage("rollout.store"):
                for k, v in zip(names, (
                        env_state if image else obs, a.to(torch.int32),
                        logp_a, value, rew if image else rew.T, done,
                        info["episode_return"], info["episode_length"],
                        info["episode_cycles"])):
                    steps[k].append(v)
            env_state = stepped
            obs, aux = obs_of(env_state)
        with stage("rollout.policy"):
            _, last_value, _ = net(obs, h, aux)
        with stage("rollout.store"):
            traj = {k: _stack_states(v) if k == "obs" and image
                    else torch.stack(v) for k, v in steps.items()}
            h0s = (tuple(torch.stack(x) for x in zip(*h0s))
                   if isinstance(h, tuple) else torch.stack(h0s))
        return env_state, h, key, traj, h0s, last_value

    return rollout


def make_update_rnn(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                    device="cuda", axis: Mesh = None, mesh: Mesh = None):
    """Build ``update(traj, h0s, last_value, key) -> metrics``, the update
    half of the JAX ``make_train_step_rnn``: GAE on (T, N*B) (encode) or
    (T, B*N) (images), the trajectory cut into G = W * (B // c) sequence
    blocks of L steps and c envs (:func:`sequence_block_size`), each with
    its stored entry carry, and ``ppo.run_epochs`` over them (the JAX
    epoch/minibatch loop; blocks that do not divide into the minibatches are
    dropped with a warning). ``metrics`` are 0-d device tensors.

    The loss of a minibatch of mb blocks: the torso over all L steps in one
    batch (encode: the (L, mb, N, F, c) codes as R = L*mb*N rows of c
    samples; images: the L*mb*c stored states re-rendered ``bminor``, K1
    and K3, with ``rich_aux``), the cell stepped L times from the blocks'
    stored carries with the done masking, the heads over all L outputs in
    one batch, and ``ppo.ppo_loss``. The update runs under the stage span
    ``update``, its stages under their own: ``update.gae``,
    ``update.minibatch``, ``update.render``, ``update.forward``,
    ``update.cell`` (the cell loop), ``update.backward``,
    ``update.all_reduce`` and ``update.optimizer``. ``axis``: on this
    rank's blocks, with the advantage statistics and the gradients over the
    data axis (``ppo.ppo_loss``, ``ppo.run_epochs``). ``mesh``: the
    unsharded update of the global batch, as ``ppo.make_update``'s mesh
    path computes it: the rank's trajectory, labels and window-entry
    carries gathered in global env order (``update.all_gather``), the
    global sequence blocks (c from the global B), and each minibatch's
    blocks split over the ranks (``ppo.Share``), its gradients ``psum``'d.
    """
    dev = resolve(device)
    image = _image_path(env_params, cfg, axis)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    shards = data_axis(axis, mesh)
    # the blocks are cut from the global trajectory under a mesh
    B = cfg.n_envs if mesh is not None else local_batch(cfg, shards)
    N = env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    L, W = _windows(cfg)
    c = sequence_block_size(B, W, cfg.n_minibatches, image)
    Gc = B // c
    G = W * Gc
    if G < cfg.n_minibatches:
        raise ValueError(f"fewer sequence blocks ({G}) than minibatches "
                         f"({cfg.n_minibatches})")
    used = (G // cfg.n_minibatches) * cfg.n_minibatches
    params = [p for p in net.parameters() if p.requires_grad]
    dtype = cfg.dtype
    share, reduce = None, None if axis is None else axis.pmean
    if mesh is not None:
        # loss terms (L, mb, N, c) on encode, (L, mb, c, N) on images
        share = Share(mesh, used // cfg.n_minibatches, L * c * N,
                      lambda w: w[None, :, None, None], dev)
        reduce = mesh.psum

    def blocks(traj, h0s, last_value):
        """GAE, then {name: (G, ...)} sequence blocks (under a mesh, of the
        global trajectory, gathered from every rank first)."""
        per_step = step_labels(traj, last_value, cfg, image)
        obs, done = traj["obs"], traj["done"]
        if mesh is not None:
            with stage("update.all_gather"):
                per_step, obs, done, h0s = gather_env(mesh, [
                    (per_step, 1 if image else 2), (obs, 1 if image else 3),
                    (done, 1), (h0s, 1 if image else 2)])
        if image:
            def state_blk(x):                 # (T, B, ...) -> (G, L, c, ...)
                r = x.reshape((W, L, Gc, c) + x.shape[2:])
                perm = (0, 2, 1, 3) + tuple(range(4, r.dim()))
                return r.permute(perm).reshape((G, L, c) + x.shape[2:])

            out = {k: state_blk(v) for k, v in per_step.items()}
            out["obs"] = obs.map(state_blk)
            # h0s leaves (W, B, N, H): W and Gc adjacent
            out["h0"] = map_carry(
                lambda x: x.reshape((G, c) + x.shape[2:]), h0s)
        else:
            out = {k: v.reshape(W, L, N, Gc, c).permute(0, 3, 1, 2, 4)
                   .reshape(G, L, N, c) for k, v in per_step.items()}
            out["obs"] = obs.reshape(W, L, N, Fd, Gc, c).permute(
                0, 4, 1, 2, 3, 5).reshape(G, L, N, Fd, c)
            out["h0"] = map_carry(lambda x: x.reshape(
                W, N, Gc, c, -1).permute(0, 2, 1, 3, 4).reshape(G, N, c, -1),
                h0s)
        out["done"] = done.reshape(W, L, Gc, c).permute(
            0, 2, 1, 3).reshape(G, L, c)
        return out

    def features(batch):
        """(L, mb, N, c, F') (encode) or (L, mb, c, N, F') (images)."""
        if not image:
            with stage("update.forward"):
                return net.features(batch["obs"].transpose(0, 1).contiguous())
        mb = batch["done"].shape[0]
        with stage("update.render"):
            # the stored states in (L, mb, c) order: the render reshapes
            # straight into the cell loop's step slices
            st = batch["obs"].map(lambda x: x.transpose(0, 1).reshape(
                (-1,) + x.shape[3:]))
            obs = obs_mod.all_agent_obs_b(pov_params, st, bminor=True,
                                          s2d=s2d)        # (N, S, ...)
            S = obs.shape[1]
            aux = rich_aux(env_params, st) if rich else None   # (S, N, d)
            if aux is not None:
                aux = aux.permute(1, 0, 2).reshape(N * S, -1)
        with stage("update.forward"):
            x = net.features(obs.reshape((N * S,) + obs.shape[2:]), aux)
            return x.reshape(N, L, mb, c, -1).permute(1, 2, 3, 0, 4)

    def loss_fn(batch):
        feats = features(batch)
        done_t = batch["done"].transpose(0, 1)           # (L, mb, c)
        mask = _mask_carry_env0 if image else mask_carry_env1
        with stage("update.cell"):
            h, ys = batch["h0"], []
            for t in range(L):
                h, y = net.cell_step(feats[t], h)
                h = mask(h, done_t[t], dtype)
                ys.append(y)
        with stage("update.forward"):
            logits, value = net.heads(torch.stack(ys))
            # labels arrive (mb, L, ...): to the logits' (L, mb, ...)
            lab = {k: batch[k].transpose(0, 1) for k in _LABELS}
            return ppo_loss(logits, value, lab, cfg, axis, share)

    @stage("update")
    def update(traj, h0s, last_value, key):
        with stage("update.gae"):
            blocked = blocks(traj, h0s, last_value)
        if used < G:
            warnings.warn(
                f"recurrent PPO minibatching: {G} sequence blocks do not "
                f"divide into {cfg.n_minibatches} minibatches; dropping "
                f"{G - used} block(s) (~{100 * (G - used) / G:.1f}% of each "
                f"epoch's data). Pick n_minibatches dividing {G} to use all "
                f"of it.", stacklevel=3)
        return run_epochs(shuffled_blocks(blocked, G, used, cfg, share),
                          loss_fn, params, optimizer, key, cfg, dev, reduce)

    return update


def make_train_step_rnn(env_params: EnvParams, cfg: PPOConfig, net,
                        optimizer, device="cuda", jit=True, axis: Mesh = None,
                        mesh: Mesh = None):
    """Build ``train_step(env_state, h, key) -> (env_state, h, key,
    metrics)``, the JAX ``make_train_step_rnn`` on one device (encode/mlp,
    or image/rich with a pixels torso): :func:`make_rollout_rnn` then
    :func:`make_update_rnn`, with the JAX step's key plumbing (the update
    takes the key the rollout returns; the key after the step is
    ``fold_in(that key, 1)``). ``net`` and ``optimizer`` (from
    :func:`init_state_rnn`) are updated in place; ``metrics`` are the
    update's and ``ppo.episode_metrics`` of the rollout. ``jit`` as in
    ``ppo.make_train_step``: True (the default) gives one CUDA graph of the
    whole step on the card, its returned tensors donated; False the raw
    eager step. ``axis``: the per-rank step of
    :func:`make_train_step_rnn_shard_map`. ``mesh``: the JAX ``mesh=``
    (GSPMD) step, on the encode and the image/rich paths alike: this
    rank's part of the step over the global batch, as in
    ``ppo.make_train_step``, on its envs (``init_env_batch(...,
    mesh=mesh)``) and its slice of the carry (:func:`carry_env_dim`),
    which stays on the rank; truncated BPTT works under it."""
    shards = data_axis(axis, mesh)
    dev = resolve(device)
    rollout = make_rollout_rnn(env_params, cfg, net, device=dev, axis=axis,
                               mesh=mesh)
    update = make_update_rnn(env_params, cfg, net, optimizer, device=dev,
                             axis=axis, mesh=mesh)

    def train_step(env_state, h, key):
        env_state, h, key, traj, h0s, last_value = rollout(env_state, h, key)
        metrics = episode_metrics(update(traj, h0s, last_value, key), traj,
                                  shards)
        return env_state, h, rng.fold_in(key, 1), metrics

    train_step.capture_error_mode = capture_error_mode(shards)
    if jit:
        name = ("ppo_rnn.make_train_step_rnn_shard_map" if axis is not None
                else "ppo_rnn.make_train_step_rnn"
                + ("(mesh=...)" if mesh is not None else ""))
        return GraphedStep(train_step, name, train_step.capture_error_mode)
    return train_step


def carry_env_dim(env_params: EnvParams, cfg: PPOConfig) -> int:
    """The env axis of a carry leaf: 1 for the encode path's (N, B, H), 0
    for the image path's (B, N, H); a rank holds its envs' slice of it."""
    return 0 if _image_path(env_params, cfg) else 1


def make_train_step_rnn_shard_map(env_params: EnvParams, cfg: PPOConfig,
                                  net, optimizer, mesh: Mesh, jit=True,
                                  device="cuda"):
    """The explicit-collective recurrent step, the JAX
    ``make_train_step_rnn_shard_map`` (encode obs with the mlp torso):
    ``train_step(env_state, h, key) -> (env_state, h, key, metrics)`` on
    this rank's envs (``init_env_batch(..., mesh=mesh)``) and this rank's
    slice of the carry (leaves (N, B / D, H), ``parallel/mesh.py``'s
    ``shard(mesh, h, 1)``), which stays local to the rank: no collective
    touches it. The rollout,
    the loss, the update and the metrics change as in
    ``ppo.make_train_step_shard_map``; truncated BPTT (``bptt_window``)
    works under the mesh. ``jit`` as there."""
    return make_train_step_rnn(env_params, cfg, net, optimizer,
                               device=resolve(device), jit=jit, axis=mesh)


def multi_step_rnn(step_fn, k: int):
    """``ppo.multi_step`` for the recurrent signature (``h`` rides the
    carry): ``fn(env_state, h, key) -> (env_state, h, key, metrics of the
    last step)``, the raw step ``step_fn`` (``jit=False``) captured once on
    the card and replayed k times per call."""
    return multi_step(step_fn, k)
