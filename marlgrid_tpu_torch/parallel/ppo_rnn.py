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
``PPOConfig.cell_unroll`` (the JAX scan's unroll factor) is accepted and
changes nothing: the cell loop is a Python loop. The shard_map variant waits
for ROADMAP Slice G.
"""
from __future__ import annotations

import warnings

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ..core import obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import resolve
from ..models import RecurrentActorCritic
from .ppo import (PPOConfig, _stack_states, aux_dim, episode_metrics,
                  make_optimizer, ppo_loss, rich_aux, run_epochs,
                  step_labels)

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


def _image_path(env_params: EnvParams, cfg: PPOConfig) -> bool:
    """Which path a configuration takes: False for encode with the mlp
    torso, True for image or rich observations with a pixels torso. Raises
    for what the recurrent family does not take, naming the ROADMAP slice
    that brings what the port lacks."""
    if cfg.rnn not in ("gru", "lstm"):
        raise ValueError(f"recurrent PPO: rnn={cfg.rnn!r}, want 'gru' or "
                         f"'lstm'")
    if env_params.has_hetero_obs:
        raise NotImplementedError(
            "heterogeneous per-agent obs groups (the hetero recurrent "
            "trainer): ROADMAP Slice E")
    style = env_params.observation_style
    if style == "encode":
        if cfg.torso != "mlp":
            raise ValueError(f"encode recurrent PPO uses the mlp "
                             f"feature-major path, not torso={cfg.torso!r}")
        return False
    if style not in ("image", "rich"):
        raise ValueError(f"recurrent PPO: unknown observation style "
                         f"{style!r}")
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
                     device="cuda"):
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
    labels on images. The stages run under the rollout's
    ``record_function`` labels.
    """
    dev = resolve(device)
    image = _image_path(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    L, _ = _windows(cfg)
    # board-pool size: the largest divisor of B not above cfg.board_pool
    K = max(k for k in range(1, min(cfg.board_pool, B) + 1) if B % k == 0)
    mask = _mask_carry_env0 if image else mask_carry_env1

    def obs_of(state):
        """(policy obs, rich features or None)."""
        with record_function("rollout.obs"):
            if not image:
                bm = obs_mod.all_agent_obs_b(env_params, state, bminor=True)
                return bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(
                    torch.uint8), None
            img = obs_mod.all_agent_obs_b(pov_params, state, s2d=s2d)
            return img, (rich_aux(env_params, state) if rich else None)

    @torch.no_grad()
    def rollout(env_state, h, key):
        key = key.to(dev)
        obs, aux = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        with record_function("rollout.fresh_pool"):
            fresh_b = step_mod.fresh_pool_tiled(env_params, fk, K, B)
        names = ("obs", "act", "logp", "val", "rew", "done", "ep_ret",
                 "ep_len", "ep_cyc")
        steps = {k: [] for k in names}
        h0s = []
        for t in range(T):
            if t % L == 0:
                h0s.append(h)             # the carry entering the window
            with record_function("rollout.policy"):
                logits, value, h = net(obs, h, aux)
            with record_function("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                a = rng.categorical(ak, logits)
                logp_a = F.log_softmax(logits, -1).gather(
                    -1, a[..., None])[..., 0]
            with record_function("rollout.env_step"):
                fresh_t = step_mod.rotate_fresh_batch(fresh_b, t)
                stepped, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state, a if image else a.T,
                        fresh_t, salt=t)
                h = mask(h, done, cfg.dtype)
            for k, v in zip(names, (
                    env_state if image else obs, a.to(torch.int32), logp_a,
                    value, rew if image else rew.T, done,
                    info["episode_return"], info["episode_length"],
                    info["episode_cycles"])):
                steps[k].append(v)
            env_state = stepped
            obs, aux = obs_of(env_state)
        with record_function("rollout.policy"):
            _, last_value, _ = net(obs, h, aux)
        traj = {k: _stack_states(v) if k == "obs" and image
                else torch.stack(v) for k, v in steps.items()}
        h0s = (tuple(torch.stack(x) for x in zip(*h0s))
               if isinstance(h, tuple) else torch.stack(h0s))
        return env_state, h, key, traj, h0s, last_value

    return rollout


def make_update_rnn(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                    device="cuda"):
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
    one batch, and ``ppo.ppo_loss``. The stages run under
    ``record_function`` labels: ``update.gae``, ``update.render``,
    ``update.forward``, ``update.cell`` (the cell loop), ``update.backward``
    and ``update.optimizer``.
    """
    dev = resolve(device)
    image = _image_path(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    B, N = cfg.n_envs, env_params.n_agents
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

    def blocks(traj, h0s, last_value):
        """GAE, then {name: (G, ...)} sequence blocks."""
        per_step = step_labels(traj, last_value, cfg, image)
        if image:
            def state_blk(x):                 # (T, B, ...) -> (G, L, c, ...)
                r = x.reshape((W, L, Gc, c) + x.shape[2:])
                perm = (0, 2, 1, 3) + tuple(range(4, r.dim()))
                return r.permute(perm).reshape((G, L, c) + x.shape[2:])

            out = {k: state_blk(v) for k, v in per_step.items()}
            out["obs"] = traj["obs"].map(state_blk)
            # h0s leaves (W, B, N, H): W and Gc adjacent
            out["h0"] = map_carry(
                lambda x: x.reshape((G, c) + x.shape[2:]), h0s)
        else:
            out = {k: v.reshape(W, L, N, Gc, c).permute(0, 3, 1, 2, 4)
                   .reshape(G, L, N, c) for k, v in per_step.items()}
            out["obs"] = traj["obs"].reshape(W, L, N, Fd, Gc, c).permute(
                0, 4, 1, 2, 3, 5).reshape(G, L, N, Fd, c)
            out["h0"] = map_carry(lambda x: x.reshape(
                W, N, Gc, c, -1).permute(0, 2, 1, 3, 4).reshape(G, N, c, -1),
                h0s)
        out["done"] = traj["done"].reshape(W, L, Gc, c).permute(
            0, 2, 1, 3).reshape(G, L, c)
        return out

    def features(batch):
        """(L, mb, N, c, F') (encode) or (L, mb, c, N, F') (images)."""
        if not image:
            with record_function("update.forward"):
                return net.features(batch["obs"].transpose(0, 1).contiguous())
        mb = batch["done"].shape[0]
        with record_function("update.render"):
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
        with record_function("update.forward"):
            x = net.features(obs.reshape((N * S,) + obs.shape[2:]), aux)
            return x.reshape(N, L, mb, c, -1).permute(1, 2, 3, 0, 4)

    def loss_fn(batch):
        feats = features(batch)
        done_t = batch["done"].transpose(0, 1)           # (L, mb, c)
        mask = _mask_carry_env0 if image else mask_carry_env1
        with record_function("update.cell"):
            h, ys = batch["h0"], []
            for t in range(L):
                h, y = net.cell_step(feats[t], h)
                h = mask(h, done_t[t], dtype)
                ys.append(y)
        with record_function("update.forward"):
            logits, value = net.heads(torch.stack(ys))
            # labels arrive (mb, L, ...): to the logits' (L, mb, ...)
            lab = {k: batch[k].transpose(0, 1) for k in _LABELS}
            return ppo_loss(logits, value, lab, cfg)

    def update(traj, h0s, last_value, key):
        with record_function("update.gae"):
            blocked = blocks(traj, h0s, last_value)
        if used < G:
            warnings.warn(
                f"recurrent PPO minibatching: {G} sequence blocks do not "
                f"divide into {cfg.n_minibatches} minibatches; dropping "
                f"{G - used} block(s) (~{100 * (G - used) / G:.1f}% of each "
                f"epoch's data). Pick n_minibatches dividing {G} to use all "
                f"of it.", stacklevel=3)
        return run_epochs(blocked, G, used, loss_fn, params, optimizer, key,
                          cfg, dev)

    return update


def make_train_step_rnn(env_params: EnvParams, cfg: PPOConfig, net,
                        optimizer, device="cuda"):
    """Build ``train_step(env_state, h, key) -> (env_state, h, key,
    metrics)``, the JAX ``make_train_step_rnn`` on one device (encode/mlp,
    or image/rich with a pixels torso): :func:`make_rollout_rnn` then
    :func:`make_update_rnn`, with the JAX step's key plumbing (the update
    takes the key the rollout returns; the key after the step is
    ``fold_in(that key, 1)``). ``net`` and ``optimizer`` (from
    :func:`init_state_rnn`) are updated in place; ``metrics`` are the
    update's and ``ppo.episode_metrics`` of the rollout."""
    dev = resolve(device)
    rollout = make_rollout_rnn(env_params, cfg, net, device=dev)
    update = make_update_rnn(env_params, cfg, net, optimizer, device=dev)

    def train_step(env_state, h, key):
        env_state, h, key, traj, h0s, last_value = rollout(env_state, h, key)
        metrics = episode_metrics(update(traj, h0s, last_value, key), traj)
        return env_state, h, rng.fold_in(key, 1), metrics

    return train_step


def make_train_step_rnn_shard_map(*args, **kwargs):
    """The explicit-collective (shard_map) variant of the JAX package; not
    in the port yet."""
    raise NotImplementedError("the recurrent shard_map train step comes "
                              "with ROADMAP Slice G (multi-device)")


def multi_step_rnn(step_fn, k: int):
    """``k`` train steps per call, a Python loop (the JAX ``multi_step_rnn``
    scans them in one program): ``fn(env_state, h, key) -> (env_state, h,
    key, metrics of the last step)``."""
    def fn(env_state, h, key):
        for _ in range(k):
            env_state, h, key, metrics = step_fn(env_state, h, key)
        return env_state, h, key, metrics

    return fn
