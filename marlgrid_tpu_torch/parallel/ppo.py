"""PPO on the batched env (PyTorch port): config, env init, the rollout
and the update.

Counterpart of ``marlgrid_tpu/parallel/ppo.py`` on the encode/mlp path (the
JAX ``bm_store`` branch, one device): ``PPOConfig`` with the same fields and
dict round trip, ``init_env_batch``, ``init_state`` (the network and Adam
behind an optax-style global-norm clip), ``episode_metrics``, ``_gae``,
``make_rollout`` (the JAX ``rollout`` inside ``make_train_step``, a Python
loop in place of ``lax.scan``), ``make_update`` (the block-granular
minibatch update) and ``make_train_step`` (the two, with the JAX step's key
plumbing). Observations stay feature-major
``(N, 3*vs*vs, B)`` uint8 end to end: the policy reads them as they come
out of the obs pipeline, the trajectory stores them as they are, and the
update cuts them into ``(G, F, c)`` blocks without moving B off the last
axis. The network and the optimizer are stateful torch objects: the step
functions update them in place and take and return the env state and the
key, where the JAX step functions take and return params and opt_state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Tuple

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ..core import grid_gen, obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import resolve
from ..models import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX PPOConfig's fields and defaults; ``dtype`` is a torch dtype.
    See ``marlgrid_tpu/parallel/ppo.py`` for what each field does."""

    n_envs: int = 1024
    rollout_len: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    n_epochs: int = 2
    n_minibatches: int = 4
    max_grad_norm: float = 0.5
    hidden: int = 128
    channels: Tuple[int, ...] = (32, 64)
    torso: str = "mlp"
    rnn: str = ""
    cell_unroll: int = 1
    bptt_window: int = 0
    dtype: Any = torch.bfloat16
    embed_palettes: Any = None
    board_pool: int = 256
    recompute_image_obs: bool = True


def ppo_config_to_dict(cfg: PPOConfig) -> dict:
    """JSON-serializable PPOConfig (dtype dropped — it is a code choice,
    not run configuration)."""
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def ppo_config_from_dict(d: dict) -> PPOConfig:
    """Inverse of :func:`ppo_config_to_dict`."""
    names = {f.name for f in dataclasses.fields(PPOConfig)} - {"dtype"}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"PPOConfig from config.json: unknown fields "
                         f"{sorted(unknown)}")

    def detuple(v):
        return tuple(detuple(x) for x in v) if isinstance(v, list) else v

    return PPOConfig(**{k: detuple(v) for k, v in d.items()})


def init_env_batch(env_params: EnvParams, n_envs: int, key,
                   stagger: bool = True, device="cuda"):
    """Reset of ``n_envs`` envs from ``split(key, n_envs)``; ``stagger``
    spreads initial episode phases evenly over the batch (env i starts at
    step_count i*max_steps//B)."""
    keys = rng.split(key.to(resolve(device)), n_envs)
    state = grid_gen.reset(env_params, keys)
    if stagger:
        state = step_mod.stagger_step_counts(state, env_params.max_steps)
    return state


def init_state(env_params: EnvParams, cfg: PPOConfig, generator=None,
               device="cuda"):
    """``(net, optimizer)`` for the shared policy: the ActorCritic with
    weights drawn from ``generator`` (flax's initializers; the JAX package
    draws them from a key instead) and Adam at optax's defaults (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, single-tensor form). The
    update clips the gradients' global norm to ``cfg.max_grad_norm`` before
    each Adam step (:func:`clip_by_global_norm`), as optax's chain does."""
    if env_params.observation_style != "encode" or env_params.has_hetero_obs:
        raise NotImplementedError(
            "init_state: homogeneous encode observations only (image/rich "
            "obs: ROADMAP Slice C; hetero groups: Slice E)")
    net = ActorCritic(cfg, env_params.view_size, generator, device=device)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8, foreach=False)
    return net, opt


def clip_by_global_norm(grads, max_norm: float):
    """optax's ``clip_by_global_norm`` rule, in place and without a host
    sync: with ``g_norm`` the square root of the sum of every gradient's
    squares, each gradient ``t`` stays as it is if ``g_norm < max_norm``
    and becomes ``(t / g_norm) * max_norm`` otherwise. (torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead.)"""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def episode_metrics(metrics: Dict[str, torch.Tensor], traj):
    """Fold the rollout's per-step episode-completion tallies into mean
    return / length / cycle metrics, weighted by completed episodes (the
    JAX ``episode_metrics`` on one device)."""
    n_eps = traj["done"].float().sum()
    ep_ret = traj["ep_ret"].sum()
    ep_len = traj["ep_len"].float().sum()
    ep_cyc = traj["ep_cyc"].float().sum()
    some = n_eps > 0
    den = n_eps.clamp(min=1)
    zero = torch.zeros_like(n_eps)
    metrics["episode_return"] = torch.where(some, ep_ret / den, zero)
    metrics["episode_length"] = torch.where(some, ep_len / den, zero)
    metrics["episode_cycles"] = torch.where(some, ep_cyc / den, zero)
    metrics["n_episodes"] = n_eps
    return metrics


def _gae(rew, value, done, last_value, gamma: float, lam: float):
    """Generalized advantage estimation, a reverse loop over T (the JAX
    ``lax.scan(reverse=True)``): rew/value/done (T, M), last_value (M,)
    -> (adv, ret) (T, M). Episode boundaries (done) cut the bootstrap."""
    nonterm = 1.0 - done.float()
    adv = torch.empty_like(value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(rew.shape[0])):
        delta = rew[t] + gamma * next_value * nonterm[t] - value[t]
        gae = delta + gamma * lam * nonterm[t] * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


def make_rollout(env_params: EnvParams, cfg: PPOConfig, net, device="cuda"):
    """Build ``rollout(env_state, key) -> (env_state, key, traj,
    last_value)``, the JAX ``rollout`` of ``make_train_step`` on the
    encode/mlp path (one device, no shards).

    Per step t: the policy acts on the feature-major obs, actions come from
    ``categorical`` under the step's key, the envs step with the pool
    autoreset (``board_pool`` layouts, rotated by t, salt t). ``traj``
    leaves are stacked over T: ``obs`` (T, N, F, B) uint8, ``act``/
    ``logp``/``val``/``rew`` (T, N, B), ``done``/``ep_*`` (T, B).

    Each stage runs under a ``torch.profiler.record_function`` label
    (``rollout.fresh_pool``, ``.obs``, ``.policy``, ``.sample``,
    ``.env_step``), so a profiler trace attributes device time to it; with
    no profiler running a label costs about a microsecond.
    """
    dev = resolve(device)
    if env_params.observation_style != "encode" or env_params.has_hetero_obs:
        raise NotImplementedError(
            "make_rollout: homogeneous encode observations only (image/rich "
            "obs: ROADMAP Slice C; hetero groups: Slice E)")
    if cfg.torso != "mlp" or cfg.rnn:
        raise NotImplementedError(
            f"make_rollout: torso={cfg.torso!r} rnn={cfg.rnn!r}; the port "
            f"has the feedforward mlp torso (cnn: Slice C, rnn: Slice D)")
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    # board-pool size: the largest divisor of B not above cfg.board_pool
    K = max(k for k in range(1, min(cfg.board_pool, B) + 1) if B % k == 0)

    def obs_of(state):
        with record_function("rollout.obs"):
            bm = obs_mod.all_agent_obs_b(env_params, state, bminor=True)
            return bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(
                torch.uint8)

    @torch.no_grad()
    def rollout(env_state, key):
        key = key.to(dev)
        obs = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        with record_function("rollout.fresh_pool"):
            fresh_b = step_mod.fresh_pool_tiled(env_params, fk, K, B)
        names = ("obs", "act", "logp", "val", "rew", "done", "ep_ret",
                 "ep_len", "ep_cyc")
        steps = {k: [] for k in names}
        for t in range(T):
            with record_function("rollout.policy"):
                logits, value = net(obs)             # (N, B, A), (N, B)
            with record_function("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                a = rng.categorical(ak, logits)      # (N, B)
                logp_a = F.log_softmax(logits, -1).gather(
                    -1, a[..., None])[..., 0]
            with record_function("rollout.env_step"):
                fresh_t = step_mod.rotate_fresh_batch(fresh_b, t)
                env_state, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state, a.T, fresh_t, salt=t)
            for k, v in zip(names, (
                    obs, a.to(torch.int32), logp_a, value, rew.T, done,
                    info["episode_return"], info["episode_length"],
                    info["episode_cycles"])):
                steps[k].append(v)
            obs = obs_of(env_state)
        with record_function("rollout.policy"):
            _, last_value = net(obs)
        traj = {k: torch.stack(v) for k, v in steps.items()}
        return env_state, key, traj, last_value

    return rollout


def block_size(B: int, T: int, N: int) -> int:
    """The env-chunk width ``c`` of the update's minibatch blocks: halve B
    while the half stays >= 128 and the block count ``N*T*(B//c)`` stays
    <= 8192 after the halving (at B = 4096, T = 64, N = 4: c = 128 and
    G = 8192 blocks)."""
    c = B
    while c % 2 == 0 and c // 2 >= 128 and N * T * (B // c) * 2 <= 8192:
        c //= 2
    return c


def obs_blocks(obs: torch.Tensor, c: int) -> torch.Tensor:
    """Trajectory obs ``(T, N, F, B)`` -> the update's feature-major blocks
    ``(N*T*(B//c), F, c)``, one per (agent, step, env-chunk); B stays on
    the last axis."""
    T, N, Fd, B = obs.shape
    return obs.permute(1, 0, 2, 3).reshape(N * T, Fd, B // c, c).permute(
        0, 2, 1, 3).reshape(N * T * (B // c), Fd, c)


def make_update(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                device="cuda"):
    """Build ``update(traj, last_value, key) -> metrics``, the update half of
    the JAX ``make_train_step`` (``bm_store`` branch): GAE on (T, N*B),
    the feature-major (G, F, c) block layout, and per epoch a
    ``permutation(split(key)[1], G)`` cut into ``n_minibatches`` gathers
    of whole blocks, each a clipped-objective loss, a backward pass, the
    global-norm clip and an Adam step on ``net`` (in place). ``metrics``
    are 0-d device tensors: the means over every minibatch of ``loss``,
    ``pg_loss``, ``vf_loss``, ``entropy`` and ``ratio_dev``.

    The stages run under ``record_function`` labels (``update.gae``,
    ``update.forward``, ``update.backward``, ``update.optimizer``), as the
    rollout's do.
    """
    dev = resolve(device)
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    params = [p for p in net.parameters() if p.requires_grad]
    # feature-major blocks (G, F, c): G = N*T*(B//c) (agent, step,
    # env-chunk) blocks, envs on the last axis
    c = block_size(B, T, N)
    G = N * T * (B // c)
    if G < cfg.n_minibatches:
        raise ValueError(f"fewer trajectory blocks ({G}) than minibatches "
                         f"({cfg.n_minibatches})")
    used = (G // cfg.n_minibatches) * cfg.n_minibatches
    mb = used // cfg.n_minibatches
    eps = cfg.clip_eps

    def loss_fn(batch):
        with record_function("update.forward"):
            # blocks arrive feature-major (mb, F, c) uint8: logits
            # (mb, c, A), labels (mb, c)
            logits, value = net(batch["obs"])
            logp = F.log_softmax(logits, -1)
            logp_a = logp.gather(-1, batch["act"].long()[..., None])[..., 0]
            ratio = torch.exp(logp_a - batch["logp"])
            adv = batch["adv"]
            # the population std, as jnp.std
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            pg = -torch.minimum(ratio * adv,
                                torch.clamp(ratio, 1 - eps, 1 + eps) * adv
                                ).mean()
            v_clipped = batch["val"] + torch.clamp(value - batch["val"],
                                                   -eps, eps)
            vf = 0.5 * torch.maximum((value - batch["ret"]) ** 2,
                                     (v_clipped - batch["ret"]) ** 2).mean()
            ent = -(F.softmax(logits, -1) * logp).sum(-1).mean()
            total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
            # |ratio - 1| on the first minibatch of an update is a
            # row-alignment check: stored logp recomputed from stored obs
            # at the same weights must agree
            ratio_dev = (ratio - 1.0).abs().mean()
        return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent,
                           ratio_dev=ratio_dev)

    def update(traj, last_value, key):
        # fold agents into the batch: each agent is an independent sample;
        # trajectory leaves are (T, N, B)
        with record_function("update.gae"):
            rew = traj["rew"].reshape(T, N * B)
            val = traj["val"].reshape(T, N * B)
            done = traj["done"][:, None, :].expand(T, N, B).reshape(
                T, N * B)
            adv, ret = _gae(rew, val, done, last_value.reshape(-1),
                            cfg.gamma, cfg.gae_lambda)

            def blk(x):                       # (T, N, B) -> (G, c)
                return x.permute(1, 0, 2).reshape(G, c)

            blocked = dict(obs=obs_blocks(traj["obs"], c),
                           act=blk(traj["act"]),
                           logp=blk(traj["logp"]),
                           val=blk(val.reshape(T, N, B)),
                           adv=blk(adv.reshape(T, N, B)),
                           ret=blk(ret.reshape(T, N, B)))
        if used < G:
            warnings.warn(
                f"PPO minibatching: {G} trajectory blocks do not divide "
                f"into {cfg.n_minibatches} minibatches; dropping {G - used} "
                f"block(s) (~{100 * (G - used) / G:.1f}% of each epoch's "
                f"data). Pick n_minibatches dividing {G} to use all of it.",
                stacklevel=3)
        losses, auxs = [], []
        key = key.to(dev)
        for _ in range(cfg.n_epochs):
            ks = rng.split(key)
            key, pk = ks[0], ks[1]
            perm = rng.permutation(pk, G)
            for idx in perm[:used].reshape(cfg.n_minibatches, mb):
                # blocks are consumed whole: (mb, F, c) + (mb, c) labels
                batch = {k: v[idx] for k, v in blocked.items()}
                total, aux = loss_fn(batch)
                with record_function("update.backward"):
                    grads = torch.autograd.grad(total, params)
                with record_function("update.optimizer"):
                    for p, g in zip(params, grads):
                        p.grad = g
                    clip_by_global_norm(grads, cfg.max_grad_norm)
                    optimizer.step()
                losses.append(total.detach())
                auxs.append({k: v.detach() for k, v in aux.items()})
        metrics = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        metrics["loss"] = torch.stack(losses).mean()
        return metrics

    return update


def make_train_step(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                    device="cuda", overlap=False):
    """Build the rollout + update step, the JAX ``make_train_step`` on the
    encode/mlp path (one device): :func:`make_rollout` then
    :func:`make_update`, with the JAX step's key plumbing.

    ``overlap=False``: ``train_step(env_state, key) -> (env_state, key,
    metrics)``; the update takes the key the rollout returns, and the key
    after the step is ``fold_in(that key, 1)`` (the update's own key is
    dropped). ``overlap=True``: the pair ``(train_step_overlap,
    rollout_only)`` with ``rollout_only(env_state, key) -> (env_state,
    (traj, last_value), key)`` and ``train_step_overlap(env_state, prev,
    key) -> (env_state, (traj, last_value), key, metrics)``, where the
    update consumes the previous call's trajectory ``prev`` while this
    call's rollout collects the next (one iteration stale). ``net`` and
    ``optimizer`` (from :func:`init_state`) are updated in place.
    ``metrics`` are the update's and :func:`episode_metrics` of the
    rollout, as 0-d device tensors.
    """
    dev = resolve(device)
    rollout = make_rollout(env_params, cfg, net, device=dev)
    update = make_update(env_params, cfg, net, optimizer, device=dev)

    def train_step(env_state, key):
        env_state, key, traj, last_value = rollout(env_state, key)
        metrics = episode_metrics(update(traj, last_value, key), traj)
        return env_state, rng.fold_in(key, 1), metrics

    def rollout_only(env_state, key):
        """Priming call for the overlap variant: collect the first
        trajectory without an update."""
        env_state, key, traj, last_value = rollout(env_state, key)
        return env_state, (traj, last_value), rng.fold_in(key, 1)

    def train_step_overlap(env_state, prev, key):
        """The update consumes the PREVIOUS call's trajectory while this
        call's rollout collects the next, with the weights from before
        this call's update (the JAX overlap step's semantics)."""
        prev_traj, prev_last = prev
        ks = rng.split(key.to(dev))
        key, rk = ks[0], ks[1]
        env_state, _, traj, last_value = rollout(env_state, rk)
        metrics = episode_metrics(update(prev_traj, prev_last, key), traj)
        return env_state, (traj, last_value), rng.fold_in(key, 1), metrics

    if overlap:
        return train_step_overlap, rollout_only
    return train_step
