"""PPO on the batched env (PyTorch port): config, env init, the rollout
and the update.

Counterpart of ``marlgrid_tpu/parallel/ppo.py`` on one device, for its two
feedforward paths:

- encode observations with the mlp torso (the JAX ``bm_store`` branch):
  observations stay feature-major ``(N, 3*vs*vs, B)`` uint8 end to end;
  the policy reads them as they come out of the obs pipeline, the
  trajectory stores them as they are, and the update cuts them into
  ``(G, F, c)`` blocks without moving B off the last axis;
- image and 'rich' observations with the 'cnn_s2d' or 'cnn_image' torso
  (the JAX ``recompute_image_obs`` branch): the rollout renders every step
  (kernel K3), the trajectory stores the pre-step ``EnvState`` of every
  step, and the update re-renders each minibatch's observations from the
  stored states, ``rich_aux`` included.

``PPOConfig`` has the JAX fields and dict round trip; ``init_env_batch``,
``init_state`` (the network and Adam behind an optax-style global-norm
clip), ``episode_metrics``, ``_gae``, ``make_rollout`` (the JAX ``rollout``
inside ``make_train_step``, a Python loop in place of ``lax.scan``),
``make_update`` (the block-granular minibatch update) and
``make_train_step`` (the two, with the JAX step's key plumbing). The
network and the optimizer are stateful torch objects: the step functions
update them in place and take and return the env state and the key, where
the JAX step functions take and return params and opt_state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Tuple

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ..core import grid_gen, obs as obs_mod, rng, step as step_mod
from ..core.state import FIELDS, EnvParams, EnvState
from ..device import const, resolve
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


def obs_spec(env_params: EnvParams, cfg: PPOConfig = None):
    """(shape, dtype) of one agent's observation ('rich': the pov)."""
    if env_params.observation_style in ("image", "rich"):
        side = env_params.view_size * env_params.view_tile_size
        if cfg is not None and cfg.torso == "cnn_s2d":
            # the space-to-depth layout the sprite kernel writes directly
            return (side // 4, side // 4, 48), torch.uint8
        return (side, side, 3), torch.uint8
    return (env_params.view_size, env_params.view_size, 3), torch.int32


def aux_dim(env_params: EnvParams) -> int:
    """Width of the 'rich' style's observe_* feature vector."""
    return (int(env_params.observe_rewards)
            + 2 * int(env_params.observe_position)
            + 4 * int(env_params.observe_orientation))


def rich_aux(env_params: EnvParams, state: EnvState):
    """(B, N, d) float32 observe_* features of a batch-leading state — the
    'rich' dict's non-pov fields, learner-normalized (position scaled to
    [0, 1], orientation one-hot) as the JAX ``rich_aux``. None when no
    observe_* flag is set."""
    parts = []
    if env_params.observe_rewards:
        parts.append(state.last_reward[..., None])
    if env_params.observe_position:
        sc = const([1.0 / max(env_params.width - 1, 1),
                    1.0 / max(env_params.height - 1, 1)], torch.float32,
                   state.agent_pos.device)
        parts.append(state.agent_pos.float() * sc)
    if env_params.observe_orientation:
        parts.append((state.agent_dir[..., None] == torch.arange(
            4, device=state.agent_dir.device)).float())
    return torch.cat(parts, -1) if parts else None


def _recompute(env_params: EnvParams, cfg: PPOConfig) -> bool:
    """Which of the port's two paths a configuration takes: False for
    encode/mlp (the feature-major store), True for image or rich obs with
    a pixels torso (the EnvState store, re-rendered in the update). Raises
    for the JAX package's other paths, naming the ROADMAP slice that
    brings them."""
    if env_params.has_hetero_obs:
        raise NotImplementedError(
            "heterogeneous per-agent obs groups: ROADMAP Slice E")
    if cfg.rnn:
        raise NotImplementedError(
            f"rnn={cfg.rnn!r}: the recurrent family (ROADMAP Slice D) trains "
            f"through parallel/ppo_rnn.py (init_state_rnn, "
            f"make_train_step_rnn), not the feedforward step")
    if env_params.observation_style == "encode":
        if cfg.torso != "mlp":
            raise NotImplementedError(
                f"torso={cfg.torso!r} on encode obs trains from the "
                f"row-major obs store, left over from ROADMAP Slice C "
                f"(pixels)")
        return False
    if cfg.torso not in ("cnn_s2d", "cnn_image"):
        raise ValueError(f"{env_params.observation_style} obs train with a "
                         f"cnn_s2d or cnn_image torso, not {cfg.torso!r}")
    if not cfg.recompute_image_obs:
        raise NotImplementedError(
            "recompute_image_obs=False (the rendered-pixels row store) is "
            "left over from ROADMAP Slice C (pixels)")
    return True


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
    rich = env_params.observation_style == "rich"
    _recompute(env_params, cfg)
    net = ActorCritic(cfg, env_params.view_size, generator, device=device,
                      tile_size=env_params.view_tile_size,
                      aux_dim=aux_dim(env_params) if rich else 0)
    return net, make_optimizer(net, cfg)


def make_optimizer(net, cfg: PPOConfig):
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, single-tensor form) over ``net``'s parameters."""
    return torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, foreach=False)


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


def step_labels(traj, last_value, cfg: PPOConfig, env_leading: bool):
    """GAE over a trajectory with the agents folded into the batch (each
    agent an independent sample; an env's done ends all its agents'
    episodes): the per-step labels ``act``, ``logp``, ``val``, ``adv`` and
    ``ret``, each in the trajectory's (T, B, N) layout (``env_leading``,
    the image paths) or (T, N, B) (encode)."""
    lead = traj["rew"].shape
    T = lead[0]
    done = (traj["done"][..., None] if env_leading
            else traj["done"][:, None, :]).expand(lead)
    val = traj["val"].reshape(T, -1)
    adv, ret = _gae(traj["rew"].reshape(T, -1), val, done.reshape(T, -1),
                    last_value.reshape(-1), cfg.gamma, cfg.gae_lambda)
    return dict(act=traj["act"], logp=traj["logp"], val=traj["val"],
                adv=adv.reshape(lead), ret=ret.reshape(lead))


def _stack_states(states) -> EnvState:
    """Per-step states (B, ...) stacked to one state with (T, B, ...)
    leaves."""
    return EnvState(**{f: torch.stack([getattr(s, f) for s in states])
                       for f in FIELDS})


def make_rollout(env_params: EnvParams, cfg: PPOConfig, net, device="cuda"):
    """Build ``rollout(env_state, key) -> (env_state, key, traj,
    last_value)``, the JAX ``rollout`` of ``make_train_step`` (one device,
    no shards).

    Per step t: the policy acts on the observation, actions come from
    ``categorical`` under the step's key, the envs step with the pool
    autoreset (``board_pool`` layouts, rotated by t, salt t). ``traj``
    leaves are stacked over T. Encode/mlp: ``obs`` (T, N, F, B) uint8,
    ``act``/``logp``/``val``/``rew`` (T, N, B). Image or rich with a pixels
    torso: the policy reads (B, N, ...) images (s2d for 'cnn_s2d', with
    ``rich_aux`` beside them for 'rich'), ``obs`` is the pre-step
    ``EnvState`` with (T, B, ...) leaves, ``act``/``logp``/``val``/``rew``
    are (T, B, N). ``done``/``ep_*`` are (T, B) either way.

    Each stage runs under a ``torch.profiler.record_function`` label
    (``rollout.fresh_pool``, ``.obs``, ``.policy``, ``.sample``,
    ``.env_step``), so a profiler trace attributes device time to it; with
    no profiler running a label costs about a microsecond.
    """
    dev = resolve(device)
    recompute = _recompute(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    # board-pool size: the largest divisor of B not above cfg.board_pool
    K = max(k for k in range(1, min(cfg.board_pool, B) + 1) if B % k == 0)

    def obs_of(state):
        """The policy's inputs: feature-major codes, or (B, N, ...) images
        and the rich features."""
        with record_function("rollout.obs"):
            if not recompute:
                bm = obs_mod.all_agent_obs_b(env_params, state, bminor=True)
                return (bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(
                    torch.uint8),)
            img = obs_mod.all_agent_obs_b(pov_params, state, s2d=s2d)
            return (img, rich_aux(env_params, state) if rich else None)

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
                # (N, B, A), (N, B) feature-major; (B, N, A), (B, N) images
                logits, value = net(*obs)
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
                        env_params, env_state, a if recompute else a.T,
                        fresh_t, salt=t)
            # the stored obs is the PRE-step one (the state, on the
            # recompute path), paired with the action taken from it
            for k, v in zip(names, (
                    env_state if recompute else obs[0], a.to(torch.int32),
                    logp_a, value, rew if recompute else rew.T, done,
                    info["episode_return"], info["episode_length"],
                    info["episode_cycles"])):
                steps[k].append(v)
            env_state = stepped
            obs = obs_of(env_state)
        with record_function("rollout.policy"):
            _, last_value = net(*obs)
        traj = {k: _stack_states(v) if k == "obs" and recompute
                else torch.stack(v) for k, v in steps.items()}
        return env_state, key, traj, last_value

    return rollout


def block_size(B: int, T: int, N: int) -> int:
    """The env-chunk width ``c`` of the update's minibatch blocks on the
    encode path: halve B while the half stays >= 128 and the block count
    ``N*T*(B//c)`` stays <= 8192 after the halving (at B = 4096, T = 64,
    N = 4: c = 128 and G = 8192 blocks)."""
    c = B
    while c % 2 == 0 and c // 2 >= 128 and N * T * (B // c) * 2 <= 8192:
        c //= 2
    return c


def state_block_size(B: int, T: int) -> int:
    """The env-chunk width ``c`` of the update's (step, env-chunk) blocks
    on the recompute path: halve B while the half stays >= 16 and the block
    count ``T*(B//c)`` stays <= 8192 after the halving (at B = 4096,
    T = 64: c = 32 and G = 8192 blocks)."""
    c = B
    while c % 2 == 0 and c // 2 >= 16 and T * (B // c) * 2 <= 8192:
        c //= 2
    return c


def obs_blocks(obs: torch.Tensor, c: int) -> torch.Tensor:
    """Trajectory obs ``(T, N, F, B)`` -> the update's feature-major blocks
    ``(N*T*(B//c), F, c)``, one per (agent, step, env-chunk); B stays on
    the last axis."""
    T, N, Fd, B = obs.shape
    return obs.permute(1, 0, 2, 3).reshape(N * T, Fd, B // c, c).permute(
        0, 2, 1, 3).reshape(N * T * (B // c), Fd, c)


def ppo_loss(logits, value, lab, cfg: PPOConfig):
    """The clipped PPO objective of the JAX ``loss_fn``: ``logits`` (..., A)
    and ``value`` (...) against the labels ``lab`` (``act``, ``logp``,
    ``val``, ``adv``, ``ret``, each (...), aligned sample for sample) ->
    ``(total, {pg_loss, vf_loss, entropy, ratio_dev})``. The advantages are
    normalized over the minibatch (population std, as ``jnp.std``)."""
    eps = cfg.clip_eps
    logp = F.log_softmax(logits, -1)
    logp_a = logp.gather(-1, lab["act"].long()[..., None])[..., 0]
    ratio = torch.exp(logp_a - lab["logp"])
    adv = lab["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    v_clipped = lab["val"] + torch.clamp(value - lab["val"], -eps, eps)
    vf = 0.5 * torch.maximum((value - lab["ret"]) ** 2,
                             (v_clipped - lab["ret"]) ** 2).mean()
    ent = -(F.softmax(logits, -1) * logp).sum(-1).mean()
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    # |ratio - 1| on the first minibatch of an update is a row-alignment
    # check: stored logp recomputed from stored obs at the same weights must
    # agree
    ratio_dev = (ratio - 1.0).abs().mean()
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent,
                       ratio_dev=ratio_dev)


def _take(v, idx):
    """Blocks ``idx`` of a block tensor, of each leaf of an EnvState, or of
    each tensor of a tuple (an LSTM carry)."""
    if isinstance(v, EnvState):
        return v.map(lambda x: x[idx])
    if isinstance(v, tuple):
        return tuple(x[idx] for x in v)
    return v[idx]


def run_epochs(blocked, G: int, used: int, loss_fn, params, optimizer, key,
               cfg: PPOConfig, dev):
    """The epochs of a PPO update over ``blocked`` ({name: (G, ...)}
    blocks): per epoch a ``permutation(split(key)[1], G)``, its first
    ``used`` blocks cut into ``n_minibatches`` gathers, and for each
    ``loss_fn(batch) -> (total, aux)``, a backward pass, the global-norm
    clip and an Adam step on ``params`` (in place). Returns the means over
    every minibatch of ``loss`` and of each ``aux`` entry, as 0-d device
    tensors."""
    mb = used // cfg.n_minibatches
    losses, auxs = [], []
    key = key.to(dev)
    for _ in range(cfg.n_epochs):
        ks = rng.split(key)
        key, pk = ks[0], ks[1]
        perm = rng.permutation(pk, G)
        for idx in perm[:used].reshape(cfg.n_minibatches, mb):
            # blocks are consumed whole
            batch = {k: _take(v, idx) for k, v in blocked.items()}
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
    metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    metrics["loss"] = torch.stack(losses).mean()
    return metrics


def make_update(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                device="cuda"):
    """Build ``update(traj, last_value, key) -> metrics``, the update half of
    the JAX ``make_train_step``: GAE on (T, N*B) (encode) or (T, B*N)
    (images), the block layout, and per epoch a ``permutation(split(key)[1],
    G)`` cut into ``n_minibatches`` gathers of whole blocks, each a
    clipped-objective loss, a backward pass, the global-norm clip and an
    Adam step on ``net`` (in place). ``metrics`` are 0-d device tensors:
    the means over every minibatch of ``loss``, ``pg_loss``, ``vf_loss``,
    ``entropy`` and ``ratio_dev``.

    Blocks: encode/mlp, the feature-major (G, F, c) codes with G =
    N*T*(B//c) (agent, step, env-chunk) blocks (:func:`block_size`);
    images, the stored EnvStates' (T, B, ...) leaves split into G =
    T*(B//c) (step, env-chunk) blocks of c envs (:func:`state_block_size`)
    with (G, c, N) labels. A minibatch of state blocks is flattened to one
    render batch of S envs and re-rendered ``bminor`` (N, S, ...) (kernel
    K3; no gradient flows into the render), with ``rich_aux`` read from the
    same states, and its labels go (mb, c, N) -> (N, S).

    The stages run under ``record_function`` labels (``update.gae``,
    ``update.render``, ``update.forward``, ``update.backward``,
    ``update.optimizer``), as the rollout's do.
    """
    dev = resolve(device)
    recompute = _recompute(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    params = [p for p in net.parameters() if p.requires_grad]
    if recompute:
        c = state_block_size(B, T)
        G = T * (B // c)
    else:
        c = block_size(B, T, N)
        G = N * T * (B // c)
    if G < cfg.n_minibatches:
        raise ValueError(f"fewer trajectory blocks ({G}) than minibatches "
                         f"({cfg.n_minibatches})")
    used = (G // cfg.n_minibatches) * cfg.n_minibatches
    labels = ("act", "logp", "val", "adv", "ret")

    def policy(batch):
        """logits, values and labels of a minibatch, aligned sample for
        sample."""
        if not recompute:
            with record_function("update.forward"):
                # blocks arrive feature-major (mb, F, c) uint8: logits
                # (mb, c, A), labels (mb, c)
                logits, value = net(batch["obs"])
            return logits, value, batch
        with record_function("update.render"):
            st = batch["obs"].map(lambda x: x.reshape((-1,) + x.shape[2:]))
            obs = obs_mod.all_agent_obs_b(pov_params, st, bminor=True,
                                          s2d=s2d)        # (N, S, ...)
            S = obs.shape[1]
            aux = rich_aux(env_params, st) if rich else None   # (S, N, d)
            if aux is not None:
                aux = aux.permute(1, 0, 2).reshape(N * S, -1)
        with record_function("update.forward"):
            logits, value = net(obs.reshape((N * S,) + obs.shape[2:]), aux)
        # labels arrive (mb, c, N); align them to the render's (N, S)
        aligned = {k: batch[k].permute(2, 0, 1).reshape(N, S)
                   for k in labels}
        return logits.reshape(N, S, -1), value.reshape(N, S), aligned

    def loss_fn(batch):
        logits, value, batch = policy(batch)
        with record_function("update.forward"):
            return ppo_loss(logits, value, batch, cfg)

    def blocks(traj, last_value):
        """GAE, then the trajectory cut into G blocks: {name: (G, ...)},
        with ``obs`` an EnvState on the recompute path."""
        per_step = step_labels(traj, last_value, cfg, recompute)
        if recompute:
            def blk(x):                       # (T, B, ...) -> (G, c, ...)
                return x.reshape((G, c) + x.shape[2:])

            out = {k: blk(v) for k, v in per_step.items()}
            out["obs"] = traj["obs"].map(blk)
            return out

        def blk(x):                           # (T, N, B) -> (G, c)
            return x.permute(1, 0, 2).reshape(G, c)

        out = {k: blk(v) for k, v in per_step.items()}
        out["obs"] = obs_blocks(traj["obs"], c)
        return out

    def update(traj, last_value, key):
        with record_function("update.gae"):
            blocked = blocks(traj, last_value)
        if used < G:
            warnings.warn(
                f"PPO minibatching: {G} trajectory blocks do not divide "
                f"into {cfg.n_minibatches} minibatches; dropping {G - used} "
                f"block(s) (~{100 * (G - used) / G:.1f}% of each epoch's "
                f"data). Pick n_minibatches dividing {G} to use all of it.",
                stacklevel=3)
        return run_epochs(blocked, G, used, loss_fn, params, optimizer, key,
                          cfg, dev)

    return update


def make_train_step(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                    device="cuda", overlap=False):
    """Build the rollout + update step, the JAX ``make_train_step`` on one
    device (encode/mlp, or image/rich with a pixels torso):
    :func:`make_rollout` then :func:`make_update`, with the JAX step's key
    plumbing.

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
