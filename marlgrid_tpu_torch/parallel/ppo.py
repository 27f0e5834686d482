"""PPO on the batched env (PyTorch port): config, env init, the rollout
and the update.

Counterpart of ``marlgrid_tpu/parallel/ppo.py`` on one device, for its
three feedforward trajectory stores (:func:`storage`):

- encode observations with the mlp torso (the JAX ``bm_store`` branch):
  observations stay feature-major ``(N, 3*vs*vs, B)`` uint8 end to end;
  the policy reads them as they come out of the obs pipeline, the
  trajectory stores them as they are, and the update cuts them into
  ``(G, F, c)`` blocks without moving B off the last axis;
- image and 'rich' observations with the 'cnn_s2d' or 'cnn_image' torso
  (the JAX ``recompute_image_obs`` branch): the rollout renders every step
  (kernel K3), the trajectory stores the pre-step ``EnvState`` of every
  step, and the update re-renders each minibatch's observations from the
  stored states, ``rich_aux`` included;
- the row store (the JAX branch after those two): encode observations
  with the 'cnn', 'cnn_s2d' or 'cnn_image' torso, and image observations
  with ``recompute_image_obs=False``. The policy reads row-major (B, N,
  ...) obs, the trajectory stores them as (T, B*N, F) uint8 rows, and the
  update cuts the T*B*N rows into blocks of contiguous rows.

``PPOConfig`` has the JAX fields and dict round trip; ``init_env_batch``,
``init_state`` (the network and Adam behind an optax-style global-norm
clip), ``episode_metrics``, ``_gae``, ``make_rollout`` (the JAX ``rollout``
inside ``make_train_step``, a Python loop in place of ``lax.scan``),
``make_update`` (the block-granular minibatch update),
``make_train_step`` (the two, with the JAX step's key plumbing; with
``jit=True``, JAX's default, one CUDA graph of the whole step on the card,
``parallel/graph.py``), and ``multi_step`` / ``multi_step_overlap`` (k
steps per call, the graph replayed k times). The network and the optimizer
are stateful torch objects: the step functions update them in place and
take and return the env state and the key, where the JAX step functions
take and return params and opt_state.

Over the ranks of a ``parallel/mesh.py`` Mesh, ``make_train_step`` takes
the JAX step's two sharded forms: ``axis=`` (the explicit-collective
``shard_map`` recipe, :func:`make_train_step_shard_map`) and ``mesh=``
(the GSPMD step: each rank computes its part of the unsharded step of the
global batch, :class:`Share`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Tuple

import torch
from torch.nn import functional as F

from ..core import grid_gen, obs as obs_mod, rng, step as step_mod
from ..core.state import FIELDS, EnvParams, EnvState
from ..device import const, resolve
from ..models import ActorCritic
from ..utils.profiling import stage
from .graph import GraphedStep
from .mesh import Mesh, gather_env, host_local_slice


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


#: the three trajectory stores, as the JAX ``make_train_step`` picks them
FEATURES, STATES, ROWS = "features", "states", "rows"


def storage(env_params: EnvParams, cfg: PPOConfig) -> str:
    """Which trajectory store a configuration trains from, the JAX
    ``bm_store`` / ``recompute`` / row-store choice: :data:`FEATURES` for
    encode obs with the mlp torso (feature-major codes); :data:`STATES` for
    image or rich obs with ``recompute_image_obs`` (the pre-step EnvStates,
    re-rendered in the update); :data:`ROWS` for encode obs with any other
    torso, and for image obs with ``recompute_image_obs=False`` (row-major
    uint8 obs). Raises for what the feedforward step does not take."""
    if env_params.has_hetero_obs:
        raise ValueError(
            "heterogeneous per-agent obs groups train through "
            "parallel/ppo_hetero.py (all-encode groups), ppo_hetero_rnn.py "
            "(recurrent) or ppo_hetero_mixed.py (mixed styles), not the "
            "shared-policy step")
    if cfg.rnn:
        raise NotImplementedError(
            f"rnn={cfg.rnn!r}: the recurrent family (ROADMAP Slice D) trains "
            f"through parallel/ppo_rnn.py (init_state_rnn, "
            f"make_train_step_rnn), not the feedforward step")
    style = env_params.observation_style
    if style == "encode":
        if cfg.torso not in ("mlp", "cnn", "cnn_s2d", "cnn_image"):
            raise ValueError(f"unknown torso {cfg.torso!r}")
        return FEATURES if cfg.torso == "mlp" else ROWS
    if style == "rich" and not cfg.recompute_image_obs:
        raise ValueError("rich-obs PPO needs recompute_image_obs=True "
                         "(EnvState store)")
    if cfg.torso not in ("cnn_s2d", "cnn_image"):
        raise ValueError(f"{style} obs train with a cnn_s2d or cnn_image "
                         f"torso, not {cfg.torso!r}")
    return STATES if cfg.recompute_image_obs else ROWS


def init_env_batch(env_params: EnvParams, n_envs: int, key,
                   stagger: bool = True, device="cuda", mesh: Mesh = None):
    """Reset of ``n_envs`` envs from ``split(key, n_envs)``; ``stagger``
    spreads initial episode phases evenly over the batch (env i starts at
    step_count i*max_steps//B). With a ``mesh`` (``parallel/mesh.py``),
    only this rank's ``host_local_slice`` of the global batch: the same
    rows, bit for bit, as those of the whole batch."""
    keys = rng.split(key.to(resolve(device)), n_envs)
    offset = 0
    if mesh is not None:
        sl = host_local_slice(mesh, n_envs)
        keys, offset = keys[sl], sl.start
    state = grid_gen.reset(env_params, keys)
    if stagger:
        state = step_mod.stagger_step_counts(state, env_params.max_steps,
                                             offset, n_envs)
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
    storage(env_params, cfg)
    net = ActorCritic(cfg, env_params.view_size, generator, device=device,
                      tile_size=env_params.view_tile_size,
                      aux_dim=aux_dim(env_params) if rich else 0,
                      encode=env_params.observation_style == "encode")
    return net, make_optimizer(net, cfg)


def make_optimizer(net, cfg: PPOConfig):
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, single-tensor form) over ``net``'s parameters. On the card
    it is ``capturable`` (its step counts and bias corrections live on the
    device), so that a train step can be captured into a CUDA graph; the
    eager step uses the same form, so both run the same arithmetic. torch
    refuses ``capturable`` on the CPU, which keeps the plain form."""
    params = list(net.parameters())
    opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False,
                           capturable=params[0].device.type == "cuda")
    # set after the constructor, which refuses a NaN lr that optax takes
    # (and trains into NaN weights, what --debug-nans is for)
    for group in opt.param_groups:
        group["lr"] = cfg.lr
    return opt


def clip_by_global_norm(grads, max_norm: float, sq_norm=None):
    """optax's ``clip_by_global_norm`` rule, in place and without a host
    sync: with ``g_norm`` the square root of the sum of every gradient's
    squares (``sq_norm``, where the caller has it: a tensor-parallel net's
    whole-model sum), each gradient ``t`` stays as it is if ``g_norm <
    max_norm`` and becomes ``(t / g_norm) * max_norm`` otherwise. (torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead.)"""
    if sq_norm is None:
        sq_norm = sum((g * g).sum() for g in grads)
    g_norm = torch.sqrt(sq_norm)
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def episode_metrics(metrics: Dict[str, torch.Tensor], traj,
                    axis: Mesh = None):
    """Fold the rollout's per-step episode-completion tallies into mean
    return / length / cycle metrics, weighted by completed episodes (the
    JAX ``episode_metrics``; with ``axis``, the tallies ``psum``'d over the
    data axis first, so every rank returns the same metrics)."""
    n_eps = traj["done"].float().sum()
    ep_ret = traj["ep_ret"].sum()
    ep_len = traj["ep_len"].float().sum()
    ep_cyc = traj["ep_cyc"].float().sum()
    if axis is not None:
        n_eps, ep_ret, ep_len, ep_cyc = axis.psum(
            (n_eps, ep_ret, ep_len, ep_cyc))
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


def local_batch(cfg: PPOConfig, axis: Mesh = None) -> int:
    """The envs of one rank: ``cfg.n_envs`` over the data axis's D."""
    D = 1 if axis is None else axis.D
    assert cfg.n_envs % D == 0, (cfg.n_envs, D)
    return cfg.n_envs // D


def data_axis(axis: Mesh = None, mesh: Mesh = None):
    """The one data axis a step is sharded over: ``axis`` (the shard_map
    recipe), ``mesh`` (the GSPMD-equivalent default path) or neither (one
    device). Raises if both are given."""
    if axis is not None and mesh is not None:
        raise ValueError("axis= (the explicit-collective shard_map step) and "
                         "mesh= (the sharded default path) exclude each "
                         "other")
    return mesh if axis is None else axis


def pool_size(cfg: PPOConfig, B: int) -> int:
    """The fresh-board pool's size K: the largest divisor of the batch B
    (the global batch under a mesh) not above ``cfg.board_pool``."""
    return max(k for k in range(1, min(cfg.board_pool, B) + 1) if B % k == 0)


def sample_actions(ak, logits, axis: Mesh, B: int, key_axis: int,
                   mesh: Mesh = None):
    """Actions from the step's key ``ak``: one ``categorical`` draw over
    the whole logits without ``axis``; with it, the JAX shard_map recipe:
    env b draws from ``fold_in(ak, r * B + b)`` (r the rank's data index),
    its global index, so the actions do not depend on how the batch is
    split. With ``mesh``
    (the GSPMD path): this rank's B rows of the one draw over the global
    logits (``rng.categorical_slice``). ``key_axis``: the logits' env axis
    (1 feature-major, 0 env-leading)."""
    if mesh is not None:
        return rng.categorical_slice(ak, logits, mesh.D * B,
                                     mesh.data_index * B, key_axis)
    if axis is None:
        return rng.categorical(ak, logits)
    ids = axis.data_index * B + torch.arange(B, device=logits.device)
    return rng.categorical_per_key(rng.fold_in(ak, ids), logits, key_axis)


def make_rollout(env_params: EnvParams, cfg: PPOConfig, net, device="cuda",
                 axis: Mesh = None, mesh: Mesh = None):
    """Build ``rollout(env_state, key) -> (env_state, key, traj,
    last_value)``, the JAX ``rollout`` of ``make_train_step``.

    ``axis`` (a ``parallel/mesh.py`` Mesh): the JAX ``axis`` variant, on
    this rank's B = n_envs / D envs: the fresh-board key folded with the
    rank, per-env action keys from the global env index
    (:func:`sample_actions`) and ``env_offset = r * B`` (r the rank's data
    index) into the
    autoreset. ``mesh``: the JAX ``mesh=`` (GSPMD) step's rollout, on this
    rank's B envs: this rank's rows of what the unsharded rollout of the
    global batch computes (the pool size K from the global batch, the
    pool's rows of this rank's envs, its rows of the one global action
    draw, ``env_offset = r * B``); no collective. None: one device, no
    shards.

    Per step t: the policy acts on the observation, actions come from
    ``categorical`` under the step's key, the envs step with the pool
    autoreset (``board_pool`` layouts, rotated by t, salt t). ``traj``
    leaves are stacked over T; ``done``/``ep_*`` are (T, B). By
    :func:`storage`:

    - features (encode/mlp): ``obs`` (T, N, F, B) uint8,
      ``act``/``logp``/``val``/``rew`` (T, N, B);
    - states (image or rich, ``recompute_image_obs``): the policy reads
      (B, N, ...) images (s2d for 'cnn_s2d', with ``rich_aux`` beside them
      for 'rich'); ``obs`` is the pre-step ``EnvState`` with (T, B, ...)
      leaves, ``act``/``logp``/``val``/``rew`` are (T, B, N);
    - rows (encode with a conv torso, or image without recompute): the
      policy reads the row-major (B, N, ...) obs (encode codes, or images,
      s2d for 'cnn_s2d'), ``obs`` is (T, B*N, F) uint8 (encode codes are at
      most 176), the labels (T, B, N) as on the states path.

    The rollout runs under the stage span ``rollout``
    (``utils/profiling.py::stage``: a ``record_function`` label that a graph
    capture remembers), each of its stages under one of its own
    (``rollout.fresh_pool``, ``.obs``, ``.policy``, ``.sample``,
    ``.env_step``, ``.store``: the trajectory's stores and stacks), so a
    profiler trace attributes device time to it, in a graph replay too;
    with no profiler running a label costs about a microsecond.
    """
    dev = resolve(device)
    store = storage(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = (env_params.replace(observation_style="image") if rich
                  else env_params)
    s2d = cfg.torso == "cnn_s2d"
    shards = data_axis(axis, mesh)
    B, T, N = local_batch(cfg, shards), cfg.rollout_len, env_params.n_agents
    Fd = 3 * env_params.view_size ** 2
    K = pool_size(cfg, cfg.n_envs if mesh is not None else B)
    offset = 0 if shards is None else shards.data_index * B
    # the pool rows of this rank's envs: under ``axis`` each rank tiles its
    # own pool over its own envs
    pool_offset = offset if mesh is not None else 0

    def obs_of(state):
        """The policy's inputs: feature-major codes, or the (B, N, ...)
        row-major obs and the rich features."""
        with stage("rollout.obs"):
            if store == FEATURES:
                bm = obs_mod.all_agent_obs_b(env_params, state, bminor=True)
                return (bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(
                    torch.uint8),)
            x = obs_mod.all_agent_obs_b(pov_params, state, s2d=s2d)
            return (x, rich_aux(env_params, state) if rich else None)

    @torch.no_grad()
    @stage("rollout")
    def rollout(env_state, key):
        key = key.to(dev)
        obs = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        if axis is not None:
            # distinct fresh-board layouts per rank (the key is replicated)
            fk = rng.fold_in(fk, axis.data_index)
        with stage("rollout.fresh_pool"):
            pool = step_mod.fresh_pool(env_params, fk, K)
        names = ("act", "logp", "val", "rew", "done", "ep_ret", "ep_len",
                 "ep_cyc")
        steps = {k: [] for k in names}
        kept = []                   # the stored obs (features or states)
        if store == ROWS:
            # written in place step by step: a stack of T steps would hold
            # the store twice (9.9 GB at a time for s2d images at B = 4096)
            rows = torch.empty((T, B * N, obs[0][0, 0].numel()),
                               dtype=torch.uint8, device=dev)
        for t in range(T):
            with stage("rollout.policy"):
                # (N, B, A), (N, B) feature-major; (B, N, A), (B, N) rows
                logits, value = net(*obs)
            with stage("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                a = sample_actions(ak, logits, axis, B,
                                   1 if store == FEATURES else 0, mesh)
                logp_a = F.log_softmax(logits, -1).gather(
                    -1, a[..., None])[..., 0]
            with stage("rollout.env_step"):
                fresh_t = step_mod.fresh_pool_rows(pool, t, pool_offset, B)
                stepped, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state,
                        a.T if store == FEATURES else a, fresh_t,
                        env_offset=offset, salt=t)
            with stage("rollout.store"):
                # the stored obs is the PRE-step one (the state, on the
                # states path), paired with the action taken from it
                if store == ROWS:
                    rows[t].view(obs[0].shape).copy_(obs[0])
                else:
                    kept.append(env_state if store == STATES else obs[0])
                for k, v in zip(names, (
                        a.to(torch.int32), logp_a, value,
                        rew.T if store == FEATURES else rew, done,
                        info["episode_return"], info["episode_length"],
                        info["episode_cycles"])):
                    steps[k].append(v)
            env_state = stepped
            obs = obs_of(env_state)
        with stage("rollout.policy"):
            _, last_value = net(*obs)
        with stage("rollout.store"):
            traj = {"obs": rows if store == ROWS else _stack_states(kept)
                    if store == STATES else torch.stack(kept)}
            traj.update({k: torch.stack(v) for k, v in steps.items()})
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


def ppo_terms(logits, value, lab, adv, cfg: PPOConfig):
    """The per-sample terms of the clipped PPO objective: ``logits``
    (..., A) and ``value`` (...) against the labels ``lab`` (``act``,
    ``logp``, ``val``, ``ret``, each (...), aligned sample for sample) and
    the normalized advantages ``adv`` -> (policy loss, value loss, entropy,
    |ratio - 1|), each (...)."""
    eps = cfg.clip_eps
    logp = F.log_softmax(logits, -1)
    logp_a = logp.gather(-1, lab["act"].long()[..., None])[..., 0]
    ratio = torch.exp(logp_a - lab["logp"])
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps)
                        * adv)
    v_clipped = lab["val"] + torch.clamp(value - lab["val"], -eps, eps)
    vf = 0.5 * torch.maximum((value - lab["ret"]) ** 2,
                             (v_clipped - lab["ret"]) ** 2)
    ent = -(F.softmax(logits, -1) * logp).sum(-1)
    # |ratio - 1| on the first minibatch of an update is a row-alignment
    # check: stored logp recomputed from stored obs at the same weights must
    # agree
    return pg, vf, ent, (ratio - 1.0).abs()


def ppo_loss(logits, value, lab, cfg: PPOConfig, axis: Mesh = None,
             share: "Share" = None):
    """The clipped PPO objective of the JAX ``loss_fn``: :func:`ppo_terms`
    averaged over the minibatch -> ``(total, {pg_loss, vf_loss, entropy,
    ratio_dev})``. The advantages ``lab['adv']`` are normalized over the
    minibatch (population std, as ``jnp.std``); with ``axis``, over the
    global minibatch, from the ``pmean`` of the ranks' means and then of
    their mean squared deviations, as the JAX shard_map step does.

    ``share`` (the mesh path): the samples are this rank's share of a
    global minibatch, weighted by ``share.w`` (1, or 0 on a padding
    block), and every mean is over the global minibatch's
    ``share.count`` samples: the advantages' mean and variance are each a
    ``psum`` of this rank's weighted sums over that count, and the
    returned loss and metrics are this rank's part of the global ones,
    which :func:`run_epochs` sums over the ranks with the gradients."""
    adv = lab["adv"]
    mean = torch.mean
    if share is not None:
        def mean(x):
            return (share.w * x).sum() / share.count

        m, = share.mesh.psum([mean(adv)])
        var, = share.mesh.psum([mean((adv - m) ** 2)])
        adv = (adv - m) / (torch.sqrt(var) + 1e-8)
    elif axis is None:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        m, = axis.pmean([adv.mean()])
        var, = axis.pmean([((adv - m) ** 2).mean()])
        adv = (adv - m) / (torch.sqrt(var) + 1e-8)
    pg, vf, ent, dev = (mean(x) for x in ppo_terms(logits, value, lab, adv,
                                                    cfg))
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)


def _take(v, idx):
    """Blocks ``idx`` of a block tensor, of each leaf of an EnvState, or of
    each tensor of a tuple (an LSTM carry)."""
    if isinstance(v, EnvState):
        return v.map(lambda x: x[idx])
    if isinstance(v, tuple):
        return tuple(x[idx] for x in v)
    return v[idx]


class Share:
    """This rank's share of every minibatch on the mesh path: of a
    minibatch's ``mb`` block indices, the rank at data index r takes
    positions ``[r*mb//D, (r+1)*mb//D)``, padded to ``ceil(mb/D)``
    positions with others at weight 0, so the data ranks split each
    minibatch's compute (none replicated, none dropped or counted twice)
    in tensors of one shape.

    ``pos`` (ceil(mb/D),) are the positions taken; ``w`` their float32
    weights (1, or 0 on padding) as ``align`` lays them against the loss
    terms of a share; ``count`` the global minibatch's samples, ``mb``
    blocks of ``per_block`` (:func:`ppo_loss`)."""

    def __init__(self, mesh: Mesh, mb: int, per_block: int, align, device):
        r = mesh.data_index
        lo, hi = r * mb // mesh.D, (r + 1) * mb // mesh.D
        pos = lo + torch.arange(-(-mb // mesh.D), device=device)
        self.mesh = mesh
        self.pos = pos.clamp(max=mb - 1)     # any real block, weighed 0
        self.w = align((pos < hi).to(torch.float32))
        self.count = float(mb * per_block)


def shuffled_blocks(blocked, G: int, used: int, cfg: PPOConfig,
                    share: Share = None):
    """``minibatches(pk)`` for :func:`run_epochs` over ``blocked``
    ({name: (G, ...)} blocks): a ``permutation(pk, G)``, its first ``used``
    blocks cut into ``n_minibatches`` gathers of whole blocks (with a
    ``share``, of this rank's :class:`Share` of each), under the stage
    ``update.minibatch``."""
    mb = used // cfg.n_minibatches

    def minibatches(pk):
        with stage("update.minibatch"):
            perm = rng.permutation(pk, G)
        for idx in perm[:used].reshape(cfg.n_minibatches, mb):
            with stage("update.minibatch"):
                if share is not None:
                    idx = idx[share.pos]
                batch = {k: _take(v, idx) for k, v in blocked.items()}
            yield batch

    return minibatches


def run_epochs(minibatches, loss_fn, params, optimizer, key, cfg: PPOConfig,
               dev, reduce=None, model=None):
    """The epochs of a PPO update: per epoch the minibatches of
    ``minibatches(split(key)[1])`` (:func:`shuffled_blocks`), and for each
    ``loss_fn(batch) -> (total, aux)``, a backward pass, the global-norm
    clip and an Adam step on ``params`` (in place). With ``reduce`` (a
    Mesh's ``pmean``, the shard_map step; its ``psum``, the mesh path,
    whose ranks hold parts of one global loss), the gradients, ``total``
    and ``aux`` go through it (one bucket) between the backward pass and
    the clip: the data-parallel gradient all-reduce, written out as the JAX
    shard_map step writes it. ``model`` (a tensor-parallel net's
    ``sync_grads``): after that, the model axis's part, ``grads ->
    (grads, squared global norm)``, whose norm the clip takes. Returns the
    means over every minibatch of ``loss`` and of each ``aux`` entry, as
    0-d device tensors."""
    losses, auxs = [], []
    key = key.to(dev)
    for _ in range(cfg.n_epochs):
        ks = rng.split(key)
        key, pk = ks[0], ks[1]
        for batch in minibatches(pk):
            total, aux = loss_fn(batch)
            with stage("update.backward"):
                grads = torch.autograd.grad(total, params)
            if reduce is not None:
                with stage("update.all_reduce"):
                    *grads, total, av = reduce(
                        [*grads, total.detach(),
                         torch.stack(list(aux.values())).detach()])
                    aux = dict(zip(aux, av))
            sq_norm = None
            if model is not None:
                with stage("update.model_all_reduce"):
                    grads, sq_norm = model(grads)
            with stage("update.optimizer"):
                for p, g in zip(params, grads):
                    p.grad = g
                clip_by_global_norm(grads, cfg.max_grad_norm, sq_norm)
                optimizer.step()
            losses.append(total.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
    for p in params:
        # a captured step's last gradients would pin the graph's memory
        p.grad = None
    metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    metrics["loss"] = torch.stack(losses).mean()
    return metrics


def row_blocks(n: int, n_minibatches: int) -> int:
    """The block count ``G`` of the row store's update: the largest power
    of two <= 8192 dividing the ``n`` = T*B*N rows, or ``n`` (single rows)
    when that is fewer than ``n_minibatches`` (awkward row counts)."""
    G = 1
    while G * 2 <= 8192 and n % (G * 2) == 0:
        G *= 2
    return n if G < n_minibatches else G


def make_update(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                device="cuda", axis: Mesh = None, mesh: Mesh = None):
    """Build ``update(traj, last_value, key) -> metrics``, the update half of
    the JAX ``make_train_step``: GAE on (T, N*B) (encode/mlp) or (T, B*N)
    (the other stores), the block layout, and per epoch a
    ``permutation(split(key)[1], G)`` cut into ``n_minibatches`` gathers
    of whole blocks, each a clipped-objective loss, a backward pass, the
    global-norm clip and an Adam step on ``net`` (in place). ``metrics``
    are 0-d device tensors: the means over every minibatch of ``loss``,
    ``pg_loss``, ``vf_loss``, ``entropy`` and ``ratio_dev``.

    Blocks, by :func:`storage`: features, the feature-major (G, F, c)
    codes with G = N*T*(B//c) (agent, step, env-chunk) blocks
    (:func:`block_size`); states, the stored EnvStates' (T, B, ...) leaves
    split into G = T*(B//c) (step, env-chunk) blocks of c envs
    (:func:`state_block_size`) with (G, c, N) labels: a minibatch of state
    blocks is flattened to one render batch of S envs and re-rendered
    ``bminor`` (N, S, ...) (kernel K3; no gradient flows into the render),
    with ``rich_aux`` read from the same states, and its labels go (mb, c,
    N) -> (N, S); rows, every leaf flattened to the T*B*N rows in (t, b,
    n) order and cut into :func:`row_blocks` blocks of contiguous rows, a
    minibatch's rows cast back to ``obs_spec``'s dtype and shape.

    The update runs under the stage span ``update``, its stages under their
    own (``update.gae``, ``update.minibatch``, ``update.render``,
    ``update.forward``, ``update.backward``, ``update.all_reduce``,
    ``update.optimizer``), as the rollout's do.

    ``axis``: the JAX ``axis`` variant on this rank's B = n_envs / D envs
    (blocks cut from the local trajectory, the advantage statistics and the
    gradients over the data axis: :func:`ppo_loss`, :func:`run_epochs`).
    ``mesh``: the JAX ``mesh=`` (GSPMD) step's update, which computes the
    unsharded update of the global batch: GAE on this rank's trajectory,
    then its store and labels gathered from every rank in global env order
    (``mesh.gather_env``: one all-gather), the blocks of the global
    trajectory (c and G from the global B), the same permutation on every
    rank, and each minibatch's blocks split over the ranks
    (:class:`Share`, :func:`ppo_loss`), its gradients ``psum``'d. A
    tensor-parallel net (``parallel/tensor_parallel.py``, its shards over
    the mesh's model axis) adds its ``sync_grads`` after that sum
    (``update.model_all_reduce``).
    """
    dev = resolve(device)
    store = storage(env_params, cfg)
    rich = env_params.observation_style == "rich"
    pov_params = env_params.replace(observation_style="image")
    s2d = cfg.torso == "cnn_s2d"
    shards = data_axis(axis, mesh)
    # the blocks are cut from the global trajectory under a mesh
    B = cfg.n_envs if mesh is not None else local_batch(cfg, shards)
    T, N = cfg.rollout_len, env_params.n_agents
    params = [p for p in net.parameters() if p.requires_grad]
    if store == STATES:
        c = state_block_size(B, T)
        G = T * (B // c)
    elif store == FEATURES:
        c = block_size(B, T, N)
        G = N * T * (B // c)
    else:
        G = row_blocks(T * B * N, cfg.n_minibatches)
        c = T * B * N // G                      # rows per block
    if G < cfg.n_minibatches:
        raise ValueError(f"fewer trajectory blocks ({G}) than minibatches "
                         f"({cfg.n_minibatches})")
    used = (G // cfg.n_minibatches) * cfg.n_minibatches
    labels = ("act", "logp", "val", "adv", "ret")
    shape, dtype = obs_spec(env_params, cfg)
    share, reduce = None, None if axis is None else axis.pmean
    if mesh is not None:
        # a block's samples, and the weights against the loss terms:
        # (mb, c) features, (mb*c,) rows, (N, mb*c) rendered states
        share = Share(mesh, used // cfg.n_minibatches,
                      c * (N if store == STATES else 1),
                      lambda w: (w[:, None] if store == FEATURES
                                 else w.repeat_interleave(c)), dev)
        reduce = mesh.psum

    def policy(batch):
        """logits, values and labels of a minibatch, aligned sample for
        sample."""
        if store == FEATURES:
            with stage("update.forward"):
                # blocks arrive feature-major (mb, F, c) uint8: logits
                # (mb, c, A), labels (mb, c)
                logits, value = net(batch["obs"])
            return logits, value, batch
        if store == ROWS:
            with stage("update.forward"):
                # (mb, c) blocks of rows: one (mb*c,) batch
                flat = {k: v.reshape((-1,) + v.shape[2:])
                        for k, v in batch.items()}
                obs = flat["obs"].to(dtype).reshape((-1,) + shape)
                logits, value = net(obs)
            return logits, value, flat
        with stage("update.render"):
            st = batch["obs"].map(lambda x: x.reshape((-1,) + x.shape[2:]))
            obs = obs_mod.all_agent_obs_b(pov_params, st, bminor=True,
                                          s2d=s2d)        # (N, S, ...)
            S = obs.shape[1]
            aux = rich_aux(env_params, st) if rich else None   # (S, N, d)
            if aux is not None:
                aux = aux.permute(1, 0, 2).reshape(N * S, -1)
        with stage("update.forward"):
            logits, value = net(obs.reshape((N * S,) + obs.shape[2:]), aux)
        # labels arrive (mb, c, N); align them to the render's (N, S)
        aligned = {k: batch[k].permute(2, 0, 1).reshape(N, S)
                   for k in labels}
        return logits.reshape(N, S, -1), value.reshape(N, S), aligned

    def loss_fn(batch):
        logits, value, batch = policy(batch)
        with stage("update.forward"):
            return ppo_loss(logits, value, batch, cfg, axis, share)

    def blocks(traj, last_value):
        """GAE, then the trajectory cut into G blocks: {name: (G, ...)},
        with ``obs`` an EnvState on the states path. Under a mesh, the
        global trajectory's blocks: this rank's labels and store gathered
        from every rank first."""
        env_leading = store != FEATURES
        per_step = step_labels(traj, last_value, cfg, env_leading)
        obs = traj["obs"]
        if mesh is not None:
            with stage("update.all_gather"):
                if store == ROWS:               # (T, B*N, F) -> (T, B, N*F)
                    obs = obs.reshape(T, obs.shape[1] // N, -1)
                per_step, obs = gather_env(mesh, [
                    (per_step, 1 if env_leading else 2),
                    (obs, 3 if store == FEATURES else 1)])
        if store == ROWS:
            out = {k: v.reshape(G, c) for k, v in per_step.items()}
            out["obs"] = obs.reshape(G, c, -1)
            return out
        if store == STATES:
            def blk(x):                       # (T, B, ...) -> (G, c, ...)
                return x.reshape((G, c) + x.shape[2:])

            out = {k: blk(v) for k, v in per_step.items()}
            out["obs"] = obs.map(blk)
            return out

        def blk(x):                           # (T, N, B) -> (G, c)
            return x.permute(1, 0, 2).reshape(G, c)

        out = {k: blk(v) for k, v in per_step.items()}
        out["obs"] = obs_blocks(obs, c)
        return out

    @stage("update")
    def update(traj, last_value, key):
        with stage("update.gae"):
            blocked = blocks(traj, last_value)
        if used < G:
            warnings.warn(
                f"PPO minibatching: {G} trajectory blocks do not divide "
                f"into {cfg.n_minibatches} minibatches; dropping {G - used} "
                f"block(s) (~{100 * (G - used) / G:.1f}% of each epoch's "
                f"data). Pick n_minibatches dividing {G} to use all of it.",
                stacklevel=3)
        return run_epochs(shuffled_blocks(blocked, G, used, cfg, share),
                          loss_fn, params, optimizer, key, cfg, dev, reduce,
                          getattr(net, "sync_grads", None))

    return update


def make_train_step(env_params: EnvParams, cfg: PPOConfig, net, optimizer,
                    device="cuda", overlap=False, jit=True, axis: Mesh = None,
                    mesh: Mesh = None):
    """Build the rollout + update step, the JAX ``make_train_step`` on one
    device (any of the three stores of :func:`storage`):
    :func:`make_rollout` then :func:`make_update`, with the JAX step's key
    plumbing.

    ``jit=True`` (JAX's default): on the card the step is a
    ``graph.GraphedStep``, one CUDA graph of the whole step replayed per
    call (its first call runs eagerly, its second captures), whose
    returned tensors are donated: the next call overwrites them. On the
    CPU it runs the raw step. ``jit=False``: the raw eager step, for
    :func:`multi_step`.

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
    rollout, as 0-d device tensors. With ``jit=True`` the overlap step is
    graphed and ``rollout_only``, called once, stays eager.

    ``axis``: the JAX ``axis`` variant, the per-rank step of
    :func:`make_train_step_shard_map` (not with ``overlap``, as in JAX).

    ``mesh`` (a ``parallel/mesh.py`` Mesh; the JAX ``mesh=``, the GSPMD
    step): this rank's part of the step over the global batch of
    ``cfg.n_envs`` envs, every rank with the same key, weights and
    optimizer state and B = n_envs / D envs of its own
    (``init_env_batch(..., mesh=mesh)``). What the ranks compute together
    is what the unsharded step computes over the global batch, up to the
    order of float sums (:func:`make_rollout`, :func:`make_update`); the
    episode tallies are ``psum``'d. With ``overlap`` too, as in JAX. Its
    collectives are captured in the graph with ``jit=True``. On a mesh
    with a model axis, ``net`` may be this rank's
    ``tensor_parallel.TensorParallelActorCritic`` (the JAX dry run's
    tensor-parallel step): the ranks of a model group hold the shards of
    one policy, and the step computes the unsharded step's function
    (``tensor_parallel.broadcast_state`` in place of ``broadcast_from``
    for the start).
    """
    shards = data_axis(axis, mesh)
    if overlap and axis is not None:
        raise ValueError("--overlap + --shard-map not supported")
    dev = resolve(device)
    rollout = make_rollout(env_params, cfg, net, device=dev, axis=axis,
                           mesh=mesh)
    update = make_update(env_params, cfg, net, optimizer, device=dev,
                         axis=axis, mesh=mesh)

    def train_step(env_state, key):
        env_state, key, traj, last_value = rollout(env_state, key)
        metrics = episode_metrics(update(traj, last_value, key), traj,
                                  shards)
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
        metrics = episode_metrics(update(prev_traj, prev_last, key), traj,
                                  shards)
        return env_state, (traj, last_value), rng.fold_in(key, 1), metrics

    step = train_step_overlap if overlap else train_step
    step.capture_error_mode = capture_error_mode(shards)
    if jit:
        name = ("ppo.make_train_step_shard_map" if axis is not None
                else "ppo.make_train_step" + (
                    "(overlap=True)" if overlap else "")
                + ("(mesh=...)" if mesh is not None else ""))
        step = GraphedStep(step, name, step.capture_error_mode)
    return (step, rollout_only) if overlap else step


def capture_error_mode(axis: Mesh = None) -> str:
    """How a step with collectives over ``axis`` is captured: on a process
    group, ``"thread_local"``: the group's own threads (its watchdog) may
    query CUDA while the main thread captures, which the default
    ``"global"`` mode makes an error in every thread; else (no group, or
    no axis) ``"global"``."""
    return "global" if axis is None or axis.group is None else "thread_local"


def make_train_step_shard_map(env_params: EnvParams, cfg: PPOConfig, net,
                              optimizer, mesh: Mesh, jit=True,
                              device="cuda"):
    """The explicit-collective train step, the JAX
    ``make_train_step_shard_map``: ``train_step(env_state, key) ->
    (env_state, key, metrics)`` on this rank's slice of the env batch (B =
    ``cfg.n_envs / mesh.D`` envs, ``init_env_batch(..., mesh=mesh)``),
    every rank with the same key, weights and optimizer state. The ranks
    meet only at the collectives the step calls over ``mesh``: the
    advantage statistics and the gradients, loss and aux metrics of each
    minibatch (``pmean``), and the episode tallies (``psum``); actions are
    keyed by the global env index, so the computation does not depend on
    D where no env resets (each rank draws its own fresh-board pool). The
    returned key and metrics are the same on every rank.

    ``jit=True``: on the card one CUDA graph of the whole step, the
    collectives captured inside it (``parallel/graph.py``; its first call
    runs eagerly and creates the communicator); ``jit=False``: the raw
    step, for :func:`multi_step`. Do not wrap the net in
    ``DistributedDataParallel``: its reducer hooks fire on ``.backward()``,
    and the step takes its gradients with ``torch.autograd.grad``."""
    return make_train_step(env_params, cfg, net, optimizer,
                           device=resolve(device), jit=jit, axis=mesh)


def multi_step(step_fn, k: int):
    """``k`` train steps per call, the JAX ``multi_step`` contract:
    ``fn(*carry) -> (*carry, metrics of the last of the k steps)``, for any
    step of the port (``(env_state, key)``, the overlap step's
    ``(env_state, prev, key)``, the recurrent ``(env_state, h, key)``).
    ``step_fn`` is the raw step (``jit=False``). On the card it is captured
    once as a ``graph.GraphedStep`` and replayed k times per call: k graph
    launches, where a k-step graph would multiply the capture's size and
    instantiation time and save nothing. Returned tensors are donated, as
    the graphed step's."""
    step = GraphedStep(step_fn, f"multi_step(k={k})",
                       getattr(step_fn, "capture_error_mode", "global"))

    def fn(*carry):
        for _ in range(k):
            *carry, metrics = step(*carry)
        return (*carry, metrics)

    fn.step = step
    return fn


def multi_step_overlap(step_fn, k: int):
    """:func:`multi_step` for the overlap step from ``make_train_step(...,
    overlap=True, jit=False)``: the double-buffered ``prev`` rides the
    carry."""
    return multi_step(step_fn, k)
