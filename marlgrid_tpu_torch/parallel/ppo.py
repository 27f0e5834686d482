"""PPO acting on the batched env (PyTorch port): config, env init and the
rollout.

Counterpart of the acting half of ``marlgrid_tpu/parallel/ppo.py`` on the
encode/mlp path: ``PPOConfig`` with the same fields and dict round trip,
``init_env_batch`` and ``make_rollout`` (the JAX ``rollout`` inside
``make_train_step``, a Python loop in place of ``lax.scan``). Observations
stay feature-major ``(N, 3*vs*vs, B)`` uint8 end to end: the policy reads
them as they come out of the obs pipeline and the trajectory stores them
as they are. The update (GAE, minibatches, Adam) waits for the next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ..core import grid_gen, obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import resolve


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
