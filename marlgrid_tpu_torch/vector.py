"""The batched env API (PyTorch port of ``marlgrid_tpu/vector.py``).

``VectorEnv`` steps B env instances in lockstep on one device: state in,
state out, with 'encode', 'image' or 'rich' observations. Homogeneous
observation configs only; heterogeneous per-agent obs groups wait for
ROADMAP Slice E.
"""
from __future__ import annotations

import torch

from .core import grid_gen, obs as obs_mod, rng, step as step_mod
from .core.state import EnvParams
from .device import resolve


class VectorEnv:
    """Functional batched env.

    Usage::

        env = VectorEnv(params, n_envs=4096)          # on the card
        state, obs = env.reset(rng.PRNGKey(0))
        state, obs, rew, done, info = env.step(state, actions)  # (B, N)

    ``obs`` is (B, N, vs, vs, 3) int32 ('encode'), (B, N, vs*T, vs*T, 3)
    uint8 ('image'), or for 'rich' a dict of batched fields: ``pov`` (the
    image) plus ``reward`` (B, N), ``position`` (B, N, 2) and
    ``orientation`` (B, N) as the params' ``observe_*`` flags ask. With
    ``auto_reset`` a finished env restarts on the step's shared fresh board
    (``step_autoreset_batch``).
    """

    def __init__(self, params: EnvParams, n_envs: int,
                 auto_reset: bool = True, device="cuda"):
        if params.has_hetero_obs:
            raise NotImplementedError(
                "VectorEnv: heterogeneous per-agent obs groups are ported "
                "with ROADMAP Slice E")
        self.params = params
        self.n_envs = n_envs
        self.auto_reset = auto_reset
        self.device = resolve(device)

    def obs(self, state):
        p = self.params
        if p.observation_style != "rich":
            return obs_mod.all_agent_obs_b(p, state)
        d = {"pov": obs_mod.all_agent_obs_b(
            p.replace(observation_style="image"), state)}
        if p.observe_rewards:
            d["reward"] = state.last_reward
        if p.observe_position:
            d["position"] = state.agent_pos
        if p.observe_orientation:
            d["orientation"] = state.agent_dir
        return d

    def reset(self, key: torch.Tensor):
        keys = rng.split(key.to(self.device), self.n_envs)
        state = grid_gen.reset(self.params, keys)
        return state, self.obs(state)

    def step(self, state, actions):
        actions = torch.as_tensor(actions, device=self.device)
        if self.auto_reset:
            state, rew, done, info = step_mod.step_autoreset_batch(
                self.params, state, actions)
        else:
            state, rew, done = step_mod.step(self.params, state, actions)
            info = {}
        return state, self.obs(state), rew, done, info
