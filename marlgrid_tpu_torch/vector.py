"""The batched env API (PyTorch port of ``marlgrid_tpu/vector.py``).

``VectorEnv`` steps B env instances in lockstep on one device: state in,
state out, with 'encode', 'image' or 'rich' observations, homogeneous or,
when the params hold per-agent observation configs, one observation program
per config group (:func:`obs_groups`).
"""
from __future__ import annotations

import functools

import torch

from .core import grid_gen, obs as obs_mod, rng, step as step_mod
from .core.state import EnvParams
from .device import resolve
from .parallel.graph import GraphedStep


def obs_groups(params: EnvParams):
    """The agents grouped by their per-agent observation config:
    ``[(idxs, gp), ...]`` in order of first appearance, ``idxs`` the agent
    indices that share the homogeneous params ``gp``
    (``params.agent_obs_params(i)``)."""
    groups = {}
    for i in range(params.n_agents):
        groups.setdefault(params.agent_obs_params(i), []).append(i)
    return [(tuple(idxs), gp) for gp, idxs in groups.items()]


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
    per-agent observation configs, ``obs`` is ``{g: obs of group g}`` over
    ``self.obs_groups``, each (B, n_g, ...) in its group's style: encode
    groups render only their own observers against one shared painted
    board; image and rich groups render every agent in the group's config
    and keep the group's columns. With ``auto_reset`` a finished env
    restarts on the step's shared fresh board (``step_autoreset_batch``),
    or with ``independent_resets`` on a board of its own
    (``step_autoreset``: B resets per step, of which about B/max_steps are
    used).
    """

    def __init__(self, params: EnvParams, n_envs: int,
                 auto_reset: bool = True, independent_resets: bool = False,
                 device="cuda"):
        self.params = params
        self.n_envs = n_envs
        self.auto_reset = auto_reset
        self.independent_resets = independent_resets
        self.device = resolve(device)
        self.obs_groups = (obs_groups(params) if params.has_hetero_obs
                           else None)

    @staticmethod
    def _one(p: EnvParams, state):
        """One homogeneous config's batched obs (array, or the rich dict)."""
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

    def obs(self, state):
        if self.obs_groups is None:
            return self._one(self.params, state)
        shared = (obs_mod.pack_grid_with_agents(self.params, state)
                  if any(gp.observation_style == "encode"
                         for _, gp in self.obs_groups) else None)
        out = {}
        for g, (idxs, gp) in enumerate(self.obs_groups):
            if gp.observation_style == "encode":
                out[g] = obs_mod.all_obs_encode_b(gp, state, observers=idxs,
                                                  packed=shared)
                continue
            cols = torch.tensor(idxs, device=state.agent_dir.device)
            full = self._one(gp, state)
            out[g] = ({k: v[:, cols] for k, v in full.items()}
                      if isinstance(full, dict) else full[:, cols])
        return out

    def reset(self, key: torch.Tensor):
        keys = rng.split(key.to(self.device), self.n_envs)
        state = grid_gen.reset(self.params, keys)
        return state, self.obs(state)

    def transition(self, state, actions):
        """:meth:`step` without the observation: ``(state, rew, done,
        info)``."""
        actions = torch.as_tensor(actions, device=self.device)
        if self.auto_reset and self.independent_resets:
            return step_mod.step_autoreset(self.params, state, actions)
        if self.auto_reset:
            return step_mod.step_autoreset_batch(self.params, state, actions)
        state, rew, done = step_mod.step(self.params, state, actions)
        return state, rew, done, {}

    def step(self, state, actions):
        state, rew, done, info = self.transition(state, actions)
        return state, self.obs(state), rew, done, info

    @functools.cached_property
    def example_actions(self):
        """(B, N) int32 zeros on the env's device."""
        return torch.zeros((self.n_envs, self.params.n_agents),
                           dtype=torch.int32, device=self.device)

    def rollout_fn(self, policy_apply, rollout_len: int):
        """A rollout of ``rollout_len`` steps: ``fn(state, key) -> (state,
        traj)``, ``traj`` the dict of ``obs`` (each step's pre-step obs),
        ``actions``, ``rew`` and ``done`` stacked on a leading T axis. Each
        step splits the key as the JAX ``rollout_fn`` does and acts on
        ``policy_apply(obs, key) -> actions (B, N)`` (the JAX package's
        takes ``(policy_params, obs, key)``; here the policy closes over
        its weights).

        On the card the T steps run as one CUDA graph
        (``parallel/graph.GraphedStep``, the counterpart of the jitted
        ``lax.scan``): the first call runs eagerly, the second captures,
        later calls replay, and a capture that fails raises. The tensors a
        graphed call returns are overwritten by the next call (clone what
        must outlive it). On the CPU every call runs eagerly."""
        def raw(state, key):
            steps = {k: [] for k in ("obs", "actions", "rew", "done")}
            for _ in range(rollout_len):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                obs = self.obs(state)
                actions = policy_apply(obs, ak)
                state, rew, done, _ = self.transition(state, actions)
                for k, v in zip(steps, (obs, actions, rew, done)):
                    steps[k].append(v)
            return state, key, {k: _stack(v) for k, v in steps.items()}

        graphed = GraphedStep(raw, f"VectorEnv.rollout_fn(T={rollout_len})")

        def fn(state, key):
            state, _, traj = graphed(state, key.to(self.device))
            return state, traj

        fn.graph = graphed
        return fn


def _stack(xs):
    """Stack a list of tensors, or of (nested) dicts of tensors, on a new
    leading axis."""
    if isinstance(xs[0], dict):
        return {k: _stack([x[k] for x in xs]) for k in xs[0]}
    return torch.stack(xs)
