"""The host-side gym-classic env over the port's engine (PyTorch port of
``marlgrid_tpu/wrapper.py``).

The reference's single-env API (``marlgrid/base.py — §MultiGridEnv``):
``reset() -> [obs]``, ``step(list_of_actions) -> (obs_list, reward_array,
done_bool, info)``, with ``render``, ``encode`` and seeding. The env holds a
batch-1 ``EnvState`` on its device and runs the port's batched engine on
it, so the observations go through the same kernels as the batched path on
the card (K1 for encode views, K3 for pixels). Each ``step`` hands the
reward, done flag, observations and the agents' mirror to the host, as the
JAX wrapper's ``np.asarray`` does: host syncs every step. Large-scale
training uses ``vector.VectorEnv``.

The same seed gives the same boards as the JAX package's env: episode keys
are ``fold_in(PRNGKey(seed), episode)`` on the port's threefry, and the
host RNG of ``place_obj``/``place_agent`` is ``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import rendering
from .agents import GridAgentInterface, agents_to_params_fields
from .core import constants as C
from .core import grid_gen, obs as obs_mod, rng, step as step_mod
from .core.state import EnvParams, EnvState, default_agent_colors, np_grid
from .device import resolve


@functools.lru_cache(maxsize=64)
def _compiled(params: EnvParams, device: torch.device):
    """The reset, step, observation and visibility functions of one config
    on one device, cached per config as the JAX package caches its jitted
    closures; the first call of each copies the device tables it reads
    (view offsets, sprite tables) to the device, once."""

    def reset_fn(key):                       # key (2,)
        return grid_gen.reset(params, key[None])

    def step_fn(state, actions):             # actions (N,)
        return step_mod.step(params, state, actions[None])

    def obs_fn(state):
        return obs_mod.all_agent_obs(params, state)

    def vis_fn(state):
        w, inb = obs_mod.all_view_world_coords(params, state)
        if params.see_through_walls:
            vis = torch.ones_like(inb)
        else:
            vt, _, vst, _, _, _ = obs_mod.all_view_cells(params, state)
            vis = obs_mod.process_vis(obs_mod.transparency(vt, vst),
                                      params.view_size, params.view_offset)
        return (w[..., 0].clamp(0, params.width - 1),
                w[..., 1].clamp(0, params.height - 1), inb & vis)

    return reset_fn, step_fn, obs_fn, vis_fn


try:  # subclass gymnasium.Env so gymnasium.make() and its wrappers take it
    import gymnasium as _gymnasium

    _EnvBase = _gymnasium.Env
except ImportError:
    _EnvBase = object


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class MultiGridEnv(_EnvBase):
    """The reference-shaped multi-agent env: ``reset() -> [obs]``,
    ``step(actions) -> (obs_list, rew_array, done, info)``, per-agent lists
    and one shared done. Its ids also live in gymnasium's registry (see
    ``envs``), with the gym-classic API kept.

    ``device`` (default ``"cuda"``) is where the env's state lives and its
    steps run; pass ``"cpu"`` to run on the CPU."""

    scenario: str = "empty"
    metadata = {"render_modes": ["rgb_array", "human"]}
    render_mode = None

    def __init__(self, agents: Optional[List[GridAgentInterface]] = None,
                 grid_size: Optional[int] = None, width: Optional[int] = None,
                 height: Optional[int] = None, max_steps: int = 100,
                 reward_decay: bool = True, seed: int = 0,
                 respawn: bool = False, ghost_mode: bool = True,
                 agent_spawn_kwargs: Optional[dict] = None,
                 params: Optional[EnvParams] = None, device="cuda",
                 **scenario_kwargs):
        self.device = resolve(device)
        if params is None:
            if grid_size is not None:
                width = height = grid_size
            agents = agents or [GridAgentInterface()]
            fields = agents_to_params_fields(agents)
            if agent_spawn_kwargs:
                # the reference forwards these into per-agent place_obj
                # calls; here top/size become the static spawn rectangle
                sk = dict(agent_spawn_kwargs)
                fields["agent_spawn_top"] = tuple(sk.pop("top", (0, 0)))
                size = sk.pop("size", None)
                fields["agent_spawn_size"] = \
                    tuple(size) if size is not None else None
                assert not sk, f"unsupported agent_spawn_kwargs: {sk}"
            fields.update(width=width or 9, height=height or 9,
                          max_steps=max_steps, reward_decay=reward_decay,
                          respawn=respawn, ghost_mode=ghost_mode,
                          scenario=self.scenario, **scenario_kwargs)
            params = EnvParams(**fields)
        self.params = params
        self.agents = agents or [
            GridAgentInterface(color=C.COLOR_NAMES[ci])
            for ci in params.agent_colors
        ]
        self.num_agents = params.n_agents
        self._reset_fn, self._step_fn, self._obs_fn, self._vis_fn = \
            _compiled(params, self.device)
        # per-agent observation configs: one function set per group
        self._obs_groups = None
        if params.has_hetero_obs:
            groups = {}
            for i in range(params.n_agents):
                groups.setdefault(params.agent_obs_params(i), []).append(i)
            self._obs_groups = [(idxs, _compiled(gp, self.device))
                                for gp, idxs in groups.items()]
        self.state: Optional[EnvState] = None
        self._viewer = None
        self.seed(seed)

    # ------------------------------------------------------------------ gym
    def seed(self, seed: int = 0):
        """gym-style seeding (``marlgrid/base.py — §seed``)."""
        self._key = rng.PRNGKey(seed, device=self.device)
        self._episode = 0
        # host RNG of the interactive place_obj/place_agent helpers (the
        # engine's reset places through the SPEC §4 event chain)
        self.np_random = np.random.default_rng(seed)
        return [seed]

    @property
    def action_space(self):
        return [a.action_space for a in self.agents]

    @property
    def observation_space(self):
        return [a.observation_space for a in self.agents]

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.seed(seed)
        ep_key = rng.fold_in(self._key, self._episode)
        self._episode += 1
        self.state = self._reset_fn(ep_key)
        self._sync_agents()
        return self._host_obs()

    def step(self, actions: Sequence[int]):
        assert self.state is not None, "call reset() first"
        a = torch.as_tensor(np.asarray(actions, np.int32),
                            device=self.device)
        self.state, rew, done = self._step_fn(self.state, a)
        self._sync_agents()
        return (self._host_obs(), _host(rew[0]), bool(done[0]), {})

    # ------------------------------------------------------------- obs/render
    def _host_obs(self):
        p = self.params
        if self._obs_groups is None:
            obs = _host(self._obs_fn(self.state))
            per_agent = [obs[i] for i in range(p.n_agents)]
        else:
            per_agent = [None] * p.n_agents
            for idxs, fns in self._obs_groups:
                group_obs = _host(fns[2](self.state))
                for i in idxs:
                    per_agent[i] = group_obs[i]
        if all(p.agent_obs_style(i) in ("image", "encode")
               for i in range(p.n_agents)):
            return per_agent
        rew = _host(self.state.last_reward[0])
        pos = _host(self.state.agent_pos[0])
        dirs = _host(self.state.agent_dir[0])
        out = []
        for i in range(p.n_agents):
            if p.agent_obs_style(i) != "rich":
                out.append(per_agent[i])
                continue
            d = {"pov": per_agent[i]}
            if p.agent_observes_rewards(i):
                d["reward"] = float(rew[i])
            if p.agent_observes_position(i):
                d["position"] = tuple(int(v) for v in pos[i])
            if p.agent_observes_orientation(i):
                d["orientation"] = int(dirs[i])
            out.append(d)
        return out

    def _sync_agents(self):
        """Mirror the device state into the GridAgentInterface objects."""
        s = self.state
        pos, dirs, act, carry, pres = (_host(t[0]) for t in (
            s.agent_pos, s.agent_dir, s.active, s.carry_type, s.prestige))
        for i, a in enumerate(self.agents):
            a.pos = tuple(int(v) for v in pos[i])
            a.dir = int(dirs[i])
            a.active = bool(act[i])
            a.carrying = int(carry[i])
            a.prestige = float(pres[i])

    def gen_agent_obs(self, agent):
        """One agent's current observation (``MultiGridEnv.gen_agent_obs``);
        ``agent`` is an index or one of ``self.agents``."""
        i = agent if isinstance(agent, int) else self.agents.index(agent)
        return self._host_obs()[i]

    def encode(self) -> np.ndarray:
        """(W, H, 3) symbolic board (``MultiGrid.encode``)."""
        return np_grid(self.state, self.params)

    def _free_cells_host(self, top, size, reject_fn):
        """The placeable cells under the reference's rule (empty cell, no
        agent, not rejected by ``reject_fn``), in x-major order."""
        p = self.params
        enc = self.encode()
        x0, y0 = top
        x1 = p.width if size is None else min(x0 + size[0], p.width)
        y1 = p.height if size is None else min(y0 + size[1], p.height)
        pos = _host(self.state.agent_pos[0])
        out = []
        for x in range(x0, x1):
            for y in range(y0, y1):
                if enc[x, y, 0] != C.EMPTY:
                    continue
                if ((pos[:, 0] == x) & (pos[:, 1] == y)).any():
                    continue
                if reject_fn is not None and reject_fn(self, (x, y)):
                    continue
                out.append((x, y))
        return out

    def _validate_raw_cell(self, cell):
        """A raw (type, color, state) triple gets the table-bounds checks
        ``encode_obj_cell`` applies to WorldObjs: a goal or bonus state
        outside the reward tables would pay 0.0."""
        t, _, s = (int(v) for v in cell)
        p = self.params
        if t == C.GOAL and p.goal_rewards and not 0 <= s < len(p.goal_rewards):
            raise ValueError(
                f"goal state {s} is outside EnvParams.goal_rewards "
                f"(len {len(p.goal_rewards)}); it would pay 0.0 reward")
        if t == C.BONUS:
            n = max(p.n_bonus_tiles, 1)
            if not 0 <= s < n:
                raise ValueError(
                    f"bonus_id {s} is outside n_bonus_tiles={p.n_bonus_tiles}")
            if p.bonus_rewards and s >= len(p.bonus_rewards):
                raise ValueError(
                    f"bonus_id {s} is outside EnvParams.bonus_rewards "
                    f"(len {len(p.bonus_rewards)}); it would pay 0.0 reward")

    def _set_cell_host(self, x, y, cell):
        flat = x * self.params.height + y
        t, c_, s = (int(v) for v in cell)
        self.state.grid_type[0, flat] = t
        self.state.grid_color[0, flat] = c_
        self.state.grid_state[0, flat] = s

    def place_obj(self, obj, top=(0, 0), size=None, reject_fn=None,
                  max_tries=100):
        """Rejection-sample a free cell and place ``obj`` there
        (``MultiGridEnv.place_obj``), editing the current episode's state.
        ``obj`` is a ``marlgrid_tpu_torch.objects`` instance or a (type,
        color, state) triple. Returns the (x, y) chosen; None only when the
        region has no free cell. If ``max_tries`` uniform draws all land on
        occupied cells, the first free cell in row-major order is taken
        (SPEC §4)."""
        assert self.state is not None, "call reset() first"
        if hasattr(obj, "encode"):
            cell = grid_gen.encode_obj_cell(obj, self.params)
        else:
            cell = tuple(obj)
            self._validate_raw_cell(cell)
        free = self._free_cells_host(top, size, reject_fn)
        if not free:
            return None
        p = self.params
        free_set = set(free)
        # draw from the rectangle clamped to the board (_free_cells_host's)
        x0, y0 = top
        x1 = p.width if size is None else min(x0 + size[0], p.width)
        y1 = p.height if size is None else min(y0 + size[1], p.height)
        for _ in range(max_tries):
            x = int(self.np_random.integers(x0, x1))
            y = int(self.np_random.integers(y0, y1))
            if (x, y) in free_set:
                self._set_cell_host(x, y, cell)
                return (x, y)
        # SPEC §4 fallback: first free cell in row-major (y, then x) order
        x, y = min(free, key=lambda xy: (xy[1], xy[0]))
        self._set_cell_host(x, y, cell)
        return (x, y)

    def place_agent(self, i, top=(0, 0), size=None, reject_fn=None,
                    max_tries=100, dir=None, activate=True):
        """Re-place agent ``i`` at a free cell (``MultiGridEnv.place_agent``;
        a board edit like ``place_obj``).

        With ``activate=True`` (the default) the agent is activated unless
        it still has an unmet ``spawn_delay`` (SPEC §5.5b: a pending agent
        activates at the step whose pre-step count equals its delay). An
        agent that finished may be re-activated: this edit overrides
        §5.5b's "never re-activates"; ``activate=False`` moves the agent
        without touching its active flag."""
        assert self.state is not None, "call reset() first"
        free = self._free_cells_host(top, size, reject_fn)
        if not free:
            return None
        x, y = free[int(self.np_random.integers(0, len(free)))]
        self.state.agent_pos[0, i, 0] = x
        self.state.agent_pos[0, i, 1] = y
        if dir is None:
            dir = int(self.np_random.integers(0, 4))
        self.state.agent_dir[0, i] = dir
        dl = self.params.spawn_delay_tuple()[i]
        if activate and not (dl > 0 and dl >= int(self.state.step_count[0])):
            self.state.active[0, i] = True
        self._sync_agents()
        return (x, y)

    def __str__(self):
        """ASCII board: one 2-char code per cell, agents as ``<dir-arrow>
        <color letter>`` (shown when active or not ghost_mode), rows y from
        top to bottom, columns x."""
        p = self.params
        enc = self.encode()
        cell = [[C.str_render(*enc[x, y]) for x in range(p.width)]
                for y in range(p.height)]
        pos = _host(self.state.agent_pos[0])
        dirs = _host(self.state.agent_dir[0])
        act = _host(self.state.active[0])
        for i in range(p.n_agents):
            if p.ghost_mode and not act[i]:
                continue
            x, y = int(pos[i, 0]), int(pos[i, 1])
            cell[y][x] = (C.AGENT_DIR_TO_STR[int(dirs[i])]
                          + C.COLOR_NAMES[p.agent_colors[i]][0].upper())
        return "\n".join("".join(row) for row in cell)

    def agent_highlight_mask(self) -> np.ndarray:
        """(W, H) bool union of all agents' visible cells (for render)."""
        p = self.params
        mask = np.zeros((p.width, p.height), bool)
        groups = self._obs_groups or [(range(p.n_agents),
                                       (None, None, None, self._vis_fn))]
        for idxs, fns in groups:
            wx, wy, vis = (_host(v) for v in fns[3](self.state))
            for i in idxs:
                m = vis[i]
                mask[wx[i][m], wy[i][m]] = True
        return mask

    def render(self, mode=None, tile_size=16, highlight=True,
               show_agent_views=False, **_):
        """Full-board render. ``mode=None`` takes the gymnasium
        ``render_mode`` the env was made with (else 'rgb_array');
        ``mode='human'`` also shows the frame through
        ``rendering.SimpleImageViewer``. ``show_agent_views`` puts each
        agent's pov, rendered at ``tile_size`` through the image
        observation path (K3 on the card), in a strip on the right."""
        mode = mode or self.render_mode or "rgb_array"
        hm = self.agent_highlight_mask() if highlight else None
        img = rendering.render_board(self.params,
                                     self.state.map(lambda t: t[0]),
                                     tile_size, highlight_mask=hm)
        if show_agent_views:
            p = self.params
            povs = _host(obs_mod.all_obs_image(
                p.replace(view_tile_size=tile_size), self.state))
            side = povs.shape[1]
            pad = 2
            strip = np.zeros((img.shape[0], side + 2 * pad, 3), np.uint8)
            for i in range(p.n_agents):
                y0 = i * (side + pad)
                if y0 + side > strip.shape[0]:
                    break
                strip[y0:y0 + side, pad:pad + side] = povs[i]
            img = np.concatenate([img, strip], axis=1)
        if mode == "human":
            if self._viewer is None:
                self._viewer = rendering.SimpleImageViewer()
            self._viewer.imshow(img)
        return img

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None


def env_params_for(scenario: str, grid_size: int, n_agents: int,
                   **kw) -> EnvParams:
    """EnvParams with the reference's defaults (agent colors by index)."""
    kw.setdefault("agent_colors", default_agent_colors(n_agents))
    return EnvParams(width=grid_size, height=grid_size, n_agents=n_agents,
                     scenario=scenario, **kw)


class GymnasiumMultiGridEnv(MultiGridEnv):
    """gymnasium's 5-tuple API over the same engine.

    ``reset(seed=, options=) -> (obs_tuple, info)``; ``step(actions) ->
    (obs_tuple, rewards, terminated, truncated, info)`` with ``truncated``
    = the step limit was hit and ``terminated`` = the episode ended (every
    agent inactive with no pending spawn, or a ``reset_on_cycle``
    completion); both can be true on the final step. Observations and
    rewards stay per-agent."""

    def reset(self, seed=None, options=None):
        obs = super().reset(seed=seed)
        return tuple(obs), {}

    def step(self, actions):
        pre_cycles = int(self.state.cycles.sum())
        obs, rew, done, info = super().step(actions)
        p = self.params
        count = int(self.state.step_count[0])
        truncated = bool(done) and count >= p.max_steps
        pending = any(d > 0 and d >= count for d in p.spawn_delay_tuple())
        all_out = not bool(self.state.active.any()) and not pending
        cycled = p.reset_on_cycle and int(self.state.cycles.sum()) > pre_cycles
        terminated = bool(done) and (all_out or cycled)
        return tuple(obs), rew, terminated, truncated, info
