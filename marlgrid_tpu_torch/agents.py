"""Agent interface objects: the per-agent config surface (PyTorch port).

Counterpart of ``marlgrid_tpu/agents.py``: ``GridAgentInterface`` (one
agent's observation and behaviour kwargs, its action enum and gym spaces,
and the host env's mirror of its position, direction and prestige),
``IndependentLearners`` (N learners zipped into one for the env loop) and
:func:`agents_to_params_fields`, which folds an agent list into
``EnvParams`` fields. gymnasium is optional: without it the spaces are
unavailable and everything else works.
"""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np

from .core import constants as C

try:
    from gymnasium import spaces
except ImportError:
    spaces = None


class GridAgentInterface:
    """One agent's observation and behaviour config (the reference's
    ``GridAgentInterface`` kwargs)."""

    def __init__(self, color="red", view_size=7, view_tile_size=8,
                 view_offset=0, observation_style="image",
                 observe_rewards=False, observe_position=False,
                 observe_orientation=False, see_through_walls=False,
                 hide_item_types=(), prestige_beta=0.95, prestige_scale=2.0,
                 spawn_delay=0):
        self.color = color
        self.color_idx = C.COLOR_TO_IDX[color]
        assert view_size % 2 == 1, "view_size must be odd"
        self.view_size = view_size
        self.view_tile_size = view_tile_size
        self.view_offset = view_offset
        self.observation_style = observation_style
        self.observe_rewards = observe_rewards
        self.observe_position = observe_position
        self.observe_orientation = observe_orientation
        self.see_through_walls = see_through_walls
        self.hide_item_types = tuple(hide_item_types)
        self.prestige_beta = prestige_beta
        self.prestige_scale = prestige_scale
        self.spawn_delay = spawn_delay
        self.prestige = 0.0
        # the host env's mirror of the episode (wrapper.MultiGridEnv)
        self.pos = None
        self.dir = None
        self.carrying = None
        self.active = False

    #: the action enum (``marlgrid/agents.py — §actions``)
    actions = {n: i for i, n in enumerate(C.ACTION_NAMES)}

    @property
    def front_pos(self):
        """The cell directly ahead (``GridAgentInterface.front_pos``)."""
        if self.pos is None or self.dir is None:
            return None
        dx, dy = C.DIR_VEC[self.dir]
        return (self.pos[0] + int(dx), self.pos[1] + int(dy))

    def activate(self):
        self.active = True

    def deactivate(self):
        self.active = False

    @property
    def action_space(self):
        return _spaces().Discrete(C.N_ACTIONS)

    @property
    def observation_space(self):
        sp = _spaces()
        side = self.view_size * self.view_tile_size
        pov = sp.Box(0, 255, (side, side, 3), np.uint8)
        if self.observation_style == "image":
            return pov
        if self.observation_style == "encode":
            return sp.Box(0, 255, (self.view_size, self.view_size, 3),
                          np.int32)
        d = {"pov": pov}
        if self.observe_rewards:
            d["reward"] = sp.Box(-np.inf, np.inf, (), np.float32)
        if self.observe_position:
            d["position"] = sp.Box(0, 255, (2,), np.int32)
        if self.observe_orientation:
            d["orientation"] = sp.Discrete(4)
        return sp.Dict(d)


def _spaces():
    if spaces is None:
        raise ImportError("the agents' gym spaces need gymnasium, which is "
                          "not installed")
    return spaces


class IndependentLearners(list):
    """N independent learners zipped into one object for the env loop
    (``marlgrid/agents.py — §IndependentLearners``)."""

    def __init__(self, *learners):
        super().__init__(learners)

    @property
    def observation_space(self):
        """The Tuple of the learners' own observation spaces."""
        return _spaces().Tuple([lrn.observation_space for lrn in self])

    @property
    def action_space(self):
        return _spaces().Tuple([lrn.action_space for lrn in self])

    def action_step(self, obs_list):
        return [lrn.action_step(obs) for lrn, obs in zip(self, obs_list)]

    def save_step(self, obs, actions, rewards, done):
        for lrn, o, a, r in zip(self, obs, actions, rewards):
            if hasattr(lrn, "save_step"):
                lrn.save_step(o, a, r, done)

    @contextlib.contextmanager
    def episode(self):
        for lrn in self:
            if hasattr(lrn, "start_episode"):
                lrn.start_episode()
        try:
            yield self
        finally:
            for lrn in self:
                if hasattr(lrn, "end_episode"):
                    lrn.end_episode()


def agents_to_params_fields(agents: List[GridAgentInterface]) -> dict:
    """Fold an agent list into EnvParams fields: values every agent shares
    land in the scalar fields, values that differ fill the per-agent tables
    (``agent_view_sizes``, ``agent_obs_styles``, ...), which split the
    agents into observation groups (``vector.obs_groups``)."""
    a0 = agents[0]

    def _types(ts):
        return tuple(C.TYPE_TO_IDX[t] if isinstance(t, str) else int(t)
                     for t in ts)

    hetero = dict()

    def table(attr, field, conv=lambda v: v):
        vals = tuple(conv(getattr(a, attr)) for a in agents)
        if any(v != vals[0] for v in vals[1:]):
            hetero[field] = vals

    table("view_size", "agent_view_sizes")
    table("view_tile_size", "agent_view_tile_sizes")
    table("observation_style", "agent_obs_styles")
    table("view_offset", "agent_view_offsets")
    table("see_through_walls", "agent_see_through_walls")
    table("hide_item_types", "agent_hide_item_types", _types)
    table("observe_rewards", "agent_observe_rewards")
    table("observe_position", "agent_observe_positions")
    table("observe_orientation", "agent_observe_orientations")
    table("prestige_beta", "agent_prestige_betas", float)
    table("prestige_scale", "agent_prestige_scales", float)
    return dict(
        prestige_beta=a0.prestige_beta,
        prestige_scale=a0.prestige_scale,
        spawn_delays=tuple(int(a.spawn_delay) for a in agents),
        n_agents=len(agents),
        agent_colors=tuple(a.color_idx for a in agents),
        view_size=a0.view_size,
        view_tile_size=a0.view_tile_size,
        view_offset=a0.view_offset,
        observation_style=a0.observation_style,
        **hetero,
        observe_rewards=a0.observe_rewards,
        observe_position=a0.observe_position,
        observe_orientation=a0.observe_orientation,
        see_through_walls=a0.see_through_walls,
        hide_item_types=_types(a0.hide_item_types),
    )
