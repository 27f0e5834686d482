"""Concrete environments, the registry and the config factory (PyTorch
port of ``marlgrid_tpu/envs/__init__.py``).

The concrete env classes, ``register_marl_env(...)`` building N agent
interfaces under an id like ``'MarlGrid-3AgentCluttered15x15-v0'`` (the
reference's ids, the same as the JAX package's), ``make(env_id)`` and
``env_from_config(dict)``. Importing ``marlgrid_tpu_torch`` fills the
registry. Each id is also registered with gymnasium (when it is installed)
under ``'MarlGridTorch-…'`` in place of ``'MarlGrid-…'``, so the port's
ids and the JAX package's live in one gymnasium registry side by side.
Every env runs on ``device="cuda"`` unless ``make``/``env_from_config``
are given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..agents import GridAgentInterface
from ..core.state import EnvParams, default_agent_colors  # noqa: F401
from ..wrapper import MultiGridEnv


class EmptyMultiGrid(MultiGridEnv):
    """Bordered empty room with one green goal (SURVEY §2.1 [H])."""

    scenario = "empty"


class ClutteredMultiGrid(MultiGridEnv):
    """Random wall clutter + goal (SURVEY §2.1 [H]); kwarg ``n_clutter``."""

    scenario = "cluttered"


class DoorKeyMultiGrid(MultiGridEnv):
    """Split room, locked yellow door, matching key (SURVEY §2.1 [M])."""

    scenario = "doorkey"


class ClutteredGoalCycleEnv(MultiGridEnv):
    """Clutter + cyclic bonus tiles (SURVEY §2.1 [M]); kwargs
    ``n_clutter``, ``n_bonus_tiles``. Reward decay defaults off here —
    the cycle signal is undecayed (SPEC §6)."""

    scenario = "goal_cycle"

    def __init__(self, *a, **kw):
        kw.setdefault("reward_decay", False)
        kw.setdefault("n_clutter", 10)
        super().__init__(*a, **kw)


ENV_CLASSES = {
    "empty": EmptyMultiGrid,
    "cluttered": ClutteredMultiGrid,
    "doorkey": DoorKeyMultiGrid,
    "goal_cycle": ClutteredGoalCycleEnv,
}
_CLASS_TAG = {
    "empty": "Empty",
    "cluttered": "Cluttered",
    "doorkey": "DoorKey",
    "goal_cycle": "ClutteredGoalCycle",
}

REGISTRY: Dict[str, dict] = {}


def register_marl_env(env_name: Optional[str], env_class, n_agents: int,
                      grid_size: int, view_size: int = 7,
                      view_tile_size: int = 8, observation_style="image",
                      env_kwargs: Optional[dict] = None,
                      agent_kwargs: Optional[dict] = None) -> str:
    """Register a named config (``marlgrid/envs — §register_marl_env`` [M]).

    Returns the env id; ``env_name=None`` derives the reference-style id
    ``'MarlGrid-{N}Agent{Class}{S}x{S}-v0'``.
    """
    if isinstance(env_class, str):
        env_class = ENV_CLASSES[env_class]
    scenario = env_class.scenario
    if env_name is None:
        env_name = (f"MarlGrid-{n_agents}Agent{_CLASS_TAG[scenario]}"
                    f"{grid_size}x{grid_size}-v0")
    REGISTRY[env_name] = dict(
        env_class=env_class, n_agents=n_agents, grid_size=grid_size,
        view_size=view_size, view_tile_size=view_tile_size,
        observation_style=observation_style,
        env_kwargs=dict(env_kwargs or {}), agent_kwargs=dict(agent_kwargs or {}),
    )
    _register_with_gymnasium(env_name)
    return env_name


#: the port's gymnasium ids start so, where the reference's start
#: 'MarlGrid-'
GYM_PREFIX = "MarlGridTorch-"


def gymnasium_id(env_id: str) -> str:
    """The gymnasium id of a registry id: ``'MarlGrid-X'`` ->
    ``'MarlGridTorch-X'``, any other id prefixed with ``'MarlGridTorch-'``."""
    if env_id.startswith(GYM_PREFIX):
        return env_id
    return GYM_PREFIX + env_id.removeprefix("MarlGrid-")


def _register_with_gymnasium(env_id: str):
    """Register the id with gymnasium as :func:`gymnasium_id` names it, so
    ``gymnasium.make('MarlGridTorch-…-v0')`` works. The env checker and
    order enforcement are off: the API is gym-classic multi-agent (list
    obs, 4-tuple step) like the reference's."""
    try:
        import gymnasium
    except ImportError:
        return
    gym_id = gymnasium_id(env_id)
    if gym_id in gymnasium.registry:
        return

    def _entry(_env_id=env_id, render_mode=None, **kw):
        # gymnasium.make forwards render_mode (advertised in metadata);
        # it is a render-time argument here, not an EnvParams field
        env = make(_env_id, **kw)
        env.render_mode = render_mode
        return env

    gymnasium.register(
        id=gym_id,
        entry_point=_entry,
        disable_env_checker=True,
        order_enforce=False,
    )


def make(env_id: str, seed: int = 0, device="cuda",
         **overrides) -> MultiGridEnv:
    """Instantiate a registered env id (its gymnasium id works too) on
    ``device`` (gym.make's counterpart)."""
    if env_id not in REGISTRY and env_id.startswith(GYM_PREFIX):
        env_id = next(k for k in REGISTRY if gymnasium_id(k) == env_id)
    cfg = REGISTRY[env_id]
    from ..core.constants import COLOR_NAMES

    colors = default_agent_colors(cfg["n_agents"])
    agents = [
        GridAgentInterface(color=COLOR_NAMES[c], view_size=cfg["view_size"],
                           view_tile_size=cfg["view_tile_size"],
                           observation_style=cfg["observation_style"],
                           **cfg["agent_kwargs"])
        for c in colors
    ]
    kw = dict(cfg["env_kwargs"])
    kw.update(overrides)
    return cfg["env_class"](agents=agents, grid_size=cfg["grid_size"],
                            seed=seed, device=device, **kw)


def env_from_config(config: dict, randomize_seed: bool = False,
                    device="cuda") -> MultiGridEnv:
    """Config-dict factory (``marlgrid/envs — §env_from_config`` [M]).

    config keys: ``env_class`` (name or class), ``grid_size``, ``n_agents``,
    ``max_steps``, scenario kwargs, and agent kwargs (``view_size``, …).
    The env runs on ``device``.
    """
    config = dict(config)
    env_class = config.pop("env_class", "cluttered")
    if isinstance(env_class, str):
        aliases = {cls.__name__.lower(): cls for cls in ENV_CLASSES.values()}
        aliases.update({k: v for k, v in ENV_CLASSES.items()})
        env_class = aliases[env_class.lower()]
    n_agents = config.pop("n_agents", 1)
    grid_size = config.pop("grid_size", 15)
    seed = config.pop("seed", 0)
    if randomize_seed:
        import random

        seed = random.SystemRandom().randrange(2 ** 31)
    agent_keys = ("view_size", "view_tile_size", "view_offset",
                  "observation_style", "observe_rewards", "observe_position",
                  "observe_orientation", "see_through_walls", "hide_item_types",
                  "prestige_beta", "prestige_scale", "spawn_delay")
    agent_kwargs = {k: config.pop(k) for k in list(config)
                    if k in agent_keys}
    from ..core.constants import COLOR_NAMES

    colors = default_agent_colors(n_agents)
    agents = [GridAgentInterface(color=COLOR_NAMES[c], **agent_kwargs)
              for c in colors]
    return env_class(agents=agents, grid_size=grid_size, seed=seed,
                     device=device, **config)


# --- default registrations, mirroring the reference's import-time ids -------
for _n, _scn, _size in [
    (1, "empty", 9), (2, "empty", 9), (3, "empty", 15),
    (3, "cluttered", 15), (2, "doorkey", 11), (4, "goal_cycle", 13),
]:
    register_marl_env(None, ENV_CLASSES[_scn], n_agents=_n, grid_size=_size)
