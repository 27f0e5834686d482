"""World-object classes: the reference's user-facing object model (PyTorch
port).

The port's own copy of ``marlgrid_tpu/objects.py`` (same classes, same
encodings): the engine stores cells as packed int layers and never touches
these classes on the hot path; they exist so users keep the reference's
vocabulary: building objects for custom scenarios
(``core.grid_gen.register_scenario``), decoding ``env.encode()`` cells back
to objects, and asking the interaction predicates. Every predicate reads
the engine's own tables (``core/constants.py``), so the class view and the
array view cannot disagree. Sprites come from the port's ``rendering.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .core import constants as C

#: name -> RGB uint8 array (``marlgrid/objects.py — §COLORS`` [H])
COLORS: Dict[str, np.ndarray] = {
    name: C.COLORS[i] for i, name in enumerate(C.COLOR_NAMES)
}

_TYPE_REGISTRY: Dict[int, type] = {}


class WorldObj:
    """Base cell object: (type_code, color, state) + interaction predicates
    (``marlgrid/objects.py — §WorldObj`` [H]; registry via __init_subclass__
    like the reference's metaclass-style type registry [M])."""

    type_code: int = C.EMPTY
    default_color = "grey"

    def __init__(self, color: Optional[str] = None, state: int = 0):
        self.color = color or self.default_color
        self.state = int(state)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "type_code" in cls.__dict__:
            _TYPE_REGISTRY[cls.type_code] = cls

    # --- predicates: single source of truth = the engine's tables ----------
    def can_overlap(self) -> bool:
        return bool(C.can_overlap(self.type_code, self.state))

    def can_pickup(self) -> bool:
        return bool(C.can_pickup(self.type_code))

    def can_contain(self) -> bool:
        return self.type_code == C.BOX

    def see_behind(self) -> bool:
        return bool(C.see_behind(self.type_code, self.state))

    # --- conversions --------------------------------------------------------
    @property
    def color_idx(self) -> int:
        return C.COLOR_TO_IDX[self.color]

    def encode(self) -> Tuple[int, int, int]:
        """(type, color, state) triple — one cell of ``env.encode()``."""
        return (self.type_code, self.color_idx, self.state)

    def str_render(self) -> str:
        return C.str_render(*self.encode())

    def render(self, tile_size: int = 16) -> np.ndarray:
        """(T, T, 3) uint8 sprite — same rasterizer as the engine's LUTs."""
        from . import rendering

        s_vis = min(self.state, 2) if self.type_code == C.DOOR else 0
        return rendering.render_base_tile(self.type_code, self.color_idx,
                                          s_vis, tile_size)

    def __repr__(self):
        return (f"{type(self).__name__}(color={self.color!r}, "
                f"state={self.state})")

    def __eq__(self, other):
        return isinstance(other, WorldObj) and self.encode() == other.encode()

    def __hash__(self):
        return hash(self.encode())


def from_encoding(type_code: int, color_idx: int = 0,
                  state: int = 0) -> Optional[WorldObj]:
    """Cell triple -> object (inverse of ``WorldObj.encode``); EMPTY -> None."""
    t = int(type_code)
    if t == C.EMPTY:
        return None
    cls = _TYPE_REGISTRY.get(t, WorldObj)
    obj = cls.__new__(cls)
    WorldObj.__init__(obj, color=C.COLOR_NAMES[int(color_idx)],
                      state=int(state))
    return obj


class Wall(WorldObj):
    type_code = C.WALL


class Floor(WorldObj):
    type_code = C.FLOOR
    default_color = "blue"


class Goal(WorldObj):
    """(``marlgrid/objects.py — §Goal(reward, color)`` [H]); the engine reads
    the reward magnitude from ``EnvParams.goal_reward``."""

    type_code = C.GOAL
    default_color = "green"
    #: class-level default so decoded instances (``from_encoding``, which
    #: bypasses subclass __init__) always expose ``reward``
    reward: float = 1.0

    def __init__(self, reward: float = None, color: Optional[str] = None):
        super().__init__(color)
        # reward=None (the default) means "pay whatever the env's
        # goal_reward is" — only an EXPLICIT reward binds the object to a
        # goal_rewards table entry (grid_gen.encode_obj_cell)
        self.explicit_reward = reward is not None
        self.reward = 1.0 if reward is None else reward


class Lava(WorldObj):
    type_code = C.LAVA
    default_color = "orange"


class Door(WorldObj):
    """3-state door: open/closed/locked (SURVEY §2.1 [H])."""

    type_code = C.DOOR
    default_color = "yellow"

    def __init__(self, color: Optional[str] = None, state: int = C.DOOR_CLOSED):
        super().__init__(color, state)

    @property
    def is_open(self):
        return self.state == C.DOOR_OPEN

    @property
    def is_locked(self):
        return self.state == C.DOOR_LOCKED


class Key(WorldObj):
    type_code = C.KEY
    default_color = "yellow"


class Ball(WorldObj):
    type_code = C.BALL
    default_color = "red"


class Box(WorldObj):
    """Container; ``toggle`` reveals contents (SURVEY §2.1 [H]). Contents
    are packed into the state field (SPEC §2 box packing)."""

    type_code = C.BOX
    default_color = "grey"

    def __init__(self, color: Optional[str] = None,
                 contains: Optional[WorldObj] = None):
        state = 0
        if contains is not None:
            state = C.box_pack(contains.type_code, contains.color_idx)
        super().__init__(color, state)

    @property
    def contains(self) -> Optional[WorldObj]:
        ct, cc = C.box_unpack(self.state)
        return from_encoding(ct, cc, 0)


class BonusTile(WorldObj):
    """Goal-cycle tile (``marlgrid/objects.py — §BonusTile`` [M]); the cycle
    bonus/penalty magnitudes live in ``EnvParams.bonus_reward/bonus_penalty``
    and the visit pointer in ``EnvState.last_bonus`` (SPEC §5)."""

    type_code = C.BONUS
    default_color = "pink"
    #: class-level defaults so decoded instances always expose these
    reward: float = 1.0
    penalty: float = 0.5

    def __init__(self, bonus_id: int = 0, color: Optional[str] = None,
                 reward: float = None, penalty: float = None):
        super().__init__(color, state=int(bonus_id))
        # None defaults defer to the env's bonus_reward/bonus_penalty
        self.explicit_reward = reward is not None or penalty is not None
        self.reward = 1.0 if reward is None else reward
        self.penalty = 0.5 if penalty is None else penalty

    @property
    def bonus_id(self) -> int:
        return self.state


class BulkObj(WorldObj):
    """Appearance-keyed bulk object (``marlgrid/objects.py — §BulkObj``
    [L]): in the reference lineage this exists so identical-looking cells
    hash equal for the tile cache. Here appearance-keying is structural —
    ``__hash__``/``__eq__`` on the encode triple (inherited) — and the tile
    cache itself is the sprite LUT, so the class is a thin alias kept for
    import compatibility."""


class GridAgent(WorldObj):
    """Agent as it appears in observations (``§GridAgent`` [H]): type 10,
    color = agent color, state = relative dir; triangle sprite."""

    type_code = C.AGENT
    default_color = "red"

    def __init__(self, color: Optional[str] = None, direction: int = 0):
        super().__init__(color, state=int(direction))

    def render(self, tile_size: int = 16) -> np.ndarray:
        from . import rendering

        rgba = rendering.render_agent_tile(self.color_idx, self.state,
                                           tile_size)
        return rgba[..., :3]
