"""Object/type/color constants and property tables (PyTorch port).

A copy of ``marlgrid_tpu/core/constants.py``: every predicate is a small
constant lookup table indexed by the integer type code, so the step engine is
plain tensor indexing. Encodings are pinned by SPEC.md §2. The port keeps its
own copy so that it never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

# --- object type codes (SPEC §2) -------------------------------------------
EMPTY = 0
WALL = 1
FLOOR = 2
DOOR = 3
KEY = 4
BALL = 5
BOX = 6
GOAL = 7
LAVA = 8
BONUS = 9
AGENT = 10  # only ever appears in symbolic *observations*, never in the grid
N_TYPES = 11

TYPE_NAMES = (
    "empty", "wall", "floor", "door", "key", "ball", "box", "goal", "lava",
    "bonus", "agent",
)
TYPE_TO_IDX = {n: i for i, n in enumerate(TYPE_NAMES)}

# --- door states (SPEC §2) --------------------------------------------------
DOOR_OPEN = 0
DOOR_CLOSED = 1
DOOR_LOCKED = 2

# --- colors (SPEC §2; marlgrid palette is a superset of minigrid's 6,
#     ``marlgrid/objects.py — §COLORS`` [M]) --------------------------------
COLOR_NAMES = (
    "red", "orange", "yellow", "green", "blue", "purple", "pink", "grey",
    "white",
)
COLOR_TO_IDX = {n: i for i, n in enumerate(COLOR_NAMES)}
N_COLORS = len(COLOR_NAMES)

COLORS = np.array(
    [
        [255, 0, 0],      # red
        [255, 165, 0],    # orange
        [255, 255, 0],    # yellow
        [0, 255, 0],      # green
        [0, 0, 255],      # blue
        [112, 39, 195],   # purple
        [255, 0, 189],    # pink
        [100, 100, 100],  # grey
        [255, 255, 255],  # white
    ],
    dtype=np.uint8,
)

# --- actions (``marlgrid/agents.py — §actions`` IntEnum, SURVEY §2.1 [H]) ---
LEFT = 0
RIGHT = 1
FORWARD = 2
PICKUP = 3
DROP = 4
TOGGLE = 5
DONE = 6
N_ACTIONS = 7
ACTION_NAMES = ("left", "right", "forward", "pickup", "drop", "toggle", "done")

# --- directions (SPEC §1): 0=east, 1=south, 2=west, 3=north; y grows down ---
DIR_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)

# --- property tables (SPEC §2; replaces WorldObj.can_overlap/can_pickup/
#     see_behind predicate methods) -----------------------------------------
# can_overlap ignoring state; doors need the state-aware helper below.
CAN_OVERLAP_BASE = np.array(
    #  empty wall floor door key ball box goal lava bonus agent
    [  True, False, True, False, False, False, False, True, True, True, False],
    dtype=bool,
)
CAN_PICKUP = np.array(
    [False, False, False, False, True, True, True, False, False, False, False],
    dtype=bool,
)
SEE_BEHIND_BASE = np.array(
    [True, False, True, False, True, True, True, True, True, True, True],
    dtype=bool,
)


def can_overlap(obj_type, obj_state):
    """State-aware overlap predicate; numpy or torch values."""
    base = CAN_OVERLAP_BASE[obj_type] if isinstance(obj_type, (int, np.integer)) \
        else _take(CAN_OVERLAP_BASE, obj_type)
    is_open_door = (obj_type == DOOR) & (obj_state == DOOR_OPEN)
    return base | is_open_door


def see_behind(obj_type, obj_state):
    base = SEE_BEHIND_BASE[obj_type] if isinstance(obj_type, (int, np.integer)) \
        else _take(SEE_BEHIND_BASE, obj_type)
    is_open_door = (obj_type == DOOR) & (obj_state == DOOR_OPEN)
    return base | is_open_door


def can_pickup(obj_type):
    if isinstance(obj_type, (int, np.integer)):
        return bool(CAN_PICKUP[obj_type])
    return _take(CAN_PICKUP, obj_type)


def _take(table, idx):
    """Lookup from a constant table; accepts numpy or torch indices."""
    if isinstance(idx, np.ndarray):
        return table[idx]
    from ..device import const

    return const(table, None, idx.device)[idx.long()]


# --- text rendering (``marlgrid/objects.py — §str_render`` [M]; minigrid
#     lineage 2-char cell codes: object letter + color letter) ---------------
TYPE_TO_STR = {
    EMPTY: " ", WALL: "W", FLOOR: "F", DOOR: "D", KEY: "K", BALL: "A",
    BOX: "B", GOAL: "G", LAVA: "V", BONUS: "T",
}
AGENT_DIR_TO_STR = {0: ">", 1: "v", 2: "<", 3: "^"}


def str_render(obj_type: int, color_idx: int, obj_state: int = 0) -> str:
    """2-char text code of one cell (``WorldObj.str_render`` [M]).

    Doors show their state instead of the color letter: ``D_`` open,
    ``D=`` closed, ``DL`` locked.
    """
    t = int(obj_type)
    if t == EMPTY:
        return "  "
    if t == DOOR:
        return "D" + {DOOR_OPEN: "_", DOOR_CLOSED: "=", DOOR_LOCKED: "L"}[
            int(obj_state)]
    return TYPE_TO_STR.get(t, "?") + COLOR_NAMES[int(color_idx)][0].upper()


# --- prestige display (SPEC §8; ``marlgrid/agents.py — §prestige_beta/
#     §prestige_scale`` [M]: agent sprite color dims with accumulated reward).
# The continuous prestige value maps to one of N_PRESTIGE_LEVELS discrete dim
# factors (level = floor(prestige / prestige_scale), clipped) so the engine's
# on-device render and the oracle's per-cell rasterizer agree bit-exactly.
N_PRESTIGE_LEVELS = 8
# Values are exactly representable in bfloat16 (8-bit mantissa) so the
# Pallas sprite-composite kernel's bf16 dim factors reproduce the f32
# reference computation bit-for-bit (ops/sprite.py); the table is the single
# source for engine AND oracle, so parity is unaffected by the choice.
PRESTIGE_DIM = np.array(
    [1.0, 0.8515625, 0.71875, 0.609375, 0.51953125, 0.439453125,
     0.380859375, 0.3203125], dtype=np.float32)


# Box contents packing (SPEC §2): state = contained_type * 16 + contained_color.
BOX_PACK = 16


def box_unpack(state):
    return state // BOX_PACK, state % BOX_PACK
