"""Procedural grid generation — batched reset (PyTorch port).

Counterpart of ``marlgrid_tpu/core/grid_gen.py``. The reset of B envs runs
at once: one bulk draw per env (core/rng.py), then the placement events in
order (SPEC §4: later events see earlier occupancy) on a ``(B, W*H)`` bool
mask of free cells, then one paint of the board layers. Where the JAX
package packs the free mask into uint32 words and reads it with one-hot
contractions (TPU gathers serialize), the port keeps a plain bool mask and
indexes it.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..device import const
from . import constants as C
from . import rng
from .state import EnvParams, EnvState, zeros_state


def interior_region(params: EnvParams) -> Tuple[int, int, int, int]:
    """(x0, rw, y0, rh) of the wall-bordered interior (SPEC §6)."""
    return 1, params.width - 2, 1, params.height - 2


def _first_index(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 where none is True).

    Each True is weighted by its distance from the end, so the maximum is
    unique and the result does not rest on how ``argmax`` breaks ties."""
    n = flags.shape[-1]
    rank = torch.arange(n, 0, -1, dtype=torch.int32, device=flags.device)
    return torch.argmax(flags.to(torch.int32) * rank, dim=-1)


def select_from_mask(params: EnvParams, free: torch.Tensor, xs, ys):
    """One place event per env (SPEC §4): the first valid candidate draw,
    else the first free cell in row-major (y, then x) order.

    ``free`` (B, W*H) bool, ``xs``/``ys`` (B, T) candidate draws. Returns
    ``(x, y, ok)``, each (B,).
    """
    W, H = params.width, params.height
    M = W * H
    idx = (xs * H + ys).long()
    valid = free.gather(1, idx)
    first = _first_index(valid)
    cells = torch.arange(M, device=free.device)
    # y-major fallback scan, done flat: rank cells by y*W+x and take the
    # free cell with the smallest rank (ranks are unique: no ties)
    ymajor_rank = (cells % H) * W + cells // H
    m = torch.argmin(torch.where(free, ymajor_rank, M + 1), dim=1)
    any_valid = valid.any(1)
    x = torch.where(any_valid, xs.gather(1, first[:, None])[:, 0],
                    (m // H).to(xs.dtype))
    y = torch.where(any_valid, ys.gather(1, first[:, None])[:, 0],
                    (m % H).to(ys.dtype))
    return x, y, any_valid | free.any(1)


def free_mask(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, W*H) bool — cells that are empty and agent-free (SPEC §4
    validity). Used by in-step respawn events."""
    H = params.height
    flat_pos = (state.agent_pos[..., 0] * H + state.agent_pos[..., 1]).long()
    occ = torch.zeros_like(state.grid_type, dtype=torch.bool)
    occ.scatter_(1, flat_pos, True)
    return (state.grid_type == C.EMPTY) & ~occ


def bordered_layers(params: EnvParams, batch: int, device):
    """Fresh (B, W, H) int64 board layers with the wall border
    (``MultiGrid.wall_rect``, SURVEY §2.1)."""
    W, H = params.width, params.height
    g = torch.zeros((W, H), dtype=torch.int64, device=device)
    g[0, :] = C.WALL
    g[W - 1, :] = C.WALL
    g[:, 0] = C.WALL
    g[:, H - 1] = C.WALL
    gc = torch.where(g == C.WALL, C.COLOR_TO_IDX["grey"], 0)
    gs = torch.zeros_like(g)
    return tuple(a.expand(batch, W, H).clone() for a in (g, gc, gs))


# --------------------------------------------------------------------------
# Scenario specs (SPEC §6). Each takes the batched layers (B, W, H) and the
# per-env doorkey draws split_x/door_y (B,), and returns (layers, events,
# agent_mask) where ``events`` is a list, one entry per placement event
# number, of either None (the event's draws are consumed but nothing is
# placed) or (type, color, obj_state, region_mask_or_None). Values are ints
# or (B,) tensors; masks are (W, H) or (B, W, H) bool. The list structure is
# the same for every env.
# --------------------------------------------------------------------------

def gen_empty(params: EnvParams, layers, split_x, door_y):
    """EmptyMultiGrid (``marlgrid/envs/__init__.py — §EmptyMultiGrid`` [H])."""
    return layers, [(C.GOAL, C.COLOR_TO_IDX["green"], 0, None)], None


def gen_cluttered(params: EnvParams, layers, split_x, door_y):
    """ClutteredMultiGrid: n_clutter random walls + goal (SURVEY §2.1 [H])."""
    grey = C.COLOR_TO_IDX["grey"]
    events = [(C.WALL, grey, 0, None)] * params.n_clutter
    events.append((C.GOAL, C.COLOR_TO_IDX["green"], 0, None))
    return layers, events, None


def gen_doorkey(params: EnvParams, layers, split_x, door_y):
    """DoorKey-style env (SURVEY §2.1 door/key env [M]; SPEC §6)."""
    gt, gc, gs = layers
    W, H = params.width, params.height
    dev = gt.device
    xs = torch.arange(W, device=dev)[None, :, None]
    ys = torch.arange(H, device=dev)[None, None, :]
    sx = split_x.long()[:, None, None]
    on_wall_col = (xs == sx) & (ys >= 1) & (ys <= H - 2)
    grey = C.COLOR_TO_IDX["grey"]
    yellow = C.COLOR_TO_IDX["yellow"]
    gt = torch.where(on_wall_col, C.WALL, gt)
    gc = torch.where(on_wall_col, grey, gc)
    on_door = (xs == sx) & (ys == door_y.long()[:, None, None])
    gt = torch.where(on_door, C.DOOR, gt)
    gc = torch.where(on_door, yellow, gc)
    gs = torch.where(on_door, C.DOOR_LOCKED, gs)
    left = (xs < sx).expand(-1, W, H)
    right = (xs > sx).expand(-1, W, H)
    events = [
        None,  # event 0: the split/door draw itself
        (C.KEY, yellow, 0, left),
        (C.GOAL, C.COLOR_TO_IDX["green"], 0, right),
    ]
    return (gt, gc, gs), events, left


def gen_goal_cycle(params: EnvParams, layers, split_x, door_y):
    """ClutteredGoalCycleEnv: clutter + cyclic BonusTiles (SURVEY §2.1 [M])."""
    grey = C.COLOR_TO_IDX["grey"]
    pink = C.COLOR_TO_IDX["pink"]
    events = [(C.WALL, grey, 0, None)] * params.n_clutter
    events += [(C.BONUS, pink, b, None) for b in range(params.n_bonus_tiles)]
    return layers, events, None


SCENARIOS: Dict[str, Callable] = {
    "empty": gen_empty,
    "cluttered": gen_cluttered,
    "doorkey": gen_doorkey,
    "goal_cycle": gen_goal_cycle,
}

_N_EVENTS: Dict[str, Callable] = {
    "empty": lambda p: 1,
    "cluttered": lambda p: p.n_clutter + 1,
    "doorkey": lambda p: 3,
    "goal_cycle": lambda p: p.n_clutter + p.n_bonus_tiles,
}

#: scenario name -> static tuple of every (type, color, s_vis) cell
#: appearance the scenario can ever show (s_vis = door state for doors,
#: else 0). EMPTY and the grey wall border are implied. The encode embed's
#: compact vocabularies come from here (core/obs.py::encode_palettes).
SCENARIO_PALETTES: Dict[str, Tuple] = {
    "empty": ((C.GOAL, 3, 0),),                     # green goal
    "cluttered": ((C.GOAL, 3, 0),),
    "doorkey": ((C.DOOR, 2, 0), (C.DOOR, 2, 1), (C.DOOR, 2, 2),
                (C.KEY, 2, 0), (C.GOAL, 3, 0)),     # yellow door/key
    "goal_cycle": ((C.BONUS, 6, 0),),               # pink bonus tiles
}


def register_scenario(name: str, builder: Callable, n_events,
                      palette: Tuple = None) -> str:
    """Register a custom scenario (the analog of overriding ``_gen_grid``,
    SURVEY §3.2).

    ``builder(params, layers, split_x, door_y) -> (layers, events,
    agent_mask)`` follows the builtin builders above (batched layers and
    draws); ``events`` entries are ``(type, color, state, mask_or_None)``
    tuples, ``WorldObj`` instances of ``marlgrid_tpu_torch.objects``
    (placed anywhere), ``(WorldObj, mask)`` pairs, or None (the event's
    draws are consumed, nothing is placed). ``n_events`` is an int or
    ``f(params) -> int``. ``palette`` lists every (type, color, s_vis)
    appearance the scenario can show (see SCENARIO_PALETTES).
    """
    SCENARIOS[name] = builder
    _N_EVENTS[name] = n_events if callable(n_events) else (
        lambda p, _n=n_events: _n)
    if palette is not None:
        SCENARIO_PALETTES[name] = tuple(palette)
    return name


def encode_obj_cell(obj, params: EnvParams = None):
    """(type, color, state) cell triple of a WorldObj under ``params``,
    honoring per-object rewards (``Goal(reward)``, ``BonusTile(reward,
    penalty)``).

    A ``Goal(reward=r)`` maps r to an index into ``params.goal_rewards``
    (stored in the cell's state field, which the step engine pays out);
    a ``BonusTile``'s reward/penalty are checked against the per-tile
    tables (indexed by its bonus_id). Raises ValueError with a fix-it
    message when the object's reward is not representable under params.
    """
    t, c, s = obj.encode()
    if params is None:
        return (t, c, s)
    # objects built without an explicit reward defer to the env's uniform
    # goal_reward/bonus_reward; only Goal(reward=r) binds to the table
    if not getattr(obj, "explicit_reward", True):
        if t == C.GOAL and params.goal_rewards:
            # the engine pays goal_rewards[state], so a bare Goal() encodes
            # the uniform goal_reward's table index (state 0 would pay
            # goal_rewards[0] instead)
            try:
                s = params.goal_rewards.index(float(params.goal_reward))
            except ValueError:
                raise ValueError(
                    f"Goal() defers to the uniform goal_reward="
                    f"{params.goal_reward}, which is not in "
                    f"EnvParams.goal_rewards={params.goal_rewards}; add it "
                    f"to the table or construct Goal(reward=...) "
                    f"explicitly") from None
        return (t, c, s)
    r = getattr(obj, "reward", None)
    if t == C.GOAL and r is not None:
        r = float(r)
        if params.goal_rewards:
            try:
                s = params.goal_rewards.index(r)
            except ValueError:
                raise ValueError(
                    f"Goal(reward={r}) placed but {r} is not in "
                    f"EnvParams.goal_rewards={params.goal_rewards}; add it "
                    f"to the table") from None
        elif r != params.goal_reward:
            raise ValueError(
                f"Goal(reward={r}) placed but EnvParams pays the uniform "
                f"goal_reward={params.goal_reward}; set "
                f"goal_rewards=({params.goal_reward}, {r}, …) on EnvParams "
                f"and this goal will be encoded as an index into it")
    if t == C.BONUS:
        rew = float(getattr(obj, "reward", params.bonus_reward))
        pen = float(getattr(obj, "penalty", params.bonus_penalty))
        table_rew = (params.bonus_rewards[s] if params.bonus_rewards
                     else params.bonus_reward)
        table_pen = (params.bonus_penalties[s] if params.bonus_penalties
                     else params.bonus_penalty)
        if rew != table_rew or pen != table_pen:
            raise ValueError(
                f"BonusTile(bonus_id={s}, reward={rew}, penalty={pen}) does "
                f"not match what EnvParams pays for tile {s} "
                f"(reward={table_rew}, penalty={table_pen}); set "
                f"bonus_rewards/bonus_penalties tuples (indexed by "
                f"bonus_id) on EnvParams")
    return (t, c, s)


def normalize_event(ev, params: EnvParams = None):
    """Event entry -> (type, color, state, mask_or_None) or None."""
    if ev is None:
        return None
    if isinstance(ev, tuple) and len(ev) == 4:
        return ev
    if isinstance(ev, tuple) and len(ev) == 2:   # (WorldObj, mask)
        obj, mask = ev
        return encode_obj_cell(obj, params) + (mask,)
    return encode_obj_cell(ev, params) + (None,)  # bare WorldObj


def n_scenario_events(params: EnvParams) -> int:
    return _N_EVENTS[params.scenario](params)


def agent_spawn_region_mask(params: EnvParams):
    """(W, H) numpy bool of the static agent spawn rectangle, or None when
    unconstrained (``MultiGridEnv(agent_spawn_kwargs)`` [M])."""
    if params.agent_spawn_size is None and params.agent_spawn_top == (0, 0):
        return None
    x0, y0 = params.agent_spawn_top
    if params.agent_spawn_size is None:
        x1, y1 = params.width, params.height
    else:
        x1 = min(x0 + params.agent_spawn_size[0], params.width)
        y1 = min(y0 + params.agent_spawn_size[1], params.height)
    m = np.zeros((params.width, params.height), bool)
    m[x0:x1, y0:y1] = True
    return m


def _flat_mask(mask, batch: int, M: int, device) -> torch.Tensor:
    """A (W, H) or (B, W, H) region mask as (B or 1, W*H) bool."""
    m = const(mask, torch.bool, device) if isinstance(mask, np.ndarray) \
        else mask
    return m.reshape(-1 if m.dim() == 3 else 1, M)


def reset(params: EnvParams, keys: torch.Tensor) -> EnvState:
    """Full episode reset of one env per key (SPEC §6): border → scenario
    events → agent events. ``keys`` (B, 2); returns a batch-B state."""
    if params.scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {params.scenario!r}")
    W, H, N = params.width, params.height, params.n_agents
    M = W * H
    B, dev = keys.shape[0], keys.device
    E = n_scenario_events(params) + N
    x0, rw, y0, rh = interior_region(params)
    k_state, xs, ys, dirs, split_x, door_y = rng.reset_draws(
        keys, E, params.max_place_tries, x0, rw, y0, rh, W, H)

    state = zeros_state(params, k_state)
    layers = bordered_layers(params, B, dev)
    layers, events, agent_mask = SCENARIOS[params.scenario](
        params, layers, split_x, door_y)
    gt, gc, gs = (a.reshape(B, M) for a in layers)
    if len(events) != n_scenario_events(params):
        raise ValueError(f"scenario {params.scenario!r} built {len(events)} "
                         f"events, declared {n_scenario_events(params)}")

    cells = torch.arange(M, device=dev)
    free = gt == C.EMPTY
    placed = []  # (flat index, ok, type, color, obj_state) of painted objects
    for e, ev in enumerate(events):
        ev = normalize_event(ev, params)
        if ev is None:
            continue
        otype, ocolor, ostate, mask = ev
        w = free if mask is None else free & _flat_mask(mask, B, M, dev)
        x, y, ok = select_from_mask(params, w, xs[:, e], ys[:, e])
        idx = (x * H + y).long()
        free = free & ~((cells == idx[:, None]) & ok[:, None])
        placed.append((idx, ok, otype, ocolor, ostate))

    base = len(events)
    region = agent_spawn_region_mask(params)
    if region is not None:
        region = const(region, torch.bool, dev)
        agent_mask = region if agent_mask is None else (agent_mask & region)
    amask = None if agent_mask is None else _flat_mask(agent_mask, B, M, dev)
    delays = params.spawn_delay_tuple()
    for i in range(N):
        e = base + i
        w = free if amask is None else free & amask
        x, y, ok = select_from_mask(params, w, xs[:, e], ys[:, e])
        # degenerate full-board fallback pins agents at (1, 1) (SPEC §4)
        x = torch.where(ok, x, 1)
        y = torch.where(ok, y, 1)
        free = free & ~(cells == (x * H + y).long()[:, None])
        state.agent_pos[:, i, 0] = x
        state.agent_pos[:, i, 1] = y
        state.agent_dir[:, i] = dirs[:, e]
        # delayed agents (spawn_delay [L]) are placed but start inactive
        state.active[:, i] = delays[i] == 0

    # one paint: all placed cells are distinct by construction
    def col(v):    # an int, or a (B,) tensor as a column
        return v.reshape(-1, 1) if torch.is_tensor(v) else v

    for idx, ok, otype, ocolor, ostate in placed:
        hit = (cells == idx[:, None]) & ok[:, None]
        gt = torch.where(hit, col(otype), gt)
        gc = torch.where(hit, col(ocolor), gc)
        gs = torch.where(hit, col(ostate), gs)
    state.grid_type = gt.to(torch.uint8)
    state.grid_color = gc.to(torch.uint8)
    state.grid_state = gs.to(torch.uint8)
    return state
