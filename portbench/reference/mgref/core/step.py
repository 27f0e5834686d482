"""The batched multi-agent transition function (SPEC §5, PyTorch port).

Counterpart of ``marlgrid_tpu/core/step.py``. The randomized-priority
sequential agent micro-loop stays sequential (it is the conflict-resolution
spec, SURVEY §7.3 item 2); micro-step j moves agent ``perm[b, j]`` of every
env b at once, so the acting agent differs per env and every per-agent read
and write is a gather or an indexed write on the ``(B, N)`` tensors. The
JAX package's one-hot arithmetic (core/dense.py, a TPU workaround for
gathers) becomes plain indexing here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import const
from . import constants as C
from . import rng
from .grid_gen import free_mask, interior_region, reset, select_from_mask
from .state import FIELDS, EnvParams, EnvState


def fma_f32(a, b, c):
    """``a * b + c`` of float32 values (tensors, or ``b`` as float64
    holding float32 values, or floats) rounded once to float32, as a fused
    multiply-add rounds it: XLA contracts the prestige update into an FMA.

    Plain ops, the same on every device, so the card and the CPU agree bit
    for bit (no fused op of the framework, whose rounding may differ
    between builds). The product of two float32 values is exact in
    float64, and the float64 sum rounds once. Rounding that sum again to
    float32 differs from one rounding only where the float64 sum lands
    exactly on a half-way point between two float32 values while the exact
    sum does not: there the sum steps one float64 ulp toward the exact
    sum, whose side TwoSum's error gives (results in float32's normal
    range)."""
    a, b, c = (x.double() if torch.is_tensor(x) else float(x)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    # a float32 half-way point has the low 29 of float64's 52 mantissa
    # bits at 1 followed by 28 zeros
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) & (err != 0)
    s = torch.where(tie, torch.nextafter(s, torch.copysign(
        torch.full_like(s, math.inf), err)), s)
    return s.float()


def reward_decay(params: EnvParams, step_count):
    """The reward's decay ``1 - 0.9 * step_count / max_steps`` (float32)
    as XLA compiles it: the constants folded into one float32 ``c``, then
    ``1 - step_count * c`` as one fused multiply-add. In float64 the
    product and the difference are exact (step counts and max_steps below
    2**27), so one rounding to float32 is the FMA's."""
    c = float(np.float32(np.float32(0.9)
                         * np.float32(1.0 / params.max_steps)))
    return (1.0 - step_count.double() * c).float()


def _float_lookup(table, idx):
    """table[idx] for a static float tuple; 0.0 where idx is out of range
    (the JAX package's one-hot lookup matches nothing there)."""
    t = const(table, torch.float32, idx.device)
    inb = (idx >= 0) & (idx < t.shape[0])
    return torch.where(inb, t[idx.clamp(0, t.shape[0] - 1)], 0.0)


def _agent_micro_step(params: EnvParams, s: EnvState, rew, i, actions,
                      respawn_draws):
    """Agent ``i[b]``'s action in env b, applied in place to ``s``
    (SPEC §5 step 2); returns the updated (B, N) reward."""
    B, N = i.shape[0], params.n_agents
    H = params.height
    dev = i.device
    ar = torch.arange(B, device=dev)
    action = actions[ar, i]
    active = s.active[ar, i]
    pos = s.agent_pos[ar, i].long()                   # (B, 2)
    d = s.agent_dir[ar, i].long()

    # --- rotation -----------------------------------------------------------
    turn = ((active & (action == C.RIGHT)).long()
            - (active & (action == C.LEFT)).long())
    s.agent_dir[ar, i] = ((d + turn) % 4).to(torch.int32)

    # --- the forward cell (always in bounds: boards are wall-bordered) ------
    f = pos + const(C.DIR_VEC, torch.int64, dev)[d]
    fx, fy = f[:, 0], f[:, 1]
    fidx = fx * H + fy
    ft = s.grid_type[ar, fidx].long()
    fc = s.grid_color[ar, fidx].long()
    fs = s.grid_state[ar, fidx].long()

    others = torch.arange(N, device=dev)[None, :] != i[:, None]
    at_f = ((s.agent_pos[..., 0] == fx[:, None])
            & (s.agent_pos[..., 1] == fy[:, None]) & others)
    # ghost_mode: inactive agents are passable (SPEC §5 blocked-by-agent)
    blocking = at_f & s.active if params.ghost_mode else at_f
    blocked = blocking.any(1)

    # --- forward ------------------------------------------------------------
    moves = (active & (action == C.FORWARD) & C.can_overlap(ft, fs)
             & ~blocked)
    new_pos = torch.where(moves[:, None], f, pos)

    on_goal = moves & (ft == C.GOAL)
    on_lava = moves & (ft == C.LAVA)
    on_bonus = moves & (ft == C.BONUS)

    # per-object goal rewards (``marlgrid/objects.py — §Goal(reward)`` [H])
    goal_r = _float_lookup(params.goal_rewards, fs) if params.goal_rewards \
        else params.goal_reward
    r = (torch.where(on_goal, goal_r, 0.0)
         + torch.where(on_lava, params.lava_penalty, 0.0))

    # bonus-tile cycle (SPEC §5; ``marlgrid/objects.py — §BonusTile`` [M])
    lb = s.last_bonus[ar, i].long()
    b = fs
    first = lb < 0
    same = b == lb
    succ = b == (lb + 1) % max(params.n_bonus_tiles, 1)
    b_rew = _float_lookup(params.bonus_rewards, b) \
        if params.bonus_rewards else params.bonus_reward
    b_pen = _float_lookup(params.bonus_penalties, b) \
        if params.bonus_penalties else params.bonus_penalty
    bonus_r = torch.where(first | succ, b_rew,
                          torch.where(same, 0.0, -b_pen))
    r = r + torch.where(on_bonus, bonus_r, 0.0)
    s.last_bonus[ar, i] = torch.where(on_bonus & ~same, b, lb).to(
        torch.int32)
    # cycle bookkeeping (``ClutteredGoalCycleEnv(reset_on_cycle)`` [L])
    prog = s.cycle_progress[ar, i].long()
    new_prog = torch.where(on_bonus & (first | succ), prog + 1,
                           torch.where(on_bonus & ~same, 1, prog))
    completed = on_bonus & (new_prog >= params.n_bonus_tiles)
    s.cycle_progress[ar, i] = torch.where(completed, 0, new_prog).to(
        torch.int32)
    s.cycles[ar, i] = s.cycles[ar, i] + completed.to(torch.int32)

    deact = (on_goal & (not params.respawn)) | on_lava
    s.active[ar, i] = active & ~deact

    # Commit the move BEFORE any respawn draw so the vacated cell counts as
    # free in the respawn's validity mask (matches the oracle's ordering).
    s.agent_pos[ar, i] = new_pos.to(torch.int32)

    if params.respawn:
        # In-step respawn after reaching a goal: a place event per SPEC §4.
        rxs, rys, rdirs = respawn_draws
        rx, ry, ok = select_from_mask(params, free_mask(params, s),
                                      rxs[ar, i], rys[ar, i])
        do = on_goal & ok
        s.agent_pos[ar, i] = torch.where(
            do[:, None], torch.stack([rx, ry], 1).long(),
            new_pos).to(torch.int32)
        s.agent_dir[ar, i] = torch.where(do, rdirs[ar, i],
                                         s.agent_dir[ar, i])

    # --- pickup / drop / toggle (mutually exclusive by action code) ---------
    cty = s.carry_type[ar, i].long()
    cco = s.carry_color[ar, i].long()
    cst = s.carry_state[ar, i].long()
    pick = (active & (action == C.PICKUP) & C.can_pickup(ft)
            & (cty == C.EMPTY))
    drop = (active & (action == C.DROP) & (cty != C.EMPTY)
            & (ft == C.EMPTY) & ~at_f.any(1))
    tog = active & (action == C.TOGGLE)
    door_tog = tog & (ft == C.DOOR)
    box_tog = tog & (ft == C.BOX)

    # door state machine (SPEC §5 toggle)
    has_key = (cty == C.KEY) & (cco == fc)
    new_door = torch.where(
        fs == C.DOOR_LOCKED,
        torch.where(has_key, C.DOOR_OPEN, C.DOOR_LOCKED),
        torch.where(fs == C.DOOR_CLOSED, C.DOOR_OPEN, C.DOOR_CLOSED))
    bct, bcc = C.box_unpack(fs)

    cell_t = torch.where(pick, C.EMPTY, torch.where(
        drop, cty, torch.where(box_tog, bct, ft)))
    cell_c = torch.where(pick, 0, torch.where(
        drop, cco, torch.where(box_tog, bcc, fc)))
    cell_s = torch.where(pick, 0, torch.where(drop, cst, torch.where(
        door_tog, new_door, torch.where(box_tog, 0, fs))))
    s.grid_type[ar, fidx] = cell_t.to(torch.uint8)
    s.grid_color[ar, fidx] = cell_c.to(torch.uint8)
    s.grid_state[ar, fidx] = cell_s.to(torch.uint8)

    s.carry_type[ar, i] = torch.where(
        pick, ft, torch.where(drop, C.EMPTY, cty)).to(torch.int32)
    s.carry_color[ar, i] = torch.where(
        pick, fc, torch.where(drop, 0, cco)).to(torch.int32)
    s.carry_state[ar, i] = torch.where(
        pick, fs, torch.where(drop, 0, cst)).to(torch.int32)

    rew[ar, i] = rew[ar, i] + r
    return rew


def step(params: EnvParams, state: EnvState, actions):
    """Pure transition of a batch: (state, actions (B, N)) -> (state',
    rew (B, N) float32, done (B,) bool). ``state`` is not modified.

    Follows SPEC §5 exactly; observations are computed separately
    (``core/obs.py``) from the returned state.
    """
    N = params.n_agents
    s = state.clone()
    dev = s.key.device
    actions = torch.as_tensor(actions, device=dev).long()
    B = s.batch_size
    if params.has_spawn_delays:
        # agent i activates at the start of the step whose pre-step
        # step_count equals its delay (placed at reset, hidden until then)
        dl = const(params.spawn_delay_tuple(), torch.int32, dev)
        s.active = s.active | ((dl > 0) & (dl == s.step_count[:, None]))
    x0, rw, y0, rh = interior_region(params)
    draws = rng.step_draws(s.key, N, params.max_place_tries, x0, rw, y0, rh,
                           with_respawn=params.respawn)
    s.key, perm = draws[0], draws[1]
    respawn_draws = draws[2:] if params.respawn else None

    rew = torch.zeros((B, N), dtype=torch.float32, device=dev)
    pre_cycles = s.cycles.clone()
    for j in range(N):  # sequential priority (SURVEY §3.3)
        rew = _agent_micro_step(params, s, rew, perm[:, j], actions,
                                respawn_draws)

    s.step_count = s.step_count + 1
    if params.reward_decay:
        rew = rew * reward_decay(params, s.step_count)[:, None]
    s.accum_reward = s.accum_reward + rew
    s.last_reward = rew
    # prestige display accumulator (SPEC §8): decay, then add this step's
    # non-negative reward (beta may differ per agent), one fused
    # multiply-add as XLA compiles it
    betas = const([float(np.float32(b)) for b in
                   params.prestige_beta_tuple()], torch.float64, dev)
    s.prestige = fma_f32(s.prestige, betas, torch.clamp(rew, min=0.0))

    alive = s.active
    if params.has_spawn_delays:
        # not-yet-spawned agents keep the episode alive (SPEC §5.5b)
        alive = alive | ((dl > 0) & (dl >= s.step_count[:, None]))
    done = (s.step_count >= params.max_steps) | ~alive.any(1)
    if params.reset_on_cycle:
        done = done | (s.cycles > pre_cycles).any(1)
    return s, rew, done


def _episode_info(stepped: EnvState, done):
    return {
        "episode_return": torch.where(done, stepped.accum_reward.sum(-1),
                                      0.0),
        "episode_length": torch.where(done, stepped.step_count, 0),
        "episode_cycles": torch.where(done, stepped.cycles.sum(-1).to(
            torch.int32), 0),
    }


def _select(done, stepped: EnvState, fresh: EnvState) -> EnvState:
    """Per env, the fresh state where done, else the stepped one; ``fresh``
    is batch B or batch 1 (one board for every env)."""
    def sel(a, b):
        return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)

    return EnvState(**{f: sel(getattr(stepped, f), getattr(fresh, f))
                       for f in FIELDS})


def step_autoreset(params: EnvParams, state: EnvState, actions):
    """Per-env autoreset (SPEC §9): every env that finishes restarts on its
    own fresh board, drawn from ``autoreset_key`` of its post-step key (B
    resets per step, of which about B/max_steps are used). Returns
    ``(state', rew, done, info)``, rew/done and info's episode aggregates
    the terminal step's."""
    stepped, rew, done = step(params, state, actions)
    fresh = reset(params, rng.autoreset_key(stepped.key))
    return _select(done, stepped, fresh), rew, done, _episode_info(stepped,
                                                                   done)


def step_autoreset_batch(params: EnvParams, state: EnvState, actions):
    """Batch-level autoreset (SPEC §9, shared-board variant): one fresh
    board per step (keyed off env 0's post-step key) for every env that
    finished, each with a distinct re-derived step key."""
    stepped, rew, done = step(params, state, actions)
    fresh = reset(params, rng.autoreset_key(stepped.key[:1]))
    return _select_fresh(stepped, rew, done, fresh)


def fresh_pool(params: EnvParams, key, n_pool: int) -> EnvState:
    """A K-layout pool of fresh boards (K = ``n_pool``): a batch-K state,
    layout k from ``split(key, n_pool)[k]`` (see the JAX
    ``fresh_pool_tiled``: layout diversity at K resets per rollout)."""
    return reset(params, rng.split(key, n_pool))


def fresh_pool_rows(pool: EnvState, t: int, offset: int,
                    batch: int) -> EnvState:
    """The fresh boards of step ``t`` for envs ``offset .. offset + batch``
    of a global batch that the pool size K divides: global env i takes
    layout ``(i - t) mod K`` of :func:`fresh_pool`'s ``pool``, the rows of
    the JAX ``rotate_fresh_batch(fresh_pool_tiled(...), t)``. A rank of a
    sharded batch gets its envs' rows whether or not K divides its own
    share (K may exceed it); one device takes ``offset=0``."""
    K = pool.batch_size
    idx = (offset - t + torch.arange(batch, device=pool.key.device)) % K
    return pool.map(lambda x: x[idx])


def step_autoreset_with_fresh_batch(params: EnvParams, state: EnvState,
                                    actions, fresh_b: EnvState,
                                    env_offset=0, salt=0):
    """Pool-diversity autoreset: env i that finishes restarts on
    ``fresh_b[i]``; ``salt`` (the rollout step index) is folded into the
    post-reset step keys so an env re-drawing the same pool layout at a
    later step still diverges."""
    stepped, rew, done = step(params, state, actions)
    B = done.shape[0]
    new_state = _select(done, stepped, fresh_b)
    ids = env_offset + torch.arange(B, device=done.device)
    env_keys = rng.fold_in(rng.fold_in(fresh_b.key, ids), salt)
    new_state.key = torch.where(done[:, None], env_keys, stepped.key)
    return new_state, rew, done, _episode_info(stepped, done)


def stagger_step_counts(state: EnvState, max_steps: int, offset: int = 0,
                        total: int = None) -> EnvState:
    """Spread initial episode phases evenly over the batch: env i starts at
    step_count i*max_steps//B (training init only). For a slice of a
    global batch of ``total`` envs whose first env is env ``offset``, i is
    the global index and B the global size."""
    B = state.batch_size
    idx = offset + torch.arange(B, dtype=torch.int32,
                                device=state.step_count.device)
    return state.replace(step_count=(idx * max_steps) // (total or B))


def _select_fresh(stepped: EnvState, rew, done, fresh: EnvState,
                  env_offset=0):
    B = done.shape[0]
    new_state = _select(done, stepped, fresh)
    # distinct per-env step keys so post-reset RNG streams diverge
    ids = env_offset + torch.arange(B, device=done.device)
    env_keys = rng.fold_in(fresh.key, ids)
    new_state.key = torch.where(done[:, None], env_keys, stepped.key)
    return new_state, rew, done, _episode_info(stepped, done)
