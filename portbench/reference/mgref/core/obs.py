"""Batched egocentric observations (SPEC §7, PyTorch port): 'encode'
codes and 'image' pixels.

Counterpart of the batch-minor ``*_b`` functions of
``marlgrid_tpu/core/obs.py``. The window extraction reads the flat packed
board with one gather per env (the JAX package uses a one-hot einsum pair
because TPU gathers serialize; int32 is exact where JAX goes through f32,
all packed values being < 2**24), then the ``(B, K) -> (K, B)`` layout swap
goes through the transpose kernel (ops/transpose.py). Occlusion is the same
closed-form per-column reachability as ``process_vis_b``. Image
observations (and the pov of the 'rich' style) turn the view cells into
sprite-table ids and render them through the sprite-composite kernel
(ops/sprite.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const
from . import constants as C
from .state import EnvParams, EnvState

NS = 3  # sprite-relevant states per type (door open/closed/locked)
N_BASE_APPEAR = C.N_TYPES * C.N_COLORS * NS
N_AGENT_APPEAR = 1 + C.N_COLORS * 4  # 0 = no agent overlay

# Cell packing: one int carries (type, color, state) plus the agent overlay
# (see pack_grid_with_agents).
_PACK_C = C.N_TYPES          # color multiplier
_PACK_S = C.N_TYPES * 16     # state multiplier (color < 16)
_PACK_A = 32768              # agent-overlay field (cell bits < 32768)
_WALL = C.WALL + _PACK_C * C.COLOR_TO_IDX["grey"]


@functools.lru_cache(maxsize=None)
def rel_offsets(view_size: int, view_offset: int) -> np.ndarray:
    """(4, vs, vs, 2) world-coordinate offsets of each view cell (SPEC §7).

    View cell (vi, vj) of an agent at pos p facing d shows world cell
    ``p + (aj - vj) * DIR_VEC[d] + (vi - c) * DIR_VEC[(d+1) % 4]`` with
    c = vs//2, aj = vs-1-view_offset.
    """
    vs = view_size
    c, aj = vs // 2, vs - 1 - view_offset
    out = np.zeros((4, vs, vs, 2), np.int32)
    for d in range(4):
        up = C.DIR_VEC[d]
        right = C.DIR_VEC[(d + 1) % 4]
        for vi in range(vs):
            for vj in range(vs):
                out[d, vi, vj] = (aj - vj) * up + (vi - c) * right
    return out


def pack_grid(state: EnvState) -> torch.Tensor:
    """(B, W*H) int32 packed board: type + 11*color + 176*state."""
    return (state.grid_type.to(torch.int32)
            + _PACK_C * state.grid_color.to(torch.int32)
            + _PACK_S * state.grid_state.to(torch.int32))


def apply_hidden(params: EnvParams, vt, vc, vst):
    """Blank out hidden object types (visual-only: callers compute
    transparency from the raw layers before applying this)."""
    for t in params.hide_item_types:
        h = vt == t
        vt = torch.where(h, C.EMPTY, vt)
        vc = torch.where(h, 0, vc)
        vst = torch.where(h, 0, vst)
    return vt, vc, vst


def _observer_agents(bstate: EnvState, observers):
    """(B, n, 2) pos + (B, n) dir of the observing agents — all of them
    (observers=None) or a static index subset."""
    if observers is None:
        return bstate.agent_pos, bstate.agent_dir
    idx = const(observers, torch.int64, bstate.agent_pos.device)
    return bstate.agent_pos[:, idx], bstate.agent_dir[:, idx]


def _offsets(params: EnvParams, device) -> torch.Tensor:
    return const(rel_offsets(params.view_size, params.view_offset),
                 torch.int32, device)


def view_coords_bminor(params: EnvParams, bstate: EnvState, observers=None):
    """(n, vs, vs, B) world x, world y, in-bounds — batch-minor."""
    offs = _offsets(params, bstate.agent_pos.device)    # (4, vs, vs, 2)
    apos, adir = _observer_agents(bstate, observers)
    sel = offs[adir.T.long()].permute(0, 2, 3, 1, 4)    # (n, vs, vs, B, 2)
    wx = sel[..., 0] + apos[..., 0].T[:, None, None, :]
    wy = sel[..., 1] + apos[..., 1].T[:, None, None, :]
    inb = ((wx >= 0) & (wx < params.width)
           & (wy >= 0) & (wy < params.height))
    return wx, wy, inb


def prestige_level(params: EnvParams, prestige) -> torch.Tensor:
    """(…, N) int32 quantized prestige level per agent (SPEC §8):
    ``floor(prestige / scale)`` in float32, clipped to the levels; the
    scale may differ per observed agent (last axis)."""
    scale = const(params.prestige_scale_tuple(), torch.float32,
                  prestige.device)
    return torch.clamp(torch.floor(prestige / scale).to(torch.int32), 0,
                       C.N_PRESTIGE_LEVELS - 1)


def pack_grid_with_agents(params: EnvParams, bstate: EnvState,
                          with_lvl=False) -> torch.Tensor:
    """(B, W*H) int32 packed board WITH the agent overlay painted in:
    value = cell + _PACK_A*(1 + color*4 + absdir + 64*prestige_level)
    (the level field only ``with_lvl``, for the image path; at most about
    15.9M, well inside int32).

    Painted high-index-first so the lowest agent index wins a shared cell
    (ghost-mode stacking, SPEC §7); inactive agents hidden when ghost_mode.
    """
    N = params.n_agents
    WH = params.width * params.height
    dev = bstate.agent_pos.device
    flat = (bstate.agent_pos[..., 0] * params.height
            + bstate.agent_pos[..., 1])                       # (B, N)
    shown = bstate.active if params.ghost_mode \
        else torch.ones_like(bstate.active)
    lvl = prestige_level(params, bstate.prestige) if with_lvl else None
    plane = torch.zeros((flat.shape[0], WH), dtype=torch.int32, device=dev)
    cells = torch.arange(WH, device=dev)
    for j in reversed(range(N)):           # lowest index paints last/wins
        sel = (flat[:, j:j + 1] == cells) & shown[:, j:j + 1]
        val = (1 + params.agent_colors[j] * 4) + bstate.agent_dir[:, j:j + 1]
        if with_lvl:
            val = val + lvl[:, j:j + 1] * 64
        plane = torch.where(sel, val, plane)
    return pack_grid(bstate) + plane * _PACK_A


def extract_views_b(params: EnvParams, bstate: EnvState, wx, wy, inb,
                    packed=None, observers=None) -> torch.Tensor:
    """Packed view values for all envs/agents: (n, vs, vs, B) int32; OOB
    cells read as grey wall (SPEC §7).

    One gather of the flat packed board gives the (B, K) B-major values,
    K = n*vs*vs; the transpose kernel swaps them batch-minor.
    """
    from ..ops import transpose_bk

    vs = params.view_size
    W, H = params.width, params.height
    B = bstate.grid_type.shape[0]
    apos, adir = _observer_agents(bstate, observers)
    n = apos.shape[1]
    offs = _offsets(params, apos.device).reshape(4, vs * vs, 2)
    sel = offs[adir.long()]                               # (B, n, vs*vs, 2)
    wxB = (apos[..., 0:1] + sel[..., 0]).reshape(B, n * vs * vs)
    wyB = (apos[..., 1:2] + sel[..., 1]).reshape(B, n * vs * vs)
    idx = (wxB.clamp(0, W - 1) * H + wyB.clamp(0, H - 1)).long()
    g = pack_grid(bstate) if packed is None else packed
    vals = g.gather(1, idx)                               # (B, K) int32
    pv = transpose_bk(vals).reshape(n, vs, vs, B)
    return torch.where(inb, pv, _WALL)


def all_view_cells_b(params: EnvParams, bstate: EnvState, observers=None,
                     packed=None, with_dim=False):
    """Batched view cells, all outputs (n, vs, vs, B) batch-minor: type,
    color, state, agent-present, agent color and relative agent dir,
    decoded from the extraction of the agent-painted board; ``with_dim``
    appends the observed agent's prestige level (int32, 0 where no agent),
    read from the board's level field."""
    wx, wy, inb = view_coords_bminor(params, bstate, observers)
    if packed is None:
        packed = pack_grid_with_agents(params, bstate, with_lvl=with_dim)
    pv = extract_views_b(params, bstate, wx, wy, inb, packed, observers)
    low = pv % _PACK_A
    vt = low % _PACK_C
    vc = (low // _PACK_C) % 16
    vst = low // _PACK_S
    ab = pv // _PACK_A
    A = ab % 64
    any_agent = A > 0
    acolor = torch.where(any_agent, (A - 1) // 4, 0)
    _, adir = _observer_agents(bstate, observers)
    dobs = adir.T[:, None, None, :]                 # observer dir (n,1,1,B)
    reldir = torch.where(any_agent, ((A - 1) % 4 - dobs + 3) % 4, 0)
    if not with_dim:
        return vt, vc, vst, any_agent, acolor, reldir
    return vt, vc, vst, any_agent, acolor, reldir, ab // 64


def transparency_b(vt, vst):
    """see_behind per view cell — only walls and non-open doors block."""
    return ~((vt == C.WALL) | ((vt == C.DOOR) & (vst != C.DOOR_OPEN)))


def process_vis_b(t, view_size: int, view_offset: int) -> torch.Tensor:
    """Occlusion mask (minigrid flood, SPEC §7) of a (n, vs, vs, B)
    transparency grid indexed [., vi, vj, .].

    Per view column, from the agent's row outward: a left-pass reaches i
    from a seed k <= i iff t[k..i-1] are all transparent, i.e. the prefix
    opaque-counts agree — a prefix max; the right-pass is the mirrored
    suffix min.
    """
    vs = view_size
    c, aj = vs // 2, vs - 1 - view_offset
    n, B = t.shape[0], t.shape[3]
    dev = t.device
    ii = torch.arange(vs, device=dev)
    not_last = (ii != vs - 1)[None, :, None]       # (1, vs, 1)
    not_first = (ii != 0)[None, :, None]
    init_col = (ii == c)[None, :, None]

    cols = [None] * vs
    pending = torch.zeros((n, vs, B), dtype=torch.bool, device=dev)
    for vj in range(vs - 1, -1, -1):
        m = pending | init_col if vj == aj else pending
        trow = t[:, :, vj]                         # (n, vs, B)
        opaque = (~trow).to(torch.int32)
        cs = torch.cumsum(opaque, dim=1, dtype=torch.int32)
        cs0 = cs - opaque
        q = torch.where(m, cs0, -1)
        rL = torch.cummax(q, dim=1)[0] == cs0
        condL = rL & trow & not_last
        upL = condL | (torch.roll(condL, 1, dims=1) & not_first)
        r = torch.where(rL, cs, 127)
        rR = torch.cummin(r.flip(1), dim=1)[0].flip(1) == cs
        condR = rR & trow & not_first
        upR = condR | (torch.roll(condR, -1, dims=1) & not_last)
        cols[vj] = rR
        pending = upL | upR
    return torch.stack(cols, dim=2)                # (n, vs, vs, B)


def all_obs_encode_b(params: EnvParams, bstate: EnvState, bminor=False,
                     observers=None, packed=None) -> torch.Tensor:
    """Batched 'encode' obs — bit-equal to the JAX ``all_obs_encode_b``.

    ``bminor=False``: (B, n, vs, vs, 3) int32; ``bminor=True``:
    (3, n, vs, vs, B) int32, the layout the feature-major policy consumes.
    ``observers``: static agent-index subset that observes (the painted
    board still carries every agent); ``packed``: a precomputed
    ``pack_grid_with_agents`` board.
    """
    vt, vc, vst, any_agent, acolor, reldir = all_view_cells_b(
        params, bstate, observers=observers, packed=packed)
    hvt, hvc, hvst = apply_hidden(params, vt, vc, vst)
    ot = torch.where(any_agent, C.AGENT, hvt)
    oc = torch.where(any_agent, acolor, hvc)
    os_ = torch.where(any_agent, reldir, hvst)
    if not params.see_through_walls:
        vis = process_vis_b(transparency_b(vt, vst), params.view_size,
                            params.view_offset)
        ot, oc, os_ = (torch.where(vis, a, 0) for a in (ot, oc, os_))
    out = torch.stack([ot, oc, os_], dim=0).to(torch.int32)
    if bminor:
        return out
    return out.permute(4, 1, 2, 3, 0)


def base_appearance(vt, vc, vst):
    """Sprite-table row of the cell's base object (door state only)."""
    s_vis = torch.where(vt == C.DOOR, torch.clamp(vst, 0, NS - 1), 0)
    return (vt * C.N_COLORS + vc) * NS + s_vis


def image_ids(params: EnvParams, bstate: EnvState, observers=None,
              packed=None):
    """The sprite-table ids of every view cell, (n, vs, vs, B) contiguous
    int32 each: base id (N_BASE_APPEAR = black, an invisible cell), agent
    id (0 = none, else 1 + color*4 + reldir) and the observed agent's
    prestige level. Hidden types are blanked after transparency is taken
    from the raw cells. ``observers``/``packed``: see
    :func:`all_obs_encode_b` (a shared board must be painted
    ``with_lvl=True``)."""
    vt, vc, vst, any_agent, acolor, reldir, alvl = all_view_cells_b(
        params, bstate, observers=observers, packed=packed, with_dim=True)
    base_id = base_appearance(*apply_hidden(params, vt, vc, vst))
    agent_id = torch.where(any_agent, 1 + acolor * 4 + reldir, 0)
    if not params.see_through_walls:
        vis = process_vis_b(transparency_b(vt, vst), params.view_size,
                            params.view_offset)
        base_id = torch.where(vis, base_id, N_BASE_APPEAR)
        agent_id = torch.where(vis, agent_id, 0)
    return tuple(a.to(torch.int32).contiguous()
                 for a in (base_id, agent_id, alvl))


def all_obs_image_b(params: EnvParams, bstate: EnvState, bminor=False,
                    s2d=False, observers=None, packed=None) -> torch.Tensor:
    """Batched 'image' obs — bit-equal to the JAX ``all_obs_image_b``.

    (B, n, vs*T, vs*T, 3) uint8; ``bminor=True``: (n, B, ...), the layout
    whose leading dims the update folds into one batch; ``s2d=True``: the
    space-to-depth (..., vs*T/4, vs*T/4, 48) layout the 'cnn_s2d' torso
    reads. The ids of :func:`image_ids` render through the sprite
    composite (``ops/sprite.py``: kernel K3 on the card, its plain version
    on the CPU).
    """
    from ..ops import sprite

    return sprite.compose_image_b(
        params, *image_ids(params, bstate, observers, packed),
        nb_layout=bminor, s2d=s2d)


def all_agent_obs_b(params: EnvParams, bstate: EnvState, bminor=False,
                    s2d=False):
    """Batched obs for a batch-leading state: 'encode' codes (B, N, vs, vs,
    3) int32, or (3, N, vs, vs, B) with ``bminor``; any other style renders
    the image pov (B, N, ...) uint8, or (N, B, ...) with ``bminor``, in the
    s2d layout with ``s2d`` (see :func:`all_obs_image_b`)."""
    if params.observation_style == "encode":
        return all_obs_encode_b(params, bstate, bminor=bminor)
    return all_obs_image_b(params, bstate, bminor=bminor, s2d=s2d)


def encode_palettes(params: EnvParams):
    """Static per-plane code vocabularies of the 'encode' observation for
    this scenario — ((types…), (colors…), (states…)) sorted tuples, or
    None when the scenario has no registered palette (the JAX package's
    ``encode_palettes``; used by models.OneHotEmbed(palettes=…), where a
    code outside the vocabulary gives a zero row)."""
    from .grid_gen import SCENARIO_PALETTES

    pal = SCENARIO_PALETTES.get(params.scenario)
    if pal is None:
        return None
    hidden = set(params.hide_item_types)
    types = {C.EMPTY, C.WALL, C.AGENT}
    colors = {0, C.COLOR_TO_IDX["grey"]}
    states = {0, 1, 2, 3}
    for (t, c, s) in pal:
        if t in hidden:
            continue
        types.add(t)
        colors.add(c)
        states.add(s)
        if t == C.BONUS:
            states |= set(range(params.n_bonus_tiles))
        if t == C.GOAL:
            states |= set(range(max(1, len(params.goal_rewards))))
    colors |= set(params.agent_colors)
    return (tuple(sorted(types)), tuple(sorted(colors)),
            tuple(sorted(states)))


def validate_encode_palette(params: EnvParams, key=None, n_envs: int = 4,
                            n_steps: int = 24, device="cuda"):
    """Check that the scenario's declared palette covers every code its
    'encode' obs show (the JAX package's ``validate_encode_palette``): a
    compact vocabulary maps an out-of-vocabulary code to an all-zero embed
    row, so an incomplete ``register_scenario(palette=...)`` would train on
    blanked cells without a word.

    Resets ``n_envs`` boards and random-walks them ``n_steps`` steps with
    the JAX function's keys (the same boards), checking every observed
    (type, color, state) plane code against :func:`encode_palettes`; raises
    ValueError naming the missing codes and the step that showed them.
    ``key``: a ``(2,)`` key (default ``PRNGKey(0)``), its device the one the
    sweep runs on; else it runs on ``device``."""
    from . import grid_gen, rng, step as step_mod

    pals = encode_palettes(params)
    if pals is None:
        return
    key = rng.PRNGKey(0, device=device) if key is None else key
    state = grid_gen.reset(params, rng.split(rng.fold_in(key, 0), n_envs))
    vocabs = [set(v) for v in pals]
    names = ("type", "color", "state")

    def check(state, t):
        obs = all_obs_encode_b(params, state).cpu().numpy()
        for i, vocab in enumerate(vocabs):
            missing = set(np.unique(obs[..., i]).tolist()) - vocab
            if missing:
                raise ValueError(
                    f"scenario {params.scenario!r}: encode palette misses "
                    f"{names[i]} codes {sorted(missing)} (observed at "
                    f"random-walk step {t}; declared vocabulary "
                    f"{sorted(vocab)}). Fix the register_scenario("
                    f"palette=…) declaration, or disable compact embed "
                    f"vocabularies (--no-embed-palette)")

    check(state, 0)
    for t in range(n_steps):
        key, ak = rng.split(key)
        acts = rng.randint(ak, (n_envs, params.n_agents), 0, C.N_ACTIONS)
        state = step_mod.step_autoreset_batch(params, state, acts)[0]
        check(state, t + 1)


# ---------------------------------------------------------------------------
# One env's observations, for the host env (``wrapper.py``): the JAX
# package's unbatched functions, each the batched function above run on the
# host env's batch-1 state with the batch axis squeezed, so the host path
# runs the same engine and, on the card, the same kernels (K1 for encode
# views, K3 for pixels). ``state`` is a batch-1 EnvState.
# ---------------------------------------------------------------------------


def transparency(vt, vst):
    """see_behind per view cell, any shape (:func:`transparency_b`)."""
    return transparency_b(vt, vst)


