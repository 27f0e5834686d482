"""The host-side parts of the port's two redesigned kernels, on the CPU.

K3 (``ops/sprite.py``): the kernel reads nothing but the re-laid tables
(:func:`kernel_tables`) and the granule map (:func:`granule_map`), so a
composite rebuilt from those alone, granule by granule as the kernel
copies them, must equal the plain version bit for bit. It is rebuilt here
for every (base, agent, level) triple the tables hold, in both layouts, at
T = 8 and T = 4 (16-byte s2d pieces, 8-byte granules and the byte path).

K2b (``ops/embed.py::bwd_plan``): the launch plan covers every row, hidden
unit and sample exactly once and depends on the shapes alone, at the
shapes the port runs it at."""
import numpy as np
import pytest
import torch

from marlgrid_tpu_torch.core import constants as C
from marlgrid_tpu_torch.core import obs
from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
from marlgrid_tpu_torch.ops import embed as E
from marlgrid_tpu_torch.ops import sprite


def every_triple(vs):
    """(1, vs, vs, B) int32 ids holding every (base, agent, level) triple,
    the last view padded with the first triples."""
    base, agent, lvl = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(obs.N_BASE_APPEAR + 1), torch.arange(obs.N_AGENT_APPEAR),
        torch.arange(C.N_PRESTIGE_LEVELS), indexing="ij"))
    B = -(-base.numel() // (vs * vs))
    pad = B * vs * vs - base.numel()
    return tuple(torch.cat([a, a[:pad]]).reshape(B, vs, vs).permute(
        1, 2, 0)[None].to(torch.int32).contiguous()
        for a in (base, agent, lvl))


def rebuild(T, vs, s2d, base_id, agent_id, alvl):
    """What the kernel writes, (N, B) images: per granule, the base row's
    bytes at the granule's offset; where the cell shows an agent, the
    level's overlay where the mask is set."""
    base_t, over, mask = sprite.kernel_tables(T, s2d, torch.device("cpu"))
    G, gmap = sprite.granule_map(vs, T, s2d, torch.device("cpu"))
    cell, off = (gmap & 0xFFFF).long(), (gmap >> 16).long()
    N, B = base_id.shape[0], base_id.shape[3]
    ids = [a.reshape(N, vs * vs, B)[:, cell].permute(0, 2, 1)[..., None]
           .long() for a in (base_id, agent_id, alvl)]    # (N, B, grains, 1)
    byte = off[:, None] + torch.arange(G)                 # (grains, G)
    b, a, lv = ids
    img = base_t[b, byte]
    m = mask[a, byte]
    img = torch.where(a > 0, (over[lv, a, byte] & m) | (img & ~m), img)
    return img.reshape((N, B) + sprite._image_shape(vs, T, s2d))


@pytest.mark.parametrize("T", [8, 4])
@pytest.mark.parametrize("vs", [5, 7])
@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "standard"])
def test_relaid_tables_rebuild_every_triple(T, vs, s2d):
    ep = EnvParams(n_agents=1, view_size=vs, view_tile_size=T,
                   observation_style="image",
                   agent_colors=default_agent_colors(1))
    ids = every_triple(vs)
    want = sprite.compose_image_b_plain(ep, *ids, nb_layout=True, s2d=s2d)
    got = rebuild(T, vs, s2d, *ids)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert sprite.granule(T, s2d) == (16 if s2d else 8 if T == 8 else 1)
    # the kernel skips the overlay of agent row 0: its mask must be empty
    assert not sprite.kernel_tables(T, s2d, torch.device("cpu"))[2][0].any()


#: (R, cells, S, H, palette) at the shapes the port runs K2b at: the
#: update's minibatch with the goal_cycle palette and with the full
#: vocabulary, a rollout's (R = 4 agents, S = 4096 envs), a hetero 5x5
#: group's update, and the mixed population's encode group (H = 16)
PALETTE = ((0, 1, 2, 10), (0, 1, 2, 3, 5, 6, 7), (0, 1, 2, 3))
PLAN_SHAPES = {
    "update, palette": (2048, 49, 128, 128, PALETTE),
    "update, full": (2048, 49, 128, 128, None),
    "rollout": (4, 49, 4096, 128, PALETTE),
    "hetero 5x5": (1024, 25, 128, 128, None),
    "mixed encode, H=16": (1024, 49, 32, 16, None),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_bwd_plan_covers_each_row_and_sample_once(shape):
    R, cells, S, H, pal = PLAN_SHAPES[shape]
    widths, _ = E.vocab(pal)
    cw = sum(widths)
    plan = E.bwd_plan(R, S, cells, cw, H)
    assert plan == E.bwd_plan(R, S, cells, cw, H)   # the shapes alone
    assert plan.bn in (16, 32, 64, 128) and (plan.bn >= H or plan.bn == 128)
    assert plan.bm == 32 * 8 // (plan.bn // min(plan.bn, 64))
    # rows: tiles of bm, each row in exactly one, and the cells a tile
    # touches within the slot rows the kernel stages
    rows = np.arange(cells * cw)
    tiles = rows // plan.bm
    assert tiles.max() == plan.row_groups - 1
    assert np.bincount(tiles).sum() == rows.size
    for g in range(plan.row_groups):
        touched = np.unique(rows[tiles == g] // cw)
        assert touched.size <= plan.span
        assert (touched == np.arange(touched[0], touched[-1] + 1)).all()
    # hidden units: n_groups tiles of bn (the last padded)
    assert (plan.n_groups - 1) * plan.bn < H <= plan.n_groups * plan.bn
    # samples: chunks of a whole number of the kernel's steps (128
    # samples), each sample in exactly one, none empty
    M = R * S
    assert plan.chunk % E._BWD_STEP == 0 and E._BWD_STEP == 128
    starts = np.arange(plan.n_chunks) * plan.chunk
    assert (starts < M).all() and starts[-1] + plan.chunk >= M
    counts = np.zeros(M, np.int64)
    for s0 in starts:
        counts[s0:s0 + plan.chunk] += 1
    assert (counts == 1).all()
    # one wave of two blocks per SM of an H100, fixed in the code, not
    # queried from the card
    per_chunk = plan.row_groups * plan.n_groups
    assert per_chunk * plan.n_chunks <= max(2 * 132, per_chunk)
