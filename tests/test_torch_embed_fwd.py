"""The host-side parts of the one-hot embed forwards K2f and K5f
(``csrc/embed_fwd.cu``), on the CPU.

The kernel cannot run here, so what it reads is held instead:

- its launch plan (``ops/embed.py::fwd_plan``) covers every sample and
  every hidden unit exactly once, fits a block's shared memory and depends
  on the shapes alone;
- the row bases, slot tables and feature walk the wrappers pass give each
  (sample, feature) the table row that the plain versions select, in both
  table layouts, bit for bit, and each mask word the features that can
  set its bits;
- the kernel's arithmetic (a 0/1 bf16 one-hot times the bf16 table, with
  float32 sums over 16-row k-steps in order) stays within each kernel's bar
  of its plain version, and agrees with JAX's Pallas kernels in interpret
  mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.ops import embed as JE
from marlgrid_tpu.ops import embed2 as JE2
from marlgrid_tpu_torch.ops import embed as E
from marlgrid_tpu_torch.ops import embed2 as E2

PALETTES = jobs.encode_palettes(JEnvParams(
    width=13, height=13, n_agents=4, scenario="goal_cycle",
    agent_colors=(0, 4, 5, 1), observation_style="encode"))
VOCABS = {"full": None, "palette": PALETTES}


def _codes(R, cells, S, seed):
    """Codes across and beyond both vocabularies: types up to 15, colors up
    to 12 (past the full widths and outside the palette), states up to 200
    (box-packed states clip at 19)."""
    rs = np.random.default_rng(seed)
    x = np.concatenate([rs.integers(0, 16, (R, cells, S)),
                        rs.integers(0, 13, (R, cells, S)),
                        rs.integers(0, 201, (R, cells, S))], axis=1)
    return torch.as_tensor(x.astype(np.uint8))


def _tables(cells, widths, H, seed):
    """Three per-plane float32 tables (cells, n_p, H), bf16 values."""
    rs = np.random.default_rng(seed)
    return [torch.as_tensor(rs.normal(size=(cells, n, H)) * 0.05).float()
            .to(torch.bfloat16).float() for n in widths]


def _lut(widths, values, plane_major):
    """The slot table the K2f or the K5f wrapper passes."""
    if plane_major:
        return E2.plane_slot_table(widths, values)
    return E.slot_table(widths, values)


def _kernel_rows(x, widths, values, plane_major):
    """(R, F, S) int64: the table row the kernel gives each (sample,
    feature), rbase[f] + lut[p, code], or -1 for none."""
    R, F, S = x.shape
    cells = F // 3
    lut = torch.as_tensor(_lut(widths, values, plane_major)).long()
    rbase = torch.as_tensor(E.row_bases(cells, widths, plane_major)).long()
    plane = torch.arange(F) // cells
    slot = lut[plane[None, :, None], x.long()]
    return torch.where(slot >= 0, rbase[None, :, None] + slot, -1)


def _kernel_onehot(x, widths, values, plane_major):
    """(R * S, P) float32: the kernel's one-hot A, one entry per selected
    row (counted, so a row selected twice would show as 2)."""
    R, F, S = x.shape
    P = F // 3 * sum(widths)
    rows = _kernel_rows(x, widths, values, plane_major)
    rows = rows.permute(0, 2, 1).reshape(R * S, F)
    A = torch.zeros(R * S, P + 1)
    A.scatter_add_(1, torch.where(rows >= 0, rows, P), torch.ones(R * S, F))
    return A[:, :P]


def _table(ws, plane_major):
    """The kernel's (P, H) table: the packed (cells, cw, H) table flattened
    (K2f) or the three plane tables flattened back to back (K5f)."""
    H = ws[0].shape[-1]
    if plane_major:
        return torch.cat([w.reshape(-1, H) for w in ws])
    return E.pack_weights(*ws).reshape(-1, H)


def _mma_sums(A, T):
    """The kernel's arithmetic on the CPU: bf16 A (0/1) times bf16 T, the
    products exact in float32, summed in float32 one 16-row k-step at a
    time in order, from +0.0."""
    out = torch.zeros(A.shape[0], T.shape[1])
    for k0 in range(0, A.shape[1], 16):
        out += A[:, k0:k0 + 16].to(torch.bfloat16).float() @ \
            T[k0:k0 + 16].to(torch.bfloat16).float()
    return out


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# ---------------------------------------------------------------- (a) plan

PLAN_SAMPLES = [(3, 100), (4, 4097), (2048, 128), (2, 4096)]


@pytest.mark.parametrize("H", [2, 24, 128, 136, 512, 2048])
@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("cells", [49, 25])
def test_fwd_plan_covers_each_sample_and_unit_once(cells, vocab, H):
    widths, _ = E.vocab(VOCABS[vocab])
    F, rows = 3 * cells, cells * sum(widths)
    for R, S in PLAN_SAMPLES:
        plan = E.fwd_plan(R, S, F, rows, H)
        assert plan == E.fwd_plan(R, S, F, rows, H)   # the shapes alone
        # the staged slice, the masks and the feature table fit the
        # 227 KB a block may use, beside the static slot table
        assert plan.smem == E.fwd_smem(F, plan.k_steps, plan.bn)
        assert plan.smem + 3 * 256 * 2 <= 227 * 1024
        assert plan.k_steps % 2 == 0
        assert plan.k_steps * 16 >= rows > (plan.k_steps - 2) * 16
        assert plan.bn in (16, 32, 64, 128)
        # hidden units: groups of bn, each unit in exactly one
        units = np.zeros(plan.n_groups * plan.bn, int)
        for grp in range(plan.n_groups):
            units[grp * plan.bn:(grp + 1) * plan.bn] += 1
        assert (units[:H] == 1).all() and plan.n_groups * plan.bn - H < \
            plan.bn
        # samples: block b takes group b % n_groups and tiles b // n_groups,
        # + blocks, ...; every (group, tile) exactly once, every block busy
        seen = np.zeros((plan.n_groups, plan.tiles), int)
        for b in range(plan.blocks * plan.n_groups):
            mine = np.arange(b // plan.n_groups, plan.tiles, plan.blocks)
            assert mine.size > 0
            seen[b % plan.n_groups, mine] += 1
        assert (seen == 1).all()
        assert plan.tiles * E._FWD_TILE >= R * S > \
            (plan.tiles - 1) * E._FWD_TILE
        assert plan.blocks * plan.n_groups <= max(E._FWD_SMS, plan.n_groups)


def test_fwd_plan_refuses_a_table_too_large_for_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        E.fwd_plan(4, 4096, 147, 49 * 200, 128)


# ------------------------------------------------------ (b) row addressing

@pytest.mark.parametrize("plane_major", [False, True], ids=["K2f", "K5f"])
@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("cells", [49, 25])
def test_row_bases_select_the_plain_rows(cells, vocab, plane_major):
    """The one-hot the kernel builds from the row bases and the slot table
    equals the plain version's, read through identity tables (the plain
    version of a table whose row k is e_k returns the one-hot row of each
    sample), exactly; each row is selected at most once per sample."""
    widths, values = E.vocab(VOCABS[vocab])
    R, S = 3, 100
    x = _codes(R, cells, S, seed=cells + len(vocab))
    P = cells * sum(widths)
    eye = torch.eye(P)
    A = _kernel_onehot(x, widths, values, plane_major)
    if plane_major:
        ws, k0 = [], 0
        for n in widths:
            ws.append(eye[k0:k0 + cells * n].reshape(cells, n, P))
            k0 += cells * n
        want = E2.onehot_embed2_plain(x, *ws, widths, values)
    else:
        want = E.onehot_embed_plain(x, eye.reshape(cells, -1, P), widths,
                                    values, torch.float32)
    assert torch.equal(A, want.reshape(R * S, P))
    assert float(A.max()) == 1.0 and float(A.sum()) > 0


@pytest.mark.parametrize("plane_major", [False, True], ids=["K2f", "K5f"])
@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("cells", [49, 25])
def test_fwd_walk_covers_each_word(cells, vocab, plane_major):
    """The kernel walks the features in the order ``fwd_walk`` gives
    (every feature once, with its row base; along it the rows a sample
    selects rise strictly), and builds each 32-row mask word from one range
    of that walk: every feature that selects a row in the word lies in the
    word's range."""
    widths, values = E.vocab(VOCABS[vocab])
    F, P = 3 * cells, cells * sum(widths)
    walk = E.fwd_walk(cells, widths, plane_major)
    feats = walk[:2 * F].reshape(F, 2)
    ranges = torch.as_tensor(walk[2 * F:].reshape(-1, 2))
    rbase = E.row_bases(cells, widths, plane_major)
    assert sorted(feats[:, 0].tolist()) == list(range(F))
    assert (feats[:, 1] == rbase[feats[:, 0]]).all()
    assert len(ranges) == -(-P // 32)
    x = _codes(3, cells, 100, seed=31)
    rows = _kernel_rows(x, widths, values, plane_major)[:, feats[:, 0]]
    rows = rows.permute(0, 2, 1).reshape(-1, F)
    for sample in rows:
        picked = sample >= 0
        assert (sample[picked][1:] > sample[picked][:-1]).all()
        at = torch.nonzero(picked).flatten()
        word = sample[picked] // 32
        assert ((ranges[word, 0] <= at) & (at < ranges[word, 1])).all()


@pytest.mark.parametrize("plane_major", [False, True], ids=["K2f", "K5f"])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_row_bases_gather_sum(vocab, plane_major):
    """The gather-sum in float32 over the rows the kernel selects equals
    the plain version up to the order of the float32 sums."""
    widths, values = E.vocab(VOCABS[vocab])
    cells, R, S, H = 49, 3, 257, 24
    x = _codes(R, cells, S, seed=11)
    ws = _tables(cells, widths, H, seed=12)
    rows = _kernel_rows(x, widths, values, plane_major)
    T = torch.cat([_table(ws, plane_major), torch.zeros(1, H)])
    got = T[torch.where(rows >= 0, rows, T.shape[0] - 1)].sum(1)
    if plane_major:
        want = E2.onehot_embed2_plain(x, *ws, widths, values)
    else:
        want = E.onehot_embed_plain(x, E.pack_weights(*ws), widths, values,
                                    torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------- (c) arithmetic

@pytest.mark.parametrize("S", [100, 257])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_mma_arithmetic_within_k2f_bar(vocab, S):
    """K2f's bar: its float32 sums rounded once to bf16 within 1 bf16 ulp
    (+2**-20 where the sum cancels) of the plain float32 sum so rounded."""
    widths, values = E.vocab(VOCABS[vocab])
    cells, R, H = 49, 3, 136
    x = _codes(R, cells, S, seed=S)
    ws = _tables(cells, widths, H, seed=S + 1)
    got = _mma_sums(_kernel_onehot(x, widths, values, False),
                    _table(ws, False)).to(torch.bfloat16).reshape(R, S, H)
    ref = E.onehot_embed_plain(x, E.pack_weights(*ws), widths, values,
                               torch.float32).to(torch.bfloat16)
    err = (got.float() - ref.float()).abs()
    assert (err <= _bf16_ulp(ref) + 2.0 ** -20).all()


@pytest.mark.parametrize("S", [100, 257])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_mma_arithmetic_within_k5f_bar(vocab, S):
    """K5f's bar: within 1e-5 of max |out| of the plain float32 sum."""
    widths, values = E.vocab(VOCABS[vocab])
    cells, R, H = 25, 3, 24
    x = _codes(R, cells, S, seed=S + 2)
    ws = _tables(cells, widths, H, seed=S + 3)
    got = _mma_sums(_kernel_onehot(x, widths, values, True),
                    _table(ws, True)).reshape(R, S, H)
    ref = E2.onehot_embed2_plain(x, *ws, widths, values)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("vocab", list(VOCABS))
def test_mma_arithmetic_matches_pallas(vocab):
    """The kernel's arithmetic against JAX's Pallas kernels in interpret
    mode, at one small shape: K2f's against ``onehot_embed`` with
    tests/test_torch_embed.py's tolerance (the Pallas kernel returns bf16),
    K5f's against ``onehot_embed2`` within 1e-5 of max |out| (both sum
    exact products in float32 and return float32)."""
    widths, values = E.vocab(VOCABS[vocab])
    cells, R, S, H = 49, 2, 128, 128
    x = _codes(R, cells, S, seed=21)
    ws = _tables(cells, widths, H, seed=22)
    jw = [jnp.asarray(w.numpy()) for w in ws]
    want = JE.onehot_embed(jnp.asarray(x.numpy()), JE.pack_weights(*jw),
                           cells, 128, True, widths, values)
    got = _mma_sums(_kernel_onehot(x, widths, values, False),
                    _table(ws, False)).to(torch.bfloat16).reshape(R, S, H)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=2e-2)
    want2 = np.asarray(JE2.onehot_embed2(jnp.asarray(x.numpy()), *jw, cells,
                                         128, True, widths, values))
    got2 = _mma_sums(_kernel_onehot(x, widths, values, True),
                     _table(ws, True)).reshape(R, S, H).numpy()
    assert np.abs(got2 - want2).max() <= 1e-5 * np.abs(want2).max()
