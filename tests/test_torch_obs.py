"""The port's batched 'encode' observations against the JAX package: bit-
equal ``all_obs_encode_b`` (both layouts, observer subsets, a shared
painted board) on ladder states, the palettes, the constants, and K1's
plain version against ``marlgrid_tpu.ops.transpose_bk``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu import ops as jops
from marlgrid_tpu.core import constants as JC
from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import EnvState as JEnvState
from marlgrid_tpu_torch.core import constants as C, grid_gen, obs as obs_mod
from marlgrid_tpu_torch.core import rng, step as step_mod
from marlgrid_tpu_torch.core.state import EnvParams, state_to_numpy
from marlgrid_tpu_torch.ops import transpose as T
from test_parity import LADDER

B = 8

# besides the ladder: hidden types, view offset, see-through walls, view 5
EXTRA = [
    JEnvParams(width=11, height=11, n_agents=3, scenario="cluttered",
               n_clutter=15, view_size=5, view_offset=1, hide_item_types=(1,),
               agent_colors=(0, 4, 5), observation_style="encode",
               max_steps=30),
    JEnvParams(width=9, height=9, n_agents=2, scenario="doorkey",
               see_through_walls=True, ghost_mode=False, agent_colors=(0, 4),
               observation_style="encode", max_steps=30),
]
CASES = [p.values[0] for p in LADDER] + EXTRA


def _states(params, n_steps=12):
    """A batch of port states after a few random steps (agents moved,
    stacked, deactivated); reset and step are held bit-equal to JAX by
    test_torch_env.py."""
    s = grid_gen.reset(params, rng.split(rng.PRNGKey(3, device="cpu"), B))
    acts = torch.as_tensor(np.random.default_rng(3).integers(
        0, 7, (n_steps, B, params.n_agents)))
    for a in acts:
        s = step_mod.step(params, s, a)[0]
    return s


def _jax_obs(jparams, js):
    """The JAX observations in every form the test compares, from one
    jitted program."""
    obs_ids = tuple(range(1, jparams.n_agents))

    @jax.jit
    def run(s):
        out = [jobs.all_obs_encode_b(jparams, s),
               jobs.all_obs_encode_b(jparams, s, bminor=True),
               jobs.pack_grid_with_agents(jparams, s)]
        if obs_ids:
            out.append(jobs.all_obs_encode_b(
                jparams, s, observers=obs_ids,
                packed=jobs.pack_grid_with_agents(jparams, s)))
        return out
    return [np.asarray(x) for x in run(js)]


@pytest.mark.parametrize("jparams", CASES, ids=lambda p: (
    f"{p.scenario}-{p.width}-{p.n_agents}ag-vs{p.view_size}"
    f"{'-stw' if p.see_through_walls else ''}"
    f"{'-noghost' if not p.ghost_mode else ''}"))
def test_all_obs_encode_b(jparams):
    params = EnvParams.from_dict(jparams.to_dict())
    ts = _states(params)
    js = JEnvState(**{f: jnp.asarray(v)
                      for f, v in state_to_numpy(ts).items()})
    want = _jax_obs(jparams, js)
    got = [obs_mod.all_obs_encode_b(params, ts),
           obs_mod.all_obs_encode_b(params, ts, bminor=True),
           obs_mod.pack_grid_with_agents(params, ts)]
    want[2] = want[2].astype(np.int32)     # JAX packs it exactly in f32
    if params.n_agents > 1:
        obs_ids = tuple(range(1, params.n_agents))
        packed = obs_mod.pack_grid_with_agents(params, ts)
        got.append(obs_mod.all_obs_encode_b(params, ts, observers=obs_ids,
                                            packed=packed))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        obs_mod.all_agent_obs_b(params, ts, bminor=True).numpy(), want[1])


def test_encode_palettes_and_rel_offsets():
    for jp in CASES + [LADDER[4].values[0].replace(goal_rewards=(1.0, 2.0),
                                                   scenario="empty")]:
        p = EnvParams.from_dict(jp.to_dict())
        assert obs_mod.encode_palettes(p) == jobs.encode_palettes(jp)
        np.testing.assert_array_equal(
            obs_mod.rel_offsets(p.view_size, p.view_offset),
            jobs.rel_offsets(jp.view_size, jp.view_offset))


def test_constants_match():
    for name in ("CAN_OVERLAP_BASE", "CAN_PICKUP", "SEE_BEHIND_BASE",
                 "DIR_VEC", "COLORS", "PRESTIGE_DIM"):
        np.testing.assert_array_equal(getattr(C, name), getattr(JC, name))
    for name in ("TYPE_NAMES", "COLOR_NAMES", "ACTION_NAMES", "N_TYPES",
                 "N_COLORS", "N_ACTIONS", "BOX_PACK", "AGENT"):
        assert getattr(C, name) == getattr(JC, name)
    codes = torch.arange(C.N_TYPES)
    for st in (0, 1, 2):
        assert C.can_overlap(codes, st).tolist() == \
            np.asarray(JC.can_overlap(jnp.arange(C.N_TYPES), st)).tolist()


@pytest.mark.parametrize("shape", [(8, 147), (256, 196), (37, 5)])
def test_transpose_plain_matches_jax(shape):
    """K1's plain version against the JAX ``transpose_bk`` (on the CPU, its
    own reference ``x.T``: the Pallas kernel has no interpret mode)."""
    x = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31 - 1, shape,
                                          dtype=np.int64).astype(np.int32)
    got = T.transpose_bk(torch.as_tensor(x))
    assert got.is_contiguous() and T.transpose_bk.launches == 0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.transpose_bk(
                                      jnp.asarray(x))))
