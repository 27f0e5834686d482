"""The port's entry points (``__graft_entry_torch__.py``) against
the JAX package's (``__graft_entry__.py``), on the CPU.

``entry(device="cpu")``, its parameters replaced by the flax weights of
JAX's ``entry()`` (``load_flax_params``), gives JAX's logits and values on
``entry()``'s zeros and on random valid codes, within the bf16 forward's
bound of ``test_torch_embed.py`` (rtol = atol = 1e-2: the embed, the torso
and the heads each round to bf16, and torch and XLA may round a sum at
different places). ``dryrun_multichip(4)`` on four gloo ranks (a (2, 2)
mesh: the feedforward family tensor-parallel) gives seven finite losses,
the same on every rank.
"""
import math
import sys

import jax
import numpy as np
import pytest
import torch

from marlgrid_tpu_torch.models import load_flax_params
import torch_dist_worker

sys.path.insert(0, ".")


def _codes(shape, seed):
    """(..., 3) int32 codes in the full vocabularies: types 0..11, colors
    0..9, states 0..24 (the embed clips states at 19)."""
    rs = np.random.default_rng(seed)
    return np.stack([rs.integers(0, hi, shape) for hi in (12, 10, 25)],
                    -1).astype(np.int32)


@pytest.fixture(scope="module")
def both():
    import __graft_entry__ as jg
    import __graft_entry_torch__ as tg

    jfn, (jparams, jobs) = jg.entry()
    tfn, (tparams, tobs) = tg.entry(device="cpu")
    return jax.jit(jfn), jparams, jobs, tfn, tparams, tobs


def test_entry_shapes(both):
    _, _, jobs, tfn, tparams, tobs = both
    assert tuple(tobs.shape) == tuple(jobs.shape) == (32, 4, 7, 7, 3)
    assert tobs.dtype == torch.int32 and not tobs.any()
    logits, value = tfn(tparams, tobs)
    assert logits.shape == (32, 4, 7) and value.shape == (32, 4)
    assert logits.dtype == value.dtype == torch.float32


@pytest.mark.parametrize("obs", ["zeros", "codes"])
def test_entry_matches_jax(both, obs):
    jfn, jparams, jobs, tfn, tparams, tobs = both
    x = (np.zeros(jobs.shape, np.int32) if obs == "zeros"
         else _codes(jobs.shape[:-1], 5))
    jl, jv = jfn(jparams, x)
    params = {k: v for k, v in load_flax_params(
        jax.tree.map(np.asarray, jparams)).items()}
    assert set(params) == set(tparams)
    with torch.no_grad():
        tl, tv = tfn(params, torch.as_tensor(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-2,
                               atol=1e-2)
    # the port's own weights give other logits: the load took
    assert not torch.allclose(tfn(tparams, torch.as_tensor(x))[0], tl)


def test_dryrun_multichip_four_ranks(tmp_path):
    ranks = torch_dist_worker.run(tmp_path, "graft", {}, world=4)
    assert list(ranks[0]) == ["feedforward", "gru", "hetero",
                              "gru_bptt_shard_map", "gru_image",
                              "hetero_gru", "mixed"]
    for r in ranks:
        assert r == ranks[0]
        assert all(math.isfinite(v) for v in r.values())


def test_dryrun_needs_its_process_group():
    import __graft_entry_torch__ as tg

    with pytest.raises(ValueError, match="world size 2, not none"):
        tg.dryrun_multichip(2, device="cpu")
