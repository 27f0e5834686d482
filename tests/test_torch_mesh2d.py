"""The port's ('data', 'model') mesh (``parallel/mesh.py``) on four gloo
ranks laid out 2 x 2, as JAX's ``make_mesh(n_data=2, n_model=2)`` lays out
its devices (``reshape(n_data, n_model)``: rank i at data index i // 2 and
model index i % 2), on the CPU.

The data axis's collectives (``psum``, ``pmean``, ``all_gather``) run over
the ranks of one model index only, the model axis's (``model_psum``,
``model_all_gather``, the differentiable ``model_gather`` and
``model_sum``) over the ranks of one data index only; the env helpers
(``host_local_slice``, ``shard``, ``gather``, ``init_env_batch``) index by
the data coordinate, so both ranks of a model group hold the same env
slice, bit-equal to those rows of the whole batch.
"""
import numpy as np
import pytest
import torch

from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           default_agent_colors,
                                           state_to_numpy)
from marlgrid_tpu_torch.parallel import mesh as mesh_mod
from marlgrid_tpu_torch.parallel import ppo
import torch_dist_worker

EP = EnvParams(width=9, height=9, n_agents=2, view_size=5,
               scenario="cluttered", n_clutter=4, max_steps=20,
               observation_style="encode",
               agent_colors=default_agent_colors(2))
N_ENVS = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    key = rng.PRNGKey(3, device="cpu")
    out = torch_dist_worker.run(
        tmp_path_factory.mktemp("mesh2d"), "mesh2d",
        dict(n_model=2, ep=EP.to_dict(), n_envs=N_ENVS, key=key), world=4)
    whole = state_to_numpy(ppo.init_env_batch(EP, N_ENVS, key,
                                              device="cpu"))
    return out, whole


def test_coordinates_and_groups(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        assert (o["D"], o["n_model"], o["rank"]) == (2, 2, r)
        assert (o["data_index"], o["model_index"]) == divmod(r, 2)
        # a data group: one model index; a model group: one data index
        assert o["data_ranks"] == [r % 2, r % 2 + 2]
        assert o["model_ranks"] == [r - r % 2, r - r % 2 + 1]


def test_data_collectives_over_the_data_group(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        m = r % 2                               # the data group's ranks
        assert o["psum"].item() == (m + 1) + (m + 3)
        assert o["pmean"].item() == ((m + 1) + (m + 3)) / 2
        assert o["all_gathered"].tolist() == [m, 10 * m, m + 2,
                                              10 * (m + 2)]
        # the rank at data index 0 of the group, and rank 0 of the world
        assert o["broadcast"].tolist() == [float(m)] * 3
        assert o["broadcast_world"].tolist() == [0.0, 0.0]


def test_model_collectives_over_the_model_group(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        lo = r - r % 2                          # the model group's ranks
        assert o["model_psum"].item() == (lo + 1) + (lo + 2)
        assert o["model_all_gathered"].tolist() == [
            [lo, 10 * lo, lo + 1, 10 * (lo + 1)]]
        assert o["gathered_y"].tolist() == [
            [1.0 + lo, 2.0 * lo, 2.0 + lo, 2.0 * (lo + 1)]]
        # backward of the gather: this rank's columns of the gradient
        # summed over the group, sum over r' of (r' + 1) * (1, 2, 3, 4)
        weights = sum(q + 1 for q in (lo, lo + 1))
        cols = [1.0, 2.0] if r % 2 == 0 else [3.0, 4.0]
        assert o["y_grad"].tolist() == [[weights * c for c in cols]]
        # the sum, and its backward: the identity
        assert o["summed_z"].tolist() == [3.0 * (lo + 1) + 3.0 * (lo + 2)]
        assert o["z_grad"].tolist() == [float(r + 2)]


def test_each_axis_counts_its_own_calls(ranks):
    out, _ = ranks
    for o in out:
        # data: psum and pmean; the all_gather and the gather of `rows`.
        # model: the gather's backward, model_sum and model_psum; the
        # gather's forward and model_all_gather
        assert o["counts"] == (2, 2, 3, 2)


def test_env_by_data_coordinate(ranks):
    out, whole = ranks
    for r, o in enumerate(out):
        d = r // 2
        assert o["slice"] == slice(4 * d, 4 * d + 4)
        np.testing.assert_array_equal(
            o["gathered"], np.arange(12).reshape(2, 6))
        for f in FIELDS:
            np.testing.assert_array_equal(
                o["env"][f], whole[f][4 * d:4 * d + 4], err_msg=f)
    # the replicas on the model axis hold identical env slices
    for a, b in ((0, 1), (2, 3)):
        for f in FIELDS:
            np.testing.assert_array_equal(out[a]["env"][f], out[b]["env"][f])


def test_mesh_without_a_group_is_one_by_one():
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.D, mesh.n_model, mesh.data_index, mesh.model_index) == \
        (1, 1, 0, 0)
    x = torch.randn(3, requires_grad=True)
    assert mesh_mod.model_gather(mesh, x) is x
    assert mesh_mod.model_sum(mesh, x)[0] is x
    assert mesh.model_psum([x])[0] is x
    assert mesh.model_all_gather(x) is x
    assert mesh.model_all_reduces == mesh.model_all_gathers == 0
    with pytest.raises(AssertionError, match=r"^1x2 mesh != 1 devices$"):
        mesh_mod.make_mesh(n_data=1, n_model=2, device="cpu")
