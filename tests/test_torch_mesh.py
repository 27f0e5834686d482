"""The port's data axis (``marlgrid_tpu_torch/parallel/mesh.py``) on the CPU.

Two gloo ranks (``tests/torch_dist_worker.py``, which imports no JAX):
``make_mesh``, ``host_local_slice``, ``psum``/``pmean`` (numpy's sum and
sum / D), ``broadcast_from``, ``gather`` of ``shard``, ``Mesh.all_gather``
(one call for tensors of four dtypes on three env axes), and each rank's
slice of ``ppo.init_env_batch`` bit-equal to the rows of the whole batch,
the stagger included. In one process: the identity collectives at D = 1
and the JAX package's assert text. And the batched-key ``categorical``
bit-equal to JAX's vmapped one in both logits layouts.
"""
from types import SimpleNamespace

import jax
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

EP = EnvParams(width=9, height=9, n_agents=2, scenario="cluttered",
               n_clutter=6, max_steps=40, view_size=5,
               observation_style="encode",
               agent_colors=default_agent_colors(2))
N_ENVS = 10


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    key = rng.PRNGKey(7, device="cpu")
    return torch_dist_worker.run(
        tmp_path_factory.mktemp("mesh"), "mesh",
        dict(ep=EP.to_dict(), n_envs=N_ENVS, key=key))


def test_mesh_and_collectives_on_two_ranks(ranks):
    datas = [r["data"].numpy() for r in ranks]
    for rank, r in enumerate(ranks):
        assert (r["D"], r["rank"]) == (2, rank)
        assert r["slice"] == slice(5 * rank, 5 * rank + 5)
        np.testing.assert_array_equal(r["psum"].numpy(), datas[0] + datas[1])
        assert r["psum"].dtype == torch.float32
        np.testing.assert_array_equal(r["psum_count"].numpy(), [3])
        assert r["psum_count"].dtype == torch.int32
        np.testing.assert_array_equal(
            r["pmean"].numpy(), (datas[0] + datas[1]) / np.float32(2))
        # one all_reduce per psum / pmean call, whatever it holds
        assert r["all_reduces"] == 2
        np.testing.assert_array_equal(r["broadcast"].numpy(), np.zeros(4))
        np.testing.assert_array_equal(r["gathered"].numpy(),
                                      np.arange(12).reshape(2, 6))
        parts, dims = zip(*[torch_dist_worker.gather_parts(q)
                            for q in range(2)])
        # one all_gather call each: gather's and all_gather's
        assert r["all_gathers"] == 2
        for i, got in enumerate(r["all_gathered"]):
            want = np.concatenate([p[i].numpy() for p in parts], dims[0][i])
            assert got.dtype == parts[0][i].dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_init_env_batch_slices_are_rows_of_the_whole_batch(ranks):
    key = rng.PRNGKey(7, device="cpu")
    whole = state_to_numpy(ppo.init_env_batch(EP, N_ENVS, key, stagger=True,
                                              device="cpu"))
    assert len(set(whole["step_count"].tolist())) > 1
    for rank, r in enumerate(ranks):
        for f in FIELDS:
            np.testing.assert_array_equal(
                r["env"][f], whole[f][5 * rank:5 * rank + 5], err_msg=f)


def test_identity_collectives_without_a_group():
    """No process group: D = 1, rank 0, and every collective gives back
    what it was given, as a psum over an axis of size 1 does."""
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.D, mesh.rank, mesh.n_model, mesh.group) == (1, 0, 1, None)
    x, y = torch.randn(3), torch.arange(4)
    assert all(a is b for a, b in zip(mesh.psum([x, y]), (x, y)))
    assert all(a is b for a, b in zip(mesh.pmean([x, y]), (x, y)))
    before = x.clone()
    mesh_mod.broadcast_from(mesh, [x])
    assert torch.equal(x, before)
    assert mesh_mod.gather(mesh, x) is x
    assert mesh_mod.host_local_slice(mesh, 8) == slice(0, 8)
    assert torch.equal(mesh_mod.shard(mesh, y), y)
    assert all(a is b for a, b in zip(mesh.all_gather([x, y], [0, 0]),
                                      (x, y)))
    assert mesh.all_reduces == mesh.all_gathers == 0


def test_make_mesh_refusals():
    with pytest.raises(AssertionError, match=r"^2x1 mesh != 1 devices$"):
        mesh_mod.make_mesh(n_data=2, device="cpu")
    # a 'model' axis of 2 needs two ranks: JAX's assertion and message
    with pytest.raises(AssertionError, match=r"^0x2 mesh != 1 devices$"):
        mesh_mod.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        mesh_mod.Mesh(2, 0, None, torch.device("cpu"))


@pytest.mark.parametrize("layout", ["feature_major", "rows"])
def test_categorical_per_key_matches_jax_vmap(layout):
    """The shard_map rollout's draw: env b samples from ``fold_in(ak,
    r * B + b)``, r the rank's data index; bit-equal to JAX's vmapped ``categorical`` over the
    (N, B, A) logits (``in_axes=(0, 1), out_axes=1``) and the (B, N, A)
    ones."""
    N, B, A, rank = 3, 16, 7, 1
    rs = np.random.default_rng(4)
    ak = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    env_ids = rank * B + np.arange(B)
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(ak, env_ids)
    tak = torch.as_tensor(np.asarray(ak).astype(np.int64))
    tkeys = rng.fold_in(tak, torch.as_tensor(env_ids))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    if layout == "feature_major":
        logits = rs.normal(size=(N, B, A)).astype(np.float32)
        want = jax.vmap(jax.random.categorical, in_axes=(0, 1),
                        out_axes=1)(jkeys, logits)
        key_axis = 1
    else:
        logits = rs.normal(size=(B, N, A)).astype(np.float32)
        want = jax.vmap(jax.random.categorical)(jkeys, logits)
        key_axis = 0
    got = rng.categorical_per_key(tkeys, torch.as_tensor(logits), key_axis)
    assert got.shape == logits.shape[:2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the rollout's own route to it
    got = ppo.sample_actions(tak, torch.as_tensor(logits),
                             SimpleNamespace(data_index=rank), B, key_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
