"""The port's tensor-parallel feedforward step
(``ppo.make_train_step(mesh=...)`` with a
``tensor_parallel.TensorParallelActorCritic`` on each rank) on two gloo
ranks laid out (1, 2), against the JAX package's tensor-parallel step, on
the CPU: ``make_train_step(mesh=make_mesh(n_data=1, n_model=2, ...))`` on
two virtual CPU devices, its parameters placed under
``__graft_entry__.py::dryrun_multichip``'s rule (2-D kernels of the torso
``P(None, "model")``, of ``pi`` and ``v`` ``P("model", None)``, the rest
and the optimizer state replicated).

Both start from the same weights (the flax ones; each port rank loads its
shard through ``load_flax_params_shard``, then
``tensor_parallel.broadcast_state`` runs as the ranks would start) and
keys, float32, in
``test_torch_gspmd.py``'s ``resets`` case (empty 9x9, max_steps 10 with
the stagger, B = 32, T = 8, hidden 128, 2 epochs x 2 minibatches).

After one step the env state gathered from the ranks and the key are
bit-equal to JAX's; the first minibatch's gradients, the metrics and the
weights, the ranks' shards put together, are within ``test_torch_ppo.py``'s
bounds (rtol 1e-4 / 1e-5). In float32 the model axis's partial sums move
no value past those bounds, so no witness is needed here (the bf16 card
runs hold one: ``chip_smoke.py``). Each rank's embed runs on its H / 2 =
64 columns, and the ranks hold the same replicated entries, bit for bit.
Then the port's (1, 2) step after two steps against its own unsharded
step (no process group): env state and key bit-equal, weights within
rtol 2e-4, atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel.mesh import make_mesh as jmake_mesh
from marlgrid_tpu_torch.models import MODEL_SPLIT
from test_torch_gspmd import (CASES, check_d2_against_d1_with_resets,
                              make_case, port_d1, port_run)
from test_torch_ppo import _record_first_grad
from test_torch_shard_map import _np, check_against_jax
import torch_dist_worker

CASE = CASES["resets"]


def rule(mesh):
    """``__graft_entry__.py::dryrun_multichip``'s placement of a param."""
    def place(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if x.ndim == 2 and "torso" in name:
            return NamedSharding(mesh, P(None, "model"))
        if x.ndim == 2 and ("pi" in name or "v/" in name):
            return NamedSharding(mesh, P("model", None))
        return NamedSharding(mesh, P())

    return place


def jax_tp_step(c, devices):
    """One JAX tensor-parallel step of case ``c`` on a (1, 2) mesh, with
    the first minibatch's clipped gradient kept by an optax stage."""
    jcfg, jep = c["jcfg"], c["jep"]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    mesh = jmake_mesh(n_data=1, n_model=2, devices=devices[:2])
    place = rule(mesh)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(jnp.asarray(x), place(p, x)),
        c["params0"])
    opt0 = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P()))
        if hasattr(x, "shape") else x,
        tx.init(jax.tree.map(jnp.asarray, c["params0"])))
    env0 = jppo.init_env_batch(jep, jcfg.n_envs, c["k_env"], mesh,
                               stagger=c["stagger"])
    step = jppo.make_train_step(jep, jcfg, c["net"], tx, mesh=mesh)
    p1, o1, env1, key1, m = _np(step(params, opt0, env0, c["k_step"]))
    return dict(params1=p1, grad0=o1[1]["g"], env1=env1, h1=None,
                key1=key1, metrics={k: float(v) for k, v in m.items()})


def assemble(parts):
    """The whole state_dict from the model ranks' ``parts`` (in model
    order): each split entry put back together along its dim, each
    replicated entry the same on every rank, bit for bit."""
    whole = {}
    for name, first in parts[0].items():
        if name in MODEL_SPLIT:
            whole[name] = torch.cat([p[name] for p in parts],
                                    MODEL_SPLIT[name])
        else:
            for p in parts[1:]:
                assert torch.equal(p[name], first), name
            whole[name] = first
    return whole


def put_together(ranks):
    """One rank-like record of a (1, n) run: its snapshots' weights and
    its first gradients assembled over the model ranks; the metrics, env
    state and key, which every rank holds, checked equal."""
    snaps = []
    for per_rank in zip(*(r["snaps"] for r in ranks)):
        for s in per_rank[1:]:
            assert s["metrics"] == per_rank[0]["metrics"]
            assert torch.equal(s["key"], per_rank[0]["key"])
            for f, v in s["env"].items():
                np.testing.assert_array_equal(v, per_rank[0]["env"][f])
        snaps.append(dict(per_rank[0], weights=assemble(
            [s["weights"] for s in per_rank])))
    return dict(snaps=snaps, grad0=assemble([r["grad0"] for r in ranks]))


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    """The port's (1, 2) run of the case for one step and for two (one
    pair of processes, started first), JAX's step while they run, and the
    port's unsharded run."""
    c = make_case(*CASE[:3])
    tp = dict(flax=c["params0"], n_model=2)
    runs = [dict(port_run(c, steps=1), **tp), dict(port_run(c), **tp)]
    for run in runs:
        del run["state_dict"]
    with torch_dist_worker.start(tmp_path_factory.mktemp("tp"), "train",
                                 dict(runs=runs)) as wait:
        j = jax_tp_step(c, devices8)
        d1 = port_d1(c)
        ranks = wait()
    return dict(jax=j, d1=d1, one=[r[0] for r in ranks],
                two=[r[1] for r in ranks])


def test_tp_step_matches_jax(results):
    whole = put_together(results["one"])
    check_against_jax(results["jax"], [whole, whole])
    assert results["jax"]["metrics"]["n_episodes"] > 0


def test_tp_ranks_hold_column_shards(results):
    """Each rank's tables and split weights are its half; the embed (K2f
    and K2b on the card) ran on H / 2 columns."""
    H = 128
    for r, rank in enumerate(results["one"]):
        assert rank["model_index"] == r
        w = rank["snaps"][0]["weights"]
        for name, dim in MODEL_SPLIT.items():
            assert w[name].shape[dim] == H // 2, name
            assert w[name].is_contiguous()
        assert rank["grad0"]["torso0.w0"].shape[1] == H // 2
        assert w["torso0.bias"].shape == (H,)


def test_tp_collectives_per_axis(results):
    """A step's collectives: on 'data' (D = 1) those of the mesh= step,
    one all_gather and 3 a minibatch + 1 all_reduces; on 'model' one
    all_gather and one all_reduce a forward (T + 1 in the rollout, one a
    minibatch), and per minibatch the gather's backward and the gradient
    sync."""
    _, cfg_kw, _, _ = CASE
    T = cfg_kw["rollout_len"]
    calls = cfg_kw["n_epochs"] * cfg_kw["n_minibatches"]
    for r in results["one"]:
        assert r["all_gathers"] == 1
        assert r["all_reduces"] == 3 * calls + 1
        assert r["model_all_gathers"] == T + 1 + calls
        assert r["model_all_reduces"] == T + 1 + 3 * calls


def test_tp_matches_the_unsharded_step_with_resets(results):
    whole = put_together(results["two"])
    check_d2_against_d1_with_resets([whole, whole], results["d1"])


def _flax_tree(H, conv=False):
    """A flax-shaped numpy tree of the feedforward policy (the mlp torso,
    or the 'cnn' torso's convs), H wide, random values."""
    rs = np.random.default_rng(0)

    def dense(i, o):
        return dict(kernel=rs.normal(size=(i, o)).astype(np.float32),
                    bias=rs.normal(size=(o,)).astype(np.float32))

    p = dict(torso=dense(H, H), pi=dense(H, 7), v=dense(H, 1))
    if conv:
        p["Conv_0"] = dict(
            kernel=rs.normal(size=(3, 3, 42, 8)).astype(np.float32),
            bias=np.zeros(8, np.float32))
    else:
        p["torso0"] = {f"w{i}": rs.normal(size=(49 * n, H)).astype(
            np.float32) for i, n in enumerate((12, 10, 20))}
        p["torso0"]["bias"] = rs.normal(size=(H,)).astype(np.float32)
    return {"params": p}


def test_load_flax_params_shard():
    """Each rank's shard is its part of each split entry along the split's
    dim, a contiguous tensor of its own; the rest whole. A tree the rule
    does not fit (the 'cnn' torso's) or a width the ranks do not divide is
    refused."""
    from marlgrid_tpu_torch.models import (load_flax_params,
                                           load_flax_params_shard)

    tree = _flax_tree(8)
    whole = load_flax_params(tree)
    for m in range(2):
        part = load_flax_params_shard(tree, m, 2)
        assert set(part) == set(whole)
        for k, v in part.items():
            assert v.is_contiguous()
            want = (whole[k].narrow(MODEL_SPLIT[k], 4 * m, 4)
                    if k in MODEL_SPLIT else whole[k])
            assert torch.equal(v, want), k
            assert v.data_ptr() != whole[k].data_ptr()
    with pytest.raises(ValueError, match="does not split into 3"):
        load_flax_params_shard(tree, 0, 3)
    with pytest.raises(ValueError, match="lack"):
        load_flax_params_shard(_flax_tree(8, conv=True), 0, 2)
