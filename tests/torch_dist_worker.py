"""One rank of the port's multi-process CPU tests (gloo), importing torch and
the port only, never JAX:

    python tests/torch_dist_worker.py JOB RANK WORLD STORE INPUT OUTPUT

Joins a gloo group of WORLD ranks through the ``file://`` store STORE, runs
JOB on the arguments ``torch.load(INPUT)`` holds, and ``torch.save``s what
it returns to OUTPUT (every rank writes its own file).

- ``mesh``: ``parallel/mesh.py`` on the group: the mesh's D and rank,
  ``host_local_slice``, ``psum``/``pmean`` of rank-seeded float32 data,
  ``broadcast_from`` rank 0, ``gather`` of ``shard``, ``Mesh.all_gather`` of
  :func:`gather_parts` (four dtypes, three env axes), and the rank's slice of
  ``ppo.init_env_batch``.
- ``mesh2d``: the ('data', 'model') mesh of ``n_model`` over the group:
  each rank's coordinates, ``psum``/``pmean``/``all_gather`` (data axis)
  and ``model_psum``/``model_all_gather`` (model axis) of rank-valued
  data, the differentiable ``model_gather``/``model_sum`` and the
  gradients they give back, ``host_local_slice``, ``shard``/``gather``,
  ``broadcast_from`` over the data group and over the world, the counts
  of each axis's calls, and the rank's slice of ``ppo.init_env_batch``.
- ``graft``: ``__graft_entry_torch__.dryrun_multichip`` over the group's
  ranks on the CPU: each family's loss.
- ``train``: for each run of ``runs``, a feedforward or recurrent run from
  the weights and keys given (rank 0's, through ``broadcast_from`` over
  the whole group: the other ranks start from other weights), on the
  run's mesh (``n_model``, default 1) and ``path``:
  ``"shard_map"`` (``ppo.make_train_step_shard_map``,
  ``ppo_rnn.make_train_step_rnn_shard_map``), or ``"mesh"``, the sharded
  default path (``ppo.make_train_step(mesh=...)``, with ``overlap`` too,
  and ``ppo_rnn.make_train_step_rnn(mesh=...)``). A run whose params hold
  per-agent observation configs takes the hetero family the train CLI
  picks for it (``train.init``, ``train.make_step``: ``ppo_hetero``,
  ``ppo_hetero_rnn`` or ``ppo_hetero_mixed``, ``mesh=``), its weights a
  ModuleList's state_dict. A run with ``flax`` (the flax params as numpy
  arrays) in place of ``state_dict`` is tensor-parallel: each rank holds a
  ``tensor_parallel.TensorParallelActorCritic``, the ranks at data index
  0 load their shards (``models.load_flax_params_shard``) and
  ``tensor_parallel.broadcast_state`` starts the others. It returns the
  first minibatch's gradients as
  the optimizer sees them (after the all-reduce and the clip), the sample
  count of every loss call (the logits' leading shape; on the hetero
  families a tuple, one count a group), the collectives the steps called
  on each axis, and a snapshot after every step: the weights (a
  tensor-parallel rank's shards), the env state and carry gathered in
  global env order, the key and the metrics.
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from marlgrid_tpu_torch.core.state import EnvParams, FIELDS, state_to_numpy
from marlgrid_tpu_torch.models import load_flax_params_shard
from marlgrid_tpu_torch.parallel import mesh as mesh_mod
from marlgrid_tpu_torch.parallel import (ppo, ppo_hetero, ppo_hetero_mixed,
                                         ppo_hetero_rnn, ppo_rnn,
                                         tensor_parallel)
from marlgrid_tpu_torch.parallel import train as train_mod


def gather_parts(rank):
    """Rank ``rank``'s tensors for ``Mesh.all_gather`` and their env axes:
    int64 on axis 1, bool on 0, uint8 on 2, float32 on 0 (byte sizes off
    the 8-byte grid)."""
    return ([torch.arange(6, dtype=torch.int64).reshape(2, 3) + 100 * rank,
             torch.tensor([True, rank == 1, False]),
             torch.full((1, 2, 5), rank + 1, dtype=torch.uint8),
             torch.tensor([0.5 + rank, -rank], dtype=torch.float32)],
            [1, 0, 2, 0])


def job_mesh(args):
    mesh = mesh_mod.make_mesh(device="cpu")
    data = torch.as_tensor(np.random.default_rng(mesh.rank).normal(
        size=(3, 5)).astype(np.float32))
    count = torch.tensor([mesh.rank + 1], dtype=torch.int32)
    summed = mesh.psum([data, count])
    mean, = mesh.pmean([data])
    mine = torch.full((4,), float(mesh.rank))
    mesh_mod.broadcast_from(mesh, [mine])
    rows = torch.arange(2 * mesh.D * 3).reshape(2, mesh.D * 3)
    ep = EnvParams.from_dict(args["ep"])
    state = ppo.init_env_batch(ep, args["n_envs"], args["key"],
                               stagger=True, device="cpu", mesh=mesh)
    return dict(D=mesh.D, rank=mesh.rank, all_reduces=mesh.all_reduces,
                slice=mesh_mod.host_local_slice(mesh, 10), data=data,
                psum=summed[0], psum_count=summed[1], pmean=mean,
                broadcast=mine,
                gathered=mesh_mod.gather(mesh, mesh_mod.shard(mesh, rows, 1),
                                         1),
                all_gathered=mesh.all_gather(*gather_parts(mesh.rank)),
                all_gathers=mesh.all_gathers,
                env=state_to_numpy(state))


def job_mesh2d(args):
    mesh = mesh_mod.make_mesh(n_model=args["n_model"], device="cpu")
    r = mesh.rank
    x = torch.tensor([float(r + 1)])
    y = torch.tensor([[1.0 + r, 2.0 * r]], requires_grad=True)
    gathered_y = mesh_mod.model_gather(mesh, y)
    (gathered_y * (r + 1) * torch.arange(
        1.0, gathered_y.numel() + 1)).sum().backward()
    z = torch.tensor([3.0 * (r + 1)], requires_grad=True)
    summed_z, = mesh_mod.model_sum(mesh, z)
    (summed_z * (r + 2)).sum().backward()
    mine, everywhere = torch.full((3,), float(r)), torch.full((2,), float(r))
    mesh_mod.broadcast_from(mesh, [mine])
    mesh_mod.broadcast_from(mesh, [everywhere], world=True)
    rows = torch.arange(2 * mesh.D * 3).reshape(2, mesh.D * 3)
    ep = EnvParams.from_dict(args["ep"])
    state = ppo.init_env_batch(ep, args["n_envs"], args["key"],
                               stagger=True, device="cpu", mesh=mesh)
    return dict(
        D=mesh.D, n_model=mesh.n_model, rank=r, data_index=mesh.data_index,
        model_index=mesh.model_index,
        data_ranks=sorted(torch.distributed.get_process_group_ranks(
            mesh.group)),
        model_ranks=sorted(torch.distributed.get_process_group_ranks(
            mesh.model_group)),
        psum=mesh.psum([x])[0], pmean=mesh.pmean([x])[0],
        all_gathered=mesh.all_gather([torch.tensor([r, 10 * r])], [0])[0],
        model_psum=mesh.model_psum([x])[0],
        model_all_gathered=mesh.model_all_gather(
            torch.tensor([[r, 10 * r]]), -1),
        gathered_y=gathered_y.detach(), y_grad=y.grad,
        summed_z=summed_z.detach(), z_grad=z.grad,
        broadcast=mine, broadcast_world=everywhere,
        slice=mesh_mod.host_local_slice(mesh, 8),
        gathered=mesh_mod.gather(mesh, mesh_mod.shard(mesh, rows, 1), 1),
        counts=(mesh.all_reduces, mesh.all_gathers, mesh.model_all_reduces,
                mesh.model_all_gathers),
        env=state_to_numpy(state))


def job_graft(args):
    import __graft_entry_torch__

    return __graft_entry_torch__.dryrun_multichip(
        torch.distributed.get_world_size(), device="cpu")


def job_train(args):
    return [train_run(run) for run in args["runs"]]


def count_loss_samples(seen):
    """Wrap ``ppo_loss`` where both trainers call it, appending the sample
    count of each call's logits to ``seen``."""
    loss = getattr(ppo.ppo_loss, "original", ppo.ppo_loss)

    def counted(logits, *a, **k):
        seen.append(logits.shape[:-1].numel())
        return loss(logits, *a, **k)

    counted.original = loss
    ppo.ppo_loss = ppo_rnn.ppo_loss = counted


def count_group_loss_samples(seen):
    """Wrap ``group_loss`` where the three hetero trainers call it,
    appending each call's per-group sample counts to ``seen``."""
    loss = getattr(ppo_hetero.group_loss, "original", ppo_hetero.group_loss)

    def counted(parts, *a, **k):
        seen.append(tuple(p[0].shape[:-1].numel() for p in parts))
        return loss(parts, *a, **k)

    counted.original = loss
    ppo_hetero.group_loss = ppo_hetero_rnn.group_loss = counted
    ppo_hetero_mixed.group_loss = counted


def train_run(args):
    mesh = mesh_mod.make_mesh(n_model=args.get("n_model", 1), device="cpu")
    ep = EnvParams.from_dict(args["ep"])
    cfg = ppo.PPOConfig(**{**ppo.ppo_config_from_dict(args["cfg"]).__dict__,
                           "dtype": args.get("dtype", torch.float32)})
    gen = torch.Generator().manual_seed(mesh.rank + 1)
    on_mesh = args.get("path", "shard_map") == "mesh"
    prev = None
    hdim = 1
    if ep.has_hetero_obs:
        dev = torch.device("cpu")
        net, opt, h = train_mod.init(ep, cfg, gen, dev)
        h = train_mod.local_carry(mesh, h, hdim)
        step = train_mod.make_step(ep, cfg, net, opt, dev, mesh=mesh)
    elif cfg.rnn:
        net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, gen, device="cpu")
        hdim = ppo_rnn.carry_env_dim(ep, cfg)
        h = ppo_rnn.map_carry(lambda x: mesh_mod.shard(mesh, x, hdim), h)
        if on_mesh:
            step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt,
                                               device="cpu", mesh=mesh)
        else:
            step = ppo_rnn.make_train_step_rnn_shard_map(ep, cfg, net, opt,
                                                         mesh, device="cpu")
    else:
        if "flax" in args:
            net = tensor_parallel.TensorParallelActorCritic(
                cfg, ep.view_size, mesh, gen, device="cpu")
            opt = ppo.make_optimizer(net, cfg)
        else:
            net, opt = ppo.init_state(ep, cfg, gen, device="cpu")
        h = None
        if args.get("overlap"):
            step, prime = ppo.make_train_step(ep, cfg, net, opt, device="cpu",
                                              overlap=True, mesh=mesh)
        elif on_mesh:
            step = ppo.make_train_step(ep, cfg, net, opt, device="cpu",
                                       mesh=mesh)
        else:
            step = ppo.make_train_step_shard_map(ep, cfg, net, opt, mesh,
                                                 device="cpu")
    seen = []
    count_loss_samples(seen)
    count_group_loss_samples(seen)
    if "flax" in args:
        if mesh.data_index == 0:
            net.load_state_dict(load_flax_params_shard(
                args["flax"], mesh.model_index, mesh.n_model))
        tensor_parallel.broadcast_state(mesh, net)
    else:
        if mesh.rank == 0:
            net.load_state_dict(args["state_dict"])
        mesh_mod.broadcast_from(mesh, list(net.state_dict().values()),
                                world=True)
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in net.named_parameters()})
        if not grads else None)
    env = ppo.init_env_batch(ep, cfg.n_envs, args["env_key"],
                             stagger=args["stagger"], device="cpu", mesh=mesh)
    key = args["key"]
    if args.get("overlap"):
        env, prev, key = prime(env, key)
    snaps, gathers = [], 0
    for _ in range(args["steps"]):
        before = mesh.all_gathers
        if h is not None:
            env, h, key, m = step(env, h, key)
        elif prev is not None:
            env, prev, key, m = step(env, prev, key)
        else:
            env, key, m = step(env, key)
        gathers += mesh.all_gathers - before
        snaps.append(dict(
            weights={k: v.clone() for k, v in net.state_dict().items()},
            env={f: mesh_mod.gather(mesh, getattr(env, f)).numpy()
                 for f in FIELDS},
            h=None if h is None else train_mod._carry_map(
                lambda x: mesh_mod.gather(mesh, x, hdim), h),
            key=key.clone(), metrics={k: float(v) for k, v in m.items()}))
    return dict(snaps=snaps, grad0=grads[0], all_reduces=mesh.all_reduces,
                all_gathers=gathers, loss_samples=seen,
                model_all_reduces=mesh.model_all_reduces,
                model_all_gathers=mesh.model_all_gathers,
                model_index=mesh.model_index)


JOBS = dict(mesh=job_mesh, mesh2d=job_mesh2d, graft=job_graft,
            train=job_train)


def main(argv):
    job, rank, world, store, inp, out = argv
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=int(world), rank=int(rank))
    try:
        torch.save(JOBS[job](torch.load(inp, weights_only=False)), out)
    finally:
        dist.destroy_process_group()


def run(tmp_path, job, args, world=2, timeout=240):
    """Run ``world`` ranks of JOB on ``args`` (from the calling test) and
    return each rank's result, in rank order; fails with a rank's output if
    it exits non-zero."""
    with start(tmp_path, job, args, world) as wait:
        return wait(timeout)


def spawn(cmds, cwd, env):
    """One process per command line of ``cmds``, its stdout and stderr on
    one pipe; the caller :func:`reap`s them."""
    import subprocess

    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(
                cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    except BaseException:
        stop(procs)
        raise
    return procs


def reap(procs, timeout):
    """Each process's output, in order, once it has exited (at most
    ``timeout`` seconds a process); on the way out, whether the wait ended,
    timed out or was interrupted, every process still running is killed,
    and every one is reaped."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        stop(procs)


def stop(procs):
    """Kill each process of ``procs`` that is still running, wait for it
    and close its pipe."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
        if p.stdout is not None:
            p.stdout.close()


class Ranks:
    """Ranks of a job started by :func:`start`: call it (``timeout``
    seconds a rank) for their results, in rank order. As a context manager
    it kills and reaps every rank still running when the block ends,
    whether or not the block raised before the call; a rank that outlives
    its caller otherwise is killed when the interpreter exits."""

    def __init__(self, procs, outs, job):
        import atexit

        self.procs, self.outs, self.job = procs, outs, job
        atexit.register(stop, procs)

    def __call__(self, timeout=240):
        logs = reap(self.procs, timeout)
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, \
                f"rank {r} of {self.job} failed:\n{log[-4000:]}"
        return [torch.load(o, weights_only=False) for o in self.outs]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        stop(self.procs)


def start(tmp_path, job, args, world=2) -> Ranks:
    """Start ``world`` ranks of JOB on ``args`` and return their
    :class:`Ranks`, which the caller waits on after working while they
    run: ``with start(...) as wait: ...; results = wait()``."""
    import os
    import tempfile
    from pathlib import Path

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = Path(tempfile.mkdtemp(prefix=f"{job}-", dir=tmp_path))
    inp, store = d / "in.pt", d / "store"
    torch.save(args, inp)
    outs = [d / f"rank{r}.pt" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = spawn([[sys.executable, os.path.abspath(__file__), job, str(r),
                    str(world), str(store), str(inp), str(outs[r])]
                   for r in range(world)], root, env)
    return Ranks(procs, outs, job)


if __name__ == "__main__":
    main(sys.argv[1:])
