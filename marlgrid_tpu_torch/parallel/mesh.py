"""The 'data' axis over ranks of ``torch.distributed``.

Counterpart of ``marlgrid_tpu/parallel/mesh.py`` for the sharded train
steps. One rank is one process on one device; D, the size of the 'data'
axis, is the world size of the process group. Each rank holds its slice of
the env batch, and the ranks meet only at the collectives a step calls by
hand: :meth:`Mesh.pmean` and :meth:`Mesh.psum`, each one ``all_reduce``
over a flat bucket of its tensors (the explicit-collective ``shard_map``
steps, and the gradients of the default path), and :meth:`Mesh.all_gather`,
one in-place ``all_gather_into_tensor`` over a flat byte buffer (the default
path's trajectory, gathered in global env order for the update).

Without a process group the mesh has D = 1 and rank 0, and its collectives
return their inputs, as a ``psum`` over an axis of size 1 does: there is no
communication to run. With a group, even one of size 1, every collective
runs on it.

The backend follows the device (NCCL on ``cuda``, gloo on ``cpu``) unless
the caller names one; nothing swaps one backend for another. The 'model'
axis (``n_model > 1``) comes with ROADMAP Slice G2c.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve
from .graph import flatten, unflatten


class Mesh:
    """This rank's view of the ('data', 'model') mesh: ``D`` ranks on the
    data axis, this process's ``rank`` among them, ``n_model`` (1), the
    process ``group`` (None: no group, D = 1) and the ``device`` the rank
    computes on. ``all_reduces`` and ``all_gathers`` count the calls
    made, so a caller can count the collectives of a step."""

    def __init__(self, D: int, rank: int, group, device: torch.device,
                 n_model: int = 1):
        if group is None and D != 1:
            raise ValueError(f"a {D}-rank data axis needs a process group")
        self.D, self.rank, self.n_model = D, rank, n_model
        self.group, self.device = group, device
        self.all_reduces = 0
        self.all_gathers = 0

    def psum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data axis of each tensor: one ``all_reduce(SUM)``
        over the tensors' concatenation, split back to their shapes and
        dtypes (new tensors; without a group, the inputs themselves)."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        return _split(flat, tensors)

    def pmean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data axis, ``psum / D`` as JAX lowers ``pmean``
        (not ``ReduceOp.AVG``, so the division rounds as JAX's does)."""
        if self.group is None:
            return list(tensors)
        return [t / self.D for t in self.psum(tensors)]


    def all_gather(self, tensors: Sequence[torch.Tensor],
                   dims: Sequence[int]) -> List[torch.Tensor]:
        """Every rank's ``tensors[i]`` concatenated along ``dims[i]`` in
        rank order: this rank's slices of the env batch become the global
        batch, in global env order. One in-place
        ``all_gather_into_tensor`` over a flat uint8 buffer of D rows: the
        tensors' bytes are packed into this rank's row (each tensor at an
        8-byte-aligned offset), so the call is one node of a captured CUDA
        graph and its buffer is the capture's own. At D = 1 the results
        are views of that buffer (the store held once more); at D > 1 each
        is one copy into global order, and the buffer goes when the call
        returns. Without a group, the inputs themselves; with one, even of
        size 1, the collective runs (as :meth:`psum`'s)."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        sizes = [t.numel() * t.element_size() for t in tensors]
        starts, at = [], 0
        for n in sizes:
            starts.append(at)
            at += -(-n // 8) * 8
        out = torch.empty(self.D * at, dtype=torch.uint8,
                          device=tensors[0].device)
        rows = out.view(self.D, at)
        mine = rows[self.rank]
        for t, o, n in zip(tensors, starts, sizes):
            mine[o:o + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        dist.all_gather_into_tensor(out, mine, group=self.group)
        self.all_gathers += 1
        res = []
        for t, o, n, dim in zip(tensors, starts, sizes, dims):
            part = rows[:, o:o + n].view(t.dtype).reshape(
                (self.D,) + t.shape).movedim(0, dim)
            res.append(part.reshape(t.shape[:dim] + (-1,)
                                    + t.shape[dim + 1:]))
        return res


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None,
              device="cuda") -> Mesh:
    """The data axis over the ranks of ``group`` (default: the default
    process group, if one is initialized) for a rank computing on
    ``device``. With no process group: D = 1, rank 0 and identity
    collectives."""
    dev = resolve(device)
    if n_model != 1:
        raise NotImplementedError(
            f"a 'model' axis of {n_model}: not in the PyTorch port yet; it "
            f"comes with ROADMAP Slice G2c")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, \
        f"{n_data}x{n_model} mesh != {world} devices"
    rank = 0 if group is None else dist.get_rank(group)
    return Mesh(n_data, rank, group, dev, n_model)


def host_local_slice(mesh: Mesh, global_batch: int) -> slice:
    """This rank's slice of the global env batch."""
    per = global_batch // mesh.D
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's :func:`host_local_slice` of ``x`` along ``dim``."""
    sl = host_local_slice(mesh, x.shape[dim])
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    global batch from the ranks' slices, :meth:`Mesh.all_gather`); the
    inverse of :func:`shard`. A collective: every rank calls it."""
    return mesh.all_gather([x], [dim])[0]


def gather_env(mesh: Mesh, pairs):
    """``[(tree, env dim)] -> [tree]``: each tree (a tensor, an EnvState,
    or tuples and dicts of them) with every leaf gathered along its env dim
    from every rank, in global env order; one :meth:`Mesh.all_gather` for
    all of them. Without a group, the trees themselves."""
    flat, specs, dims = [], [], []
    for tree, dim in pairs:
        leaves, spec = flatten(tree)
        flat += leaves
        dims += [dim] * len(leaves)
        specs.append((spec, len(leaves)))
    out = iter(mesh.all_gather(flat, dims))
    return [unflatten(spec, [next(out) for _ in range(n)])
            for spec, n in specs]


def broadcast_from(mesh: Mesh, tensors: Sequence[torch.Tensor],
                   src: int = 0):
    """Overwrite each of ``tensors`` in place with rank ``src``'s, one
    broadcast over their concatenation (the counterpart of committing the
    learner state to a replicated sharding): every rank starts from the
    same weights and optimizer state. A collective: every rank calls it
    with tensors of the same shapes and dtypes."""
    tensors = [t for t in tensors if t.numel()]
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    dist.broadcast(flat, src=src, group=mesh.group)
    for t, v in zip(tensors, _split(flat, tensors)):
        with torch.no_grad():
            t.copy_(v)


def init_distributed(device="cuda", coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device (the
    train CLI's ``--distributed``).

    ``coordinator``: ``host:port`` of rank 0 (``tcp://``), or a whole init
    URL (``tcp://…``, ``file://…``), with ``num_processes`` and
    ``process_id``; without it ``env://``, the variables ``torchrun``
    sets. On the card each rank takes ``cuda:{LOCAL_RANK}`` (without that
    variable, ``cuda:{process_id % cards}``). ``backend``: NCCL on the card,
    gloo on the CPU, unless named."""
    dev = resolve(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else (process_id or 0) % torch.cuda.device_count())
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if coordinator:
        kw = dict(init_method=(coordinator if "://" in coordinator
                               else f"tcp://{coordinator}"),
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                        else "gloo"), **kw)
    return dev
