"""The ('data', 'model') mesh over ranks of ``torch.distributed``.

Counterpart of ``marlgrid_tpu/parallel/mesh.py`` for the sharded train
steps. One rank is one process on one device. The ranks of the process
group are laid out as JAX's ``make_mesh`` lays out its devices,
``reshape(n_data, n_model)``: rank i sits at data index ``i // n_model``
and model index ``i % n_model``. The ranks with one model index form a
**data group** of D = n_data ranks, the ranks with one data index a
**model group** of n_model ranks.

Each rank holds its data index's slice of the env batch (the env batch is
``P("data")``: the ranks of a model group hold the same slice), and the
ranks meet only at the collectives a step calls by hand. Over the data
group: :meth:`Mesh.pmean` and :meth:`Mesh.psum`, each one ``all_reduce``
over a flat bucket of its tensors (the explicit-collective ``shard_map``
steps, and the gradients of the default path), and :meth:`Mesh.all_gather`,
one in-place ``all_gather_into_tensor`` over a flat byte buffer (the
default path's trajectory, gathered in global env order for the update).
Over the model group, for the tensor-parallel policy
(``parallel/tensor_parallel.py``): :meth:`Mesh.model_psum` and
:meth:`Mesh.model_all_gather`, and their differentiable forms
:func:`model_sum` and :func:`model_gather`.

Without a process group the mesh is 1 x 1, rank 0, and its collectives
return their inputs, as a ``psum`` over an axis of size 1 does: there is no
communication to run. With a group, every collective runs on its group,
even one of size 1, so a CUDA graph captured on one card holds its nodes.

The backend follows the device (NCCL on ``cuda``, gloo on ``cpu``) unless
the caller names one; nothing swaps one backend for another.
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
    data axis and ``n_model`` on the model axis; this process's ``rank``
    in the process group, its ``data_index`` (``rank // n_model``) and
    ``model_index`` (``rank % n_model``); the data ``group`` and the
    ``model_group`` it belongs to and the whole process group ``world``
    (all None: no group, a 1 x 1 mesh); the ``device`` the rank computes
    on. ``all_reduces`` and ``all_gathers`` count the data axis's calls,
    ``model_all_reduces`` and ``model_all_gathers`` the model axis's, so a
    caller can count the collectives of a step by axis."""

    def __init__(self, D: int, rank: int, group, device: torch.device,
                 n_model: int = 1, model_group=None, world=None):
        if group is None and D * n_model != 1:
            raise ValueError(f"a {D}x{n_model} mesh needs a process group")
        self.D, self.rank, self.n_model = D, rank, n_model
        self.data_index, self.model_index = divmod(rank, n_model)
        self.group, self.model_group = group, model_group
        self.world = group if world is None else world
        self.device = device
        self.all_reduces = 0
        self.all_gathers = 0
        self.model_all_reduces = 0
        self.model_all_gathers = 0

    def psum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data axis of each tensor: one ``all_reduce(SUM)``
        over the tensors' concatenation, split back to their shapes and
        dtypes (new tensors; without a group, the inputs themselves)."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        self.all_reduces += 1
        return _all_reduce(tensors, self.group)

    def pmean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data axis, ``psum / D`` as JAX lowers ``pmean``
        (not ``ReduceOp.AVG``, so the division rounds as JAX's does)."""
        if self.group is None:
            return list(tensors)
        return [t / self.D for t in self.psum(tensors)]

    def all_gather(self, tensors: Sequence[torch.Tensor],
                   dims: Sequence[int]) -> List[torch.Tensor]:
        """Every data rank's ``tensors[i]`` concatenated along ``dims[i]``
        in data order: this rank's slices of the env batch become the
        global batch, in global env order. One in-place
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
        mine = rows[self.data_index]
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

    def model_psum(self, tensors: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum over the model axis of each tensor, as :meth:`psum`
        sums over the data axis: one ``all_reduce(SUM)`` of their
        concatenation over the model group (without a group, the inputs
        themselves)."""
        tensors = list(tensors)
        if self.model_group is None:
            return tensors
        self.model_all_reduces += 1
        return _all_reduce(tensors, self.model_group)

    def model_all_gather(self, x: torch.Tensor, dim: int = -1
                         ) -> torch.Tensor:
        """Every model rank's ``x`` concatenated along ``dim`` in model
        order (a column-sharded activation made whole): one
        ``all_gather_into_tensor`` into a flat buffer of n_model rows, then
        one copy into place. Without a group, ``x`` itself."""
        if self.model_group is None:
            return x
        d = dim % x.dim()
        out = torch.empty(self.n_model * x.numel(), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.detach().reshape(-1),
                                    group=self.model_group)
        self.model_all_gathers += 1
        return out.view((self.n_model,) + x.shape).movedim(0, d).reshape(
            x.shape[:d] + (-1,) + x.shape[d + 1:])


def _all_reduce(tensors, group):
    """One ``all_reduce(SUM)`` over ``group`` of the tensors'
    concatenation, split back to their shapes and dtypes."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _split(flat, tensors)


class _ModelSum(torch.autograd.Function):
    """The sums over the model axis of a row-parallel layer's partial
    outputs, in one all-reduce. Backward: the identity, tensor by tensor
    (every model rank holds the same gradient of the summed outputs)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        return tuple(mesh.model_psum(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


class _ModelGather(torch.autograd.Function):
    """The all-gather of a column-sharded activation over the model axis.
    Backward: this rank's columns of the gradient summed over the model
    axis (a reduce-scatter, written as a slice of an all-reduce, which
    gloo and NCCL both run and a CUDA graph captures)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim % x.dim()
        ctx.width = x.shape[ctx.dim]
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        whole = mesh.model_psum([g])[0]
        return (whole.narrow(ctx.dim, mesh.model_index * ctx.width,
                             ctx.width), None, None)


def model_sum(mesh: Mesh, *xs: torch.Tensor):
    """The tensors ``xs`` each summed over the model axis (one all-reduce),
    differentiable (backward: the identity). Without a model group, the
    tensors themselves."""
    if mesh.model_group is None:
        return xs
    return _ModelSum.apply(mesh, *xs)


def model_gather(mesh: Mesh, x: torch.Tensor, dim: int = -1
                 ) -> torch.Tensor:
    """``x`` gathered over the model axis along ``dim``, differentiable
    (backward: this rank's columns of the gradient, summed over the model
    axis). Without a model group, ``x``."""
    if mesh.model_group is None:
        return x
    return _ModelGather.apply(x, mesh, dim)


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _subgroup(rank_lists, rank: int):
    """One ``dist.new_group`` per list of global ranks, in order (every rank
    makes every group, as ``new_group`` requires); the group holding
    ``rank``."""
    mine = None
    for ranks in rank_lists:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None,
              device="cuda") -> Mesh:
    """The ``n_data`` x ``n_model`` mesh over the ranks of ``group``
    (default: the default process group, if one is initialized) for a
    rank computing on ``device``. ``n_data`` defaults to the world size
    over ``n_model``; the two must make the world size (JAX's assertion
    and message). Every rank of the default group calls it: it makes the
    model groups, and with ``n_model > 1`` the data groups, with
    ``dist.new_group`` (with ``n_model = 1`` the data group is ``group``
    itself). With no process group: a 1 x 1 mesh, rank 0, identity
    collectives."""
    dev = resolve(device)
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, \
        f"{n_data}x{n_model} mesh != {world} devices"
    if group is None:
        return Mesh(1, 0, None, dev)
    rank = dist.get_rank(group)
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    grid = [ranks[d * n_model:(d + 1) * n_model] for d in range(n_data)]
    me = ranks[rank]
    data = group if n_model == 1 else _subgroup(
        [[row[m] for row in grid] for m in range(n_model)], me)
    model = _subgroup(grid, me)
    return Mesh(n_data, rank, data, dev, n_model, model, group)


def host_local_slice(mesh: Mesh, global_batch: int) -> slice:
    """This rank's slice of the global env batch: its data index's
    (the ranks of a model group hold the same slice)."""
    per = global_batch // mesh.D
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's :func:`host_local_slice` of ``x`` along ``dim``."""
    sl = host_local_slice(mesh, x.shape[dim])
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along ``dim`` in data order
    (the global batch from the ranks' slices, :meth:`Mesh.all_gather`);
    the inverse of :func:`shard`. A collective: every rank calls it."""
    return mesh.all_gather([x], [dim])[0]


def gather_env(mesh: Mesh, pairs):
    """``[(tree, env dim)] -> [tree]``: each tree (a tensor, an EnvState,
    or tuples and dicts of them) with every leaf gathered along its env dim
    from every data rank, in global env order; one :meth:`Mesh.all_gather`
    for all of them. Without a group, the trees themselves."""
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
                   src: int = 0, world: bool = False):
    """Overwrite each of ``tensors`` in place with those of the rank at
    data index ``src`` in this rank's data group, one broadcast over their
    concatenation (the counterpart of committing state to a sharding
    replicated over 'data'): a data group starts from the same weights and
    optimizer state, and a model rank's shards stay its own. ``world``:
    over the whole process group from its rank ``src`` instead (state
    replicated over the whole mesh, as the train CLI commits it). A
    collective: every rank of the group calls it with tensors of the same
    shapes and dtypes."""
    tensors = [t for t in tensors if t.numel()]
    group = mesh.world if world else mesh.group
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
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
