"""The 'model' axis: the tensor-parallel feedforward policy.

Counterpart of the tensor parallelism in the JAX package's multi-chip dry
run (``__graft_entry__.py::dryrun_multichip``), where parameters placed
under its rule make GSPMD shard the policy's matmuls over 'model'. Here the
rule is explicit (``models.MODEL_SPLIT``) and the collectives are written
out, on the model group of a ``parallel/mesh.py`` Mesh:

- ``torso0`` (the one-hot embed, kernels K2f and K2b on the card) runs on
  this rank's H / n_model columns of its three tables, with its bias's
  columns: a column-sharded activation;
- which is all-gathered over 'model' (``mesh.model_gather``; backward:
  this rank's columns of the gradient summed over 'model') before the
  ``torso`` Dense, column-parallel: this rank's H / n_model output rows of
  its weight, with its bias's columns;
- the ``pi`` and ``v`` heads are row-parallel: this rank's H / n_model
  input columns of each weight give partial logits and values, summed over
  'model' in one all-reduce (``mesh.model_sum``; backward: the identity),
  model rank 0 adding the biases before the sum.

So every rank of a model group computes the whole forward of the
unsharded policy (up to the order of float sums; with n_model = 1, the
same operations) and holds the same loss. Its gradients are the
unsharded gradients' shards, but for the four replicated biases, of
which each rank used a part only: :meth:`sync_grads` sums those over
'model' before the clip and Adam, and computes the whole model's gradient
norm, the shards' squares summed over 'model' and the replicated entries'
counted once. ``ppo.make_train_step(mesh=...)`` takes such a net as it
takes the unsharded one: the data axis splits the env batch and the
minibatches, the model axis the policy.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..models import MODEL_SPLIT, ActorCritic
from .mesh import Mesh, broadcast_from, model_gather, model_sum

#: the replicated biases each model rank applies to part of the output
#: only (torso0's and torso's on their columns, the heads' on model rank
#: 0's partial sums): their gradients are summed over 'model'
PARTIAL = ("torso0.bias", "torso.bias", "pi.bias", "v.bias")


class TensorParallelActorCritic(ActorCritic):
    """The feedforward mlp :class:`ActorCritic` as one rank of the
    ``mesh``'s model axis holds it: the entries of ``models.MODEL_SPLIT``
    (state_dict entry -> dim) are this rank's contiguous ``1 / n_model``
    shards (the ``mesh.model_index``-th part), every other entry whole.
    The weights are drawn from ``generator`` as the unsharded net's (the
    same generator gives the shards of the same weights);
    ``load_state_dict(models.load_flax_params_shard(params,
    mesh.model_index, mesh.n_model))`` carries flax weights over.
    ``forward`` takes what :class:`ActorCritic`'s does (feature-major codes)
    and returns the whole logits and values on every model rank."""

    def __init__(self, cfg, view_size: int, mesh: Mesh, generator=None,
                 device="cuda"):
        if cfg.torso != "mlp" or cfg.rnn:
            raise ValueError(f"the tensor-parallel policy is the feedforward "
                             f"mlp one, not torso={cfg.torso!r} "
                             f"rnn={cfg.rnn!r}")
        super().__init__(cfg, view_size, generator, device)
        self.mesh = mesh
        n, m = mesh.n_model, mesh.model_index
        if cfg.hidden % n:
            raise ValueError(f"hidden {cfg.hidden} does not split over "
                             f"{n} model ranks")
        h = cfg.hidden // n
        self.cols = slice(m * h, (m + 1) * h)
        whole = self.state_dict()
        for name, dim in MODEL_SPLIT.items():
            owner, attr = name.rsplit(".", 1)
            setattr(self.get_submodule(owner), attr, torch.nn.Parameter(
                whole[name].narrow(dim, m * h, h).clone(
                    memory_format=torch.contiguous_format)))
        self.torso0.features = h

    def forward(self, obs: torch.Tensor, aux=None):
        if aux is not None:
            raise ValueError("aux features go with the pixels torsos")
        mesh, dt, first = self.mesh, self.dtype, self.mesh.model_index == 0
        x = F.relu(self.torso0(obs, self.cols))              # (..., H/n)
        x = model_gather(mesh, x)                            # (..., H)
        x = F.relu(F.linear(x, self.torso.weight.to(dt),
                            self.torso.bias[self.cols].to(dt)))
        # the heads' biases enter once, on model rank 0's partial sums (the
        # other ranks add them times 0, so that their gradients exist)
        logits, value = model_sum(mesh, *(
            F.linear(x, lin.weight.to(dt),
                     lin.bias.to(dt) if first else lin.bias.to(dt) * 0)
            for lin in (self.pi, self.v)))
        return logits.float(), value.float()[..., 0]

    def _grad_names(self):
        return [n for n, p in self.named_parameters() if p.requires_grad]

    def sync_grads(self, grads):
        """The model axis's part of an update, after the data axis's sum:
        ``grads`` (in the order of the net's parameters) with the
        :data:`PARTIAL` biases' gradients summed over 'model', and the
        squared global norm of the whole model's gradient (each shard's
        squares summed over 'model', each replicated entry's counted
        once), in one ``all_reduce`` over the model group. Summed in
        parameter order, as ``ppo.clip_by_global_norm`` sums, so that at
        n_model = 1 the norm is the unsharded step's, bit for bit."""
        names = self._grad_names()
        sharded = [n in MODEL_SPLIT for n in names]
        partial = [i for i, n in enumerate(names) if n in PARTIAL]
        sq = [(g * g).sum() for g, s in zip(grads, sharded) if s]
        *biases, sq = self.mesh.model_psum(
            [grads[i] for i in partial] + [torch.stack(sq)])
        grads = list(grads)
        for i, b in zip(partial, biases):
            grads[i] = b
        sq = iter(sq.unbind())
        total = sum(next(sq) if s else (g * g).sum()
                    for g, s in zip(grads, sharded))
        return grads, total


def broadcast_state(mesh: Mesh, net: TensorParallelActorCritic,
                    optimizer=None):
    """Every rank starts from the replicated entries (and their optimizer
    state) of the process group's rank 0, and from the shards of the rank
    at data index 0 of its own data group: a model rank's shards are never
    overwritten by another model rank's. Two broadcasts; a collective that
    every rank calls."""
    state = {} if optimizer is None else optimizer.state
    parts = {True: [], False: []}
    for name, p in net.named_parameters():
        parts[name in MODEL_SPLIT].append(p)
        parts[name in MODEL_SPLIT] += [t for t in state.get(p, {}).values()
                                       if torch.is_tensor(t)]
    broadcast_from(mesh, parts[False], world=True)
    broadcast_from(mesh, parts[True])
