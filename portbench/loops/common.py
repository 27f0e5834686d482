"""What the loops share: the program built as the train CLI builds it, from
the argv of the configuration at the traffic's sizes
(``reference/cli.py::cli_flags``) that the reference's frozen copy of the
CLI's parser reads too.

The program starts as the CLI starts: the run's key, the env batch from
``fold_in(key, 1)`` (under a mesh, this rank's slice of the global batch)
and the step key ``fold_in(key, 2)``. The weights are the run's inputs
(``inputs.make_weights``), loaded before the first call; under a mesh every
rank then takes rank 0's weights and optimizer state, as the CLI does.
"""
from __future__ import annotations

import math
import time

import torch

from .. import inputs
from ..reference.cli import cli_flags


class Program:
    """The program as the train CLI builds it from ``args``: ``ep``,
    ``cfg``, ``net``, ``opt``, ``h`` (None for feedforward), ``state``,
    ``key``, ``weights`` (the run's inputs), ``mesh``, ``shards`` (the
    keyword a step builder takes to run over the mesh). ``call`` runs
    ``self.step`` once and reads its values; a subclass sets ``step`` and
    ``values(out)``."""

    #: the loop module's KIND
    kind: str
    steps_per_call: int
    window_done = True

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 mesh=None):
        from marlgrid_tpu_torch.core import rng
        from marlgrid_tpu_torch.parallel import mesh as mesh_mod
        from marlgrid_tpu_torch.parallel import ppo, train

        args = train.parse_args(cli_flags(config["args"], traffic, seed))
        ep, cfg = train.build(args)
        if cfg.dtype != getattr(torch, config["dtype"]):
            raise ValueError(f"the program computes in {cfg.dtype}, the "
                             f"configuration states {config['dtype']}")
        self.ep, self.cfg, self.dev, self.mesh = ep, cfg, device, mesh
        net, opt, h = train.init(ep, cfg, torch.Generator().manual_seed(0),
                                 device)
        self.weights = inputs.make_weights(
            [(n, tuple(p.shape)) for n, p in net.named_parameters()], seed,
            device)
        net.load_state_dict(self.weights)
        key = inputs.make_key(seed, device)
        self.state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                                        stagger=not args.no_stagger,
                                        device=device, mesh=mesh)
        self.key = rng.fold_in(key, 2)
        self.h = train.local_carry(mesh, h, train.carry_dim(ep, cfg))
        if mesh is not None:
            mesh_mod.broadcast_from(mesh, list(net.state_dict().values()) + [
                t for st in opt.state.values() for t in st.values()
                if torch.is_tensor(t)], world=True)
        self.net, self.opt = net, opt
        self.shards = {} if mesh is None else {"mesh": mesh}
        world = 1 if mesh is None else mesh.D
        self.steps_per_call = cfg.n_envs * cfg.rollout_len
        cw = (0 if cfg.embed_palettes is None
              else sum(len(v) for v in cfg.embed_palettes))
        self.shape = dict(loop=self.kind, B=cfg.n_envs // world,
                          T=cfg.rollout_len,
                          N=ep.n_agents, view=ep.view_size,
                          tile=ep.view_tile_size, obs=ep.observation_style,
                          torso=cfg.torso, hidden=cfg.hidden, rnn=cfg.rnn,
                          cw=cw, epochs=cfg.n_epochs,
                          minibatches=cfg.n_minibatches)
        self.out = None

    def call(self):
        t0 = time.perf_counter()
        if self.cfg.rnn:
            self.state, self.h, self.key, out = self.step(self.state, self.h,
                                                          self.key)
        else:
            self.state, self.key, out = self.step(self.state, self.key)
        t1 = time.perf_counter()
        values = self.values(out)
        self.out = out
        return t1 - t0, time.perf_counter() - t0, values

    def whole(self):
        """``(state, h)``: the env state and the carry of the global batch
        (under a mesh, gathered from every rank in global env order: a
        collective every rank calls)."""
        if self.mesh is None:
            return self.state, self.h
        from types import SimpleNamespace

        from marlgrid_tpu_torch.core.state import FIELDS
        from marlgrid_tpu_torch.parallel import mesh as mesh_mod, train

        state = SimpleNamespace(**{
            f: mesh_mod.gather(self.mesh, getattr(self.state, f), 0)
            for f in FIELDS})
        dim = train.carry_dim(self.ep, self.cfg)
        h = (None if self.h is None else train._carry_map(
            lambda t: mesh_mod.gather(self.mesh, t, dim), self.h))
        return state, h

    def watch(self, i: int, after: bool):
        """Around window call ``i`` (before it, and ``after`` it)."""

    @staticmethod
    def finite(values: dict) -> bool:
        return all(math.isfinite(v) for v in values.values())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
