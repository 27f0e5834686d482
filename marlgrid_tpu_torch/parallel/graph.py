"""One train step as one CUDA graph: the port's counterpart of ``jax.jit``
over a train step (``make_train_step(..., jit=True)``) and of the
``multi_step`` functions' single dispatch.

A train step of the port runs eagerly: the host issues every op of the
rollout, the update and the optimizer one by one (hundreds of thousands of
launches a step on the hetero recurrent path). :class:`GraphedStep` records
one step into a ``torch.cuda.CUDAGraph`` and replays it, so a step costs the
host one graph launch.

It wraps a raw step ``fn(*carry) -> (*carry, metrics)``: a carry is an
``EnvState``, the key, a recurrent carry (a tensor, an LSTM's ``(c, h)``
tuple or a hetero ``{group: h}`` dict) or the overlap step's ``prev =
(traj dict, last_value)``; :func:`flatten` turns each into its tensors.

- The first call runs ``fn`` eagerly on a side stream and returns its
  results. This real step fills what the step creates on first use and a
  capture could not: the device tables the kernel wrappers copy from numpy
  (a pageable host-to-device copy is an error inside a capture), Adam's
  state, the cuBLAS and cuDNN handles and workspaces of that stream, and
  the NCCL communicator of a step with collectives (a communicator cannot
  be created inside a capture).
- The second call clones its carry into static buffers, captures one step
  on them (with the graph's own memory pool) that ends by copying the new
  carry into the same buffers, and replays it. Every later call copies a
  carry that is not those buffers into them and replays: replay n + 1
  reads replay n's output.
- The tensors a graphed call returns ARE the static buffers and the
  graph's metric tensors: like the arguments JAX donates
  (``donate_argnums``), the next call overwrites them. A caller that keeps
  a value across calls (a checkpoint, a comparison) clones it.
- A replay does not pass through the kernel wrappers, so each wrapper's
  ``.launches`` delta during the capture is recorded, the counts are set
  back (a capture launches nothing), and every replay adds the delta:
  ``.launches`` still counts the launches of the process.
- A capture that fails raises, naming the step; nothing falls back to the
  eager step. On the CPU (the caller asked for ``device="cpu"``) there is
  no graph: every call runs ``fn``.

- The whole step runs under the root stage span ``step``
  (``utils/profiling.py::stage``), inside which the trainers open
  ``rollout``, ``update`` and their ``rollout.*`` / ``update.*`` stages. A
  replay runs no Python, so the capture records which graph nodes each
  stage added (``profiling.StageRecorder``): ``stages`` keeps the graph's
  device-work nodes (kernels, memcpys, memsets) in replay order as runs of
  ``(stage path, node count)``, ``node_names`` their names. Nothing is
  added to the graph, nor to a replay's host work. :func:`captured` finds
  the live steps that hold a graph.

The network and the optimizer are updated in place by the step, so the
graph holds their tensors' addresses: load weights or optimizer state
(``load_state_dict``) before the first call, never between calls.
"""
from __future__ import annotations

import itertools
import time
import warnings
import weakref

import torch

from ..core.state import FIELDS, EnvState
from ..ops import kernel_wrappers
from ..utils import profiling

_LEAF = "tensor"
#: the steps that hold a captured graph, weakly: a freed step's graph and
#: memory are not pinned
_captured = weakref.WeakValueDictionary()
_order = itertools.count()


def captured():
    """The live :class:`GraphedStep` s that hold a captured graph, in the
    order of their captures."""
    return list(_captured.values())


def flatten(tree):
    """``(leaves, spec)``: the tensors of a carry (tensors in tuples, dicts
    and EnvStates) in a fixed order, and a comparable description of its
    structure for :func:`unflatten`.
    Dict entries go in the order of their keys' ``repr``, so two dicts
    with the same keys flatten alike whatever their insertion order."""
    leaves = []

    def go(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return _LEAF
        if isinstance(t, EnvState):
            return (EnvState, tuple(go(getattr(t, f)) for f in FIELDS))
        if isinstance(t, tuple):
            return (tuple, tuple(go(x) for x in t))
        if isinstance(t, dict):
            keys = tuple(sorted(t, key=repr))
            return (dict, keys, tuple(go(t[k]) for k in keys))
        raise TypeError(f"graph carry: cannot flatten a {type(t).__name__}")

    return leaves, go(tree)


def unflatten(spec, leaves):
    """The carry :func:`flatten` described by ``spec``, with ``leaves`` in
    place of its tensors."""
    it = iter(leaves)

    def go(s):
        if s == _LEAF:
            return next(it)
        if s[0] is EnvState:
            return EnvState(**dict(zip(FIELDS, map(go, s[1]))))
        if s[0] is dict:
            return {k: go(x) for k, x in zip(s[1], s[2])}
        return tuple(go(x) for x in s[1])

    out = go(spec)
    if next(it, None) is not None:
        raise ValueError("graph carry: more leaves than the spec holds")
    return out


def _describe(leaves):
    return [(tuple(x.shape), x.dtype) for x in leaves]


class GraphedStep:
    """``fn(*carry) -> (*carry, metrics)`` as a captured CUDA graph with the
    same signature (see the module docstring). ``name`` names the step in
    errors. ``capture_error_mode`` is ``torch.cuda.graph``'s; a step whose
    collectives run on a process group is captured ``"thread_local"``
    (``ppo.capture_error_mode``). ``capture_s`` is the capture's wall time
    (recording and instantiation), None before it. ``first_s``: the host wall of the eager first
    call through the device's completion of it. ``stages`` and
    ``node_names``: the stage map (module docstring), None before the
    capture or where the CUDA driver's graph functions failed (a warning says
    why)."""

    def __init__(self, fn, name: str, capture_error_mode: str = "global"):
        self.fn, self.name = fn, name
        self.capture_error_mode = capture_error_mode
        self.stream = None
        self.graph = None
        self.capture_s = self.first_s = None
        self.stages = self.node_names = None

    def _run(self, carry):
        with profiling.stage("step"):
            return self.fn(*carry)

    def __call__(self, *carry):
        leaves, spec = flatten(carry)
        dev = leaves[0].device
        if dev.type != "cuda":
            return self._run(carry)
        if self.stream is None:
            t0 = time.perf_counter()
            self.stream = torch.cuda.Stream(dev)
            out = self._on_side(lambda: self._run(carry))
            self.stream.synchronize()
            self.first_s = time.perf_counter() - t0
            return out
        if self.graph is None:
            self._capture(leaves, spec, dev)
        else:
            self._load(leaves, spec)
        self.graph.replay()
        for fn, n in self._delta:
            fn.launches += n
        return self._outputs

    def _on_side(self, run):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = run()
        cur.wait_stream(self.stream)
        return out

    def _load(self, leaves, spec):
        """Copy a carry that is not the static buffers into them."""
        if spec != self._spec or _describe(leaves) != self._shapes:
            raise ValueError(f"{self.name}: the carry's structure, shapes or "
                             f"dtypes differ from the captured step's")
        for x, s in zip(leaves, self._static):
            if x is not s:
                s.copy_(x)

    def _capture(self, leaves, spec, dev):
        t0 = time.perf_counter()
        wrappers = list(kernel_wrappers().values())
        before = [fn.launches for fn in wrappers]
        static = self._on_side(lambda: [x.clone() for x in leaves])
        storages = {x.untyped_storage().data_ptr() for x in static}
        graph = torch.cuda.CUDAGraph()
        rec = profiling.StageRecorder(self.stream)
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode=self.capture_error_mode
                                  ), profiling.recording(rec):
                with profiling.stage("step"):
                    out = self.fn(*unflatten(spec, static))
                    new, out_spec = flatten(tuple(out[:-1]))
                    if out_spec != spec or _describe(new) != _describe(
                            static):
                        raise ValueError("the step returns a carry of "
                                         "another structure, shape or dtype "
                                         "than it takes")
                    # a new leaf that shares a buffer with the carry is
                    # read before the copies below overwrite that buffer
                    new = [y if y is s or y.untyped_storage().data_ptr()
                           not in storages else y.clone()
                           for y, s in zip(new, static)]
                    for y, s in zip(new, static):
                        if y is not s:
                            s.copy_(y)
                # the graph's nodes exist only until it is instantiated
                self.stages, self.node_names = rec.finish()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            rec.close()
        if rec.error is not None:
            warnings.warn(f"{self.name}: no stage map ({rec.error})")
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        self._delta = [(fn, fn.launches - n)
                       for fn, n in zip(wrappers, before) if fn.launches > n]
        for fn, n in zip(wrappers, before):
            fn.launches = n
        self.graph, self._static, self._spec = graph, static, spec
        self._shapes = _describe(static)
        self._outputs = (*unflatten(spec, static), out[-1])
        self.capture_s = time.perf_counter() - t0
        _captured[next(_order)] = self

