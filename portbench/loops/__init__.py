"""The loops a traffic mix can name: one module each, found by the name in
the traffic file's ``loop`` key (``portbench/loops/<loop>.py``). A traffic
mix that reuses a loop is a data file alone; a loop of a new kind (a
recurrent or hetero rollout, env-only steps, serving) is a new module here,
and no existing file changes.

A loop module has:

- ``KIND``: the word its metrics' readers select it by (``ctx.kind``:
  ``"train"`` or ``"rollout"`` so far).
- ``Program(config, traffic, seed, device, mesh)``: the program's timed
  path built from the configuration's ``args`` at the traffic's sizes,
  with the run's inputs (``inputs.py``); ``mesh`` is the port's data mesh
  over the run's ranks, or None on one card. It has ``steps_per_call``
  (env transitions a call, over all ranks), ``shape`` (the sizes
  ``roofline.py`` and ``flops.py`` read: this rank's), ``call()`` (one
  call: ``(enqueued_s, done_s, values)``), ``setup(n)`` (the first ``n``
  calls, keeping what the check reads; returns the capturing call's host
  seconds), ``watch(i, after)`` (around window call ``i``, to keep a call
  the check reads) and ``window_done`` (whether the window may close),
  and ``kept()`` (what the check reads, once the window has closed).
- ``check(config, traffic, seed, device, kept)``: the readings the cell's
  limits hold, from the plain reference (``portbench/reference/``) run
  after the program is freed.
- ``in_place(config, traffic, seed, device, weights, quant=, fault=)`` and
  ``FAULTS``: the reference put in the program's place, as the control
  (``quant``) or with a planted fault, read as ``check`` reads the program
  (``calibrate.py``).
"""
import importlib
import importlib.util
import re
import sys
from pathlib import Path

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(name: str, where=None):
    """The loop module ``<name>.py`` of this package, or, where this package
    has none, of the directory ``where`` (a checkout's
    ``portbench/loops``), loaded as a module of this package."""
    if not _NAME.match(name):
        raise ValueError(f"loop {name!r}: a Python identifier")
    full = f"{__name__}.{name}"
    if where is None or (Path(__file__).parent / f"{name}.py").exists():
        return importlib.import_module(full)
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            full, Path(where) / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return sys.modules[full]
