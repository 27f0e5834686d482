"""The ranks of a cell on more than one card: one process a card, started
from the one command the driver runs. The process that runs the command
is rank 0 and prints the line; ranks 1 to ``world - 1`` are the same
command with ``--rank``, ``--world`` and ``--init`` added. They meet at a
``file://`` rendezvous in a fresh directory under ``TMPDIR``, which goes
when the run ends.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import tempfile

#: seconds rank 0 waits for the other ranks once its own run has ended
WAIT_S = 120


@contextlib.contextmanager
def started(world: int, argv_of):
    """Start ranks 1 to ``world - 1`` (``argv_of(rank, init)`` is each one's
    command) and give rank 0 the rendezvous URL ``init``. On leaving, wait
    for every rank to end (ending any that outlive ``WAIT_S``), remove the
    rendezvous, and raise if a rank failed."""
    where = tempfile.mkdtemp(prefix="portbench-ranks-")
    init = "file://" + os.path.join(where, "rendezvous")
    procs = [subprocess.Popen(argv_of(r, init), stdout=subprocess.DEVNULL)
             for r in range(1, world)]
    failed = []
    try:
        yield init
    finally:
        for r, p in enumerate(procs, 1):
            try:
                p.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode:
                failed.append(f"rank {r}: exit code {p.returncode}")
        shutil.rmtree(where, ignore_errors=True)
    if failed:
        raise RuntimeError("; ".join(failed))
