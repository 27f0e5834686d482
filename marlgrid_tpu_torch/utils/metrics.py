"""Structured metrics / logging: a JSONL metric stream.

The port's own copy of ``marlgrid_tpu/utils/metrics.py``'s ``MetricsLogger``
(same records, same fields). The step functions keep metrics as device
tensors; the host logs one line per logged iteration.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 flush_every: int = 1):
        # "w": a fresh run truncates (appending would mix two runs in one
        # file); a resumed run that wants appending passes an open stream
        self._fh = open(path, "w") if path else (stream or sys.stdout)
        self._owns = path is not None
        self._flush_every = flush_every
        self._n = 0
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._fh.flush()

    def close(self):
        if self._owns:
            self._fh.close()

