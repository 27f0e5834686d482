"""Checkpoint / exact resume, torch-native.

Counterpart of ``marlgrid_tpu/utils/checkpoint.py``. A checkpoint directory
holds one ``torch.save`` file per step, ``step_<N>.pt``, each a nested
dict of tensors and plain values (the model's and the optimizer's
``state_dict``, the env state's tensors, the key), and ``config.json``
beside them, written as the JAX package writes it, so a checkpoint
describes the run that made it. Restoring the same tree on the CPU gives
back the same bits.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import torch

_STEP = re.compile(r"^step_(\d+)\.pt$")


def save(path: str, tree: Any, step: int = 0, config: dict = None) -> str:
    """Write ``tree`` as ``<path>/step_<step>.pt`` (atomic rename) and, if
    given, ``config`` as ``<path>/config.json``; returns the directory."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if config is not None:
        save_config(path, config)
    tmp = os.path.join(path, f".step_{int(step)}.pt.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, f"step_{int(step)}.pt"))
    return path


def save_config(path: str, config: dict):
    """Write ``config.json`` beside the checkpoint steps (atomic rename)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, ".config.json.tmp")
    with open(tmp, "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, "config.json"))


def load_config(path: str) -> Optional[dict]:
    """Read ``config.json`` written by :func:`save`; None if absent."""
    p = os.path.join(os.path.abspath(path), "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def steps(path: str):
    """The steps saved under ``path``, ascending."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.match, os.listdir(path))
                  if m)


def restore(path: str, step: int = None, map_location=None):
    """The tree saved by :func:`save` at ``step`` (default: the latest),
    its tensors on ``map_location`` (default: where they were saved)."""
    path = os.path.abspath(path)
    if step is None:
        have = steps(path)
        if not have:
            raise FileNotFoundError(f"no checkpoint step under {path}")
        step = have[-1]
    return torch.load(os.path.join(path, f"step_{int(step)}.pt"),
                      map_location=map_location, weights_only=True)
