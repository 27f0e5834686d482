"""Feedforward actor-critic on 'encode' observations (PyTorch port).

Counterpart of ``marlgrid_tpu/models/actor_critic.py`` for the mlp torso
on feature-major observations: ``OneHotEmbed`` (the fused one-hot embed:
kernel K2f on the card, and K2b for its table's gradient), a dense torso
layer and the policy/value heads.
Activations run in the compute dtype (bf16 by default, or float32); the
heads' outputs are cast to float32. Parameters are float32 and carry the
flax parameters' names and shapes, so :func:`load_flax_params` moves JAX
weights across. The cnn torsos and the recurrent family wait for later
slices (ROADMAP Slices C and D).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core import constants as C
from ..device import resolve
from ..ops import embed as embed_op

_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class OneHotEmbed(nn.Module):
    """First layer: per-cell symbolic codes -> hidden, on feature-major
    codes ``(..., 3*cells, S)`` -> ``(..., S, features)``.

    ``palettes``: compact per-scenario code vocabularies
    ((types…), (colors…), (states…)) from ``core/obs.py::encode_palettes``;
    None = the full static vocabularies (state codes clipped at 19).
    Differentiable in the three tables on both devices (``ops/embed.py``:
    the packed table's gradient splits back to w0/w1/w2 through the
    concatenation).
    """

    def __init__(self, cells: int, features: int, dtype=torch.bfloat16,
                 palettes=None, generator=None):
        super().__init__()
        self.cells, self.features, self.dtype = cells, features, dtype
        self.widths, self.values = embed_op.vocab(palettes)
        for i, n in enumerate(self.widths):
            w = torch.empty(cells * n, features)
            lecun_normal_(w, cells * n, generator)
            setattr(self, f"w{i}", nn.Parameter(w))
        self.bias = nn.Parameter(torch.zeros(features))

    def table(self) -> torch.Tensor:
        """(cells, sum(widths), H) packed table of the three planes."""
        return embed_op.pack_weights(*(
            getattr(self, f"w{i}").reshape(self.cells, n, self.features)
            for i, n in enumerate(self.widths)))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        lead, (Fd, S) = obs.shape[:-2], obs.shape[-2:]
        x = obs.reshape((-1, Fd, S))
        out = embed_op.onehot_embed(x, self.table(), self.widths,
                                    self.values, self.dtype)
        out = out.reshape(lead + out.shape[1:]).to(self.dtype)
        return out + self.bias.to(self.dtype)


class ActorCritic(nn.Module):
    """mlp torso on feature-major 'encode' observations + policy/value
    heads: ``forward(obs (..., 3*vs*vs, S) uint8)`` -> ``(logits (..., S,
    7) float32, value (..., S) float32)``.

    ``cfg`` is a PPOConfig (hidden, dtype, torso, rnn, embed_palettes).
    Weights are initialized as flax initializes them (lecun-normal kernels,
    zero biases), drawn from ``generator``.
    """

    def __init__(self, cfg, view_size: int, generator=None, device="cuda"):
        super().__init__()
        if cfg.torso != "mlp" or cfg.rnn:
            raise NotImplementedError(
                f"torso={cfg.torso!r} rnn={cfg.rnn!r}: the port has the "
                f"feedforward mlp torso; cnn torsos come with ROADMAP "
                f"Slice C, recurrent cells with Slice D")
        dev = resolve(device)
        self.dtype = cfg.dtype
        h = cfg.hidden
        self.torso0 = OneHotEmbed(view_size * view_size, h, cfg.dtype,
                                  cfg.embed_palettes, generator)
        self.torso = nn.Linear(h, h)
        self.pi = nn.Linear(h, C.N_ACTIONS)
        self.v = nn.Linear(h, 1)
        for lin in (self.torso, self.pi, self.v):
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        self.to(dev)

    def _dense(self, lin: nn.Linear, x):
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, obs: torch.Tensor):
        x = F.relu(self.torso0(obs))
        x = F.relu(self._dense(self.torso, x))
        logits = self._dense(self.pi, x).float()
        value = self._dense(self.v, x).float()
        return logits, value[..., 0]


def load_flax_params(params) -> Dict[str, torch.Tensor]:
    """A state_dict for :class:`ActorCritic` from the flax ActorCritic's
    parameters as numpy arrays (``{'params': {...}}`` or the inner dict):
    ``torso0/{w0,w1,w2,bias}`` as they are, and the ``torso``, ``pi`` and
    ``v`` Dense layers' ``kernel`` (in, out) transposed to torch's
    ``weight`` (out, in)."""
    p = params.get("params", params)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    sd = {f"torso0.{k}": t(p["torso0"][k])
          for k in ("w0", "w1", "w2", "bias")}
    for name in ("torso", "pi", "v"):
        sd[f"{name}.weight"] = t(p[name]["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = t(p[name]["bias"])
    return sd
