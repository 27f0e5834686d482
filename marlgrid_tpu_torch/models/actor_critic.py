"""Feedforward actor-critic (PyTorch port): the mlp torso on 'encode'
observations and the two pixels torsos on image observations.

Counterpart of ``marlgrid_tpu/models/actor_critic.py``'s ``ActorCritic``:
the mlp torso is ``OneHotEmbed`` (the fused one-hot embed: kernel K2f on
the card, and K2b for its table's gradient) on feature-major codes; the
'cnn_s2d' and 'cnn_image' torsos are ``_conv_torso``'s conv stacks on uint8
images (the convolutions go to ``F.conv2d``, as the JAX package leaves them
to XLA). A dense torso layer and the policy/value heads follow.
Activations run in the compute dtype (bf16 by default, or float32); the
heads' outputs are cast to float32. Parameters are float32 and carry the
flax parameters' names, so :func:`load_flax_params` moves JAX weights
across. The encode 'cnn' torso waits for the rest of ROADMAP Slice C and
the recurrent family for Slice D.
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


def _same_pad(size: int, k: int, stride: int):
    """flax/XLA 'SAME' padding of one spatial axis: (low, high), the odd
    pixel of an uneven total on the high side."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


#: the pixels torsos' conv stack: (name, out channels, kernel, stride);
#: conv1's kernel and stride depend on the torso
_CONVS = {"cnn_s2d": ("conv1", 32, 2, 1), "cnn_image": ("conv1", 32, 8, 4)}
_CONV_TAIL = (("Conv_0", 64, 4, 2), ("Conv_1", 64, 3, 1))


class ActorCritic(nn.Module):
    """A torso + policy/value heads: ``forward(obs, aux=None)`` ->
    ``(logits (..., A) float32, value (...) float32)``.

    - ``torso='mlp'``: feature-major 'encode' codes ``(..., 3*vs*vs, S)``
      uint8 -> logits ``(..., S, 7)``.
    - ``torso='cnn_s2d'``: space-to-depth images ``(..., vs*T/4, vs*T/4,
      48)`` uint8; ``'cnn_image'``: images ``(..., vs*T, vs*T, 3)``. A 2x2
      conv (an 8x8 stride-4 one for cnn_image) without bias, ``x / 255 +
      conv1_bias``, a 4x4 stride-2 and a 3x3 conv, 32/64/64 channels, ReLU
      after each, flax's 'SAME' padding (uneven for the 2x2: (0, 1) on each
      axis, through ``F.pad``). The stack runs channels-last (the uint8
      NHWC input viewed as NCHW needs no copy) and flattens (h, w, c), as
      flax does, so the torso layer's rows are flax's as they are. ``aux``
      (..., aux_dim): the 'rich' style's extra features, concatenated
      after the flatten.

    ``cfg`` is a PPOConfig (hidden, dtype, torso, rnn, embed_palettes);
    ``tile_size`` (the env's view_tile_size) and ``aux_dim`` size the
    pixels torsos. Weights are initialized as flax initializes them
    (lecun-normal kernels, fan-in kh*kw*c_in for a conv; zero biases),
    drawn from ``generator``.
    """

    def __init__(self, cfg, view_size: int, generator=None, device="cuda",
                 tile_size: int = 8, aux_dim: int = 0):
        super().__init__()
        if cfg.rnn:
            raise NotImplementedError(
                f"rnn={cfg.rnn!r}: recurrent cells come with ROADMAP "
                f"Slice D")
        if cfg.torso == "cnn":
            raise NotImplementedError(
                "torso='cnn' (one-hot planes and 3x3 convs on encode obs) "
                "is left over from ROADMAP Slice C (pixels)")
        if cfg.torso not in ("mlp",) + tuple(_CONVS):
            raise ValueError(f"unknown torso {cfg.torso!r}")
        if aux_dim and cfg.torso == "mlp":
            raise ValueError("aux features go with the pixels torsos")
        dev = resolve(device)
        self.dtype = cfg.dtype
        self.kind = cfg.torso
        h = cfg.hidden
        if cfg.torso == "mlp":
            self.torso0 = OneHotEmbed(view_size * view_size, h, cfg.dtype,
                                      cfg.embed_palettes, generator)
            width = h
        else:
            side = view_size * tile_size
            c_in = 3
            if cfg.torso == "cnn_s2d":
                side, c_in = side // 4, 48
            for name, c_out, k, stride in (_CONVS[cfg.torso],) + _CONV_TAIL:
                conv = nn.Conv2d(c_in, c_out, k, stride,
                                 bias=name != "conv1")
                lecun_normal_(conv.weight, c_in * k * k, generator)
                if conv.bias is not None:
                    nn.init.zeros_(conv.bias)
                setattr(self, name, conv)
                side, c_in = -(-side // stride), c_out
            self.conv1_bias = nn.Parameter(torch.zeros(32))
            width = side * side * c_in + aux_dim
        self.torso = nn.Linear(width, h)
        self.pi = nn.Linear(h, C.N_ACTIONS)
        self.v = nn.Linear(h, 1)
        for lin in (self.torso, self.pi, self.v):
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        self.to(dev)

    def _dense(self, lin: nn.Linear, x):
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def _conv(self, conv: nn.Conv2d, x):
        k, stride = conv.kernel_size[0], conv.stride[0]
        (ht, hb), (wl, wr) = (_same_pad(n, k, stride) for n in x.shape[2:])
        w = conv.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        b = None if conv.bias is None else conv.bias.to(self.dtype)
        if (ht, wl) != (hb, wr):
            x = F.pad(x, (wl, wr, ht, hb))
            ht = wl = 0
        return F.conv2d(x, w, b, stride=stride, padding=(ht, wl))

    def _conv_torso(self, obs: torch.Tensor):
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + obs.shape[-3:]).permute(0, 3, 1, 2).to(
            self.dtype)                        # NCHW, channels-last strides
        x = self._conv(self.conv1, x)
        x = F.relu(x / 255.0 + self.conv1_bias.to(self.dtype)[:, None, None])
        x = F.relu(self._conv(self.Conv_0, x))
        x = F.relu(self._conv(self.Conv_1, x))
        return x.permute(0, 2, 3, 1).reshape(lead + (-1,))   # (h, w, c)

    def forward(self, obs: torch.Tensor, aux=None):
        if self.kind == "mlp":
            if aux is not None:
                raise ValueError("aux features go with the pixels torsos")
            x = F.relu(self.torso0(obs))
        else:
            x = self._conv_torso(obs)
            if aux is not None:
                x = torch.cat([x, aux.to(self.dtype)], dim=-1)
        x = F.relu(self._dense(self.torso, x))
        logits = self._dense(self.pi, x).float()
        value = self._dense(self.v, x).float()
        return logits, value[..., 0]


def load_flax_params(params) -> Dict[str, torch.Tensor]:
    """A state_dict for :class:`ActorCritic` from the flax ActorCritic's
    parameters as numpy arrays (``{'params': {...}}`` or the inner dict):
    ``torso0/{w0,w1,w2,bias}`` as they are (mlp), or the conv kernels
    ``conv1``/``Conv_0``/``Conv_1`` (kh, kw, in, out) as torch's (out, in,
    kh, kw) with their biases and ``conv1_bias`` (pixels torsos); and the
    ``torso``, ``pi`` and ``v`` Dense layers' ``kernel`` (in, out)
    transposed to torch's ``weight`` (out, in)."""
    p = params.get("params", params)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    if "torso0" in p:
        sd = {f"torso0.{k}": t(p["torso0"][k])
              for k in ("w0", "w1", "w2", "bias")}
    else:
        sd = {"conv1.weight": t(p["conv1"]["kernel"]).permute(3, 2, 0, 1),
              "conv1_bias": t(p["conv1_bias"])}
        for name in ("Conv_0", "Conv_1"):
            sd[f"{name}.weight"] = t(p[name]["kernel"]).permute(3, 2, 0, 1)
            sd[f"{name}.bias"] = t(p[name]["bias"])
    for name in ("torso", "pi", "v"):
        sd[f"{name}.weight"] = t(p[name]["kernel"]).T
        sd[f"{name}.bias"] = t(p[name]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
