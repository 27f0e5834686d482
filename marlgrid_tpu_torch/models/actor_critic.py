"""Actor-critic families (PyTorch port): the feedforward ``ActorCritic`` and
the recurrent ``RecurrentActorCritic``, each with the mlp torso on 'encode'
observations or one of the two pixels torsos on image observations.

Counterpart of ``marlgrid_tpu/models/actor_critic.py``: the mlp torso is
``OneHotEmbed`` on feature-major codes, through the fused one-hot embed
(kernels K2f and K2b on the card) or, with ``MARLGRID_TPU_EMBED_V2=1``, the
plane-major embed (K5f and K5b); the 'cnn_s2d' and 'cnn_image' torsos are
``_conv_torso``'s conv stacks on uint8 images (the convolutions go to
``F.conv2d``, as the JAX package leaves them to XLA). The feedforward family
puts a dense torso layer and the policy/value heads on the torso; the
recurrent one puts a gate-fused GRU or LSTM cell between them. Activations
run in the compute dtype (bf16 by default, or float32); the heads' outputs
are cast to float32. Parameters are float32 and carry the flax parameters'
names, so :func:`load_flax_params` moves JAX weights across. The encode
'cnn' torso waits for the rest of ROADMAP Slice C.
"""
from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core import constants as C
from ..device import resolve
from ..ops import embed as embed_op
from ..ops import embed2 as embed2_op

_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2
#: set (to any non-empty value) to route OneHotEmbed through the
#: plane-major embed, as the JAX package's OneHotEmbed reads it
EMBED_V2_VAR = "MARLGRID_TPU_EMBED_V2"


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

    ``plane_major``: which of the two embeds computes the layer; None (the
    default) reads ``MARLGRID_TPU_EMBED_V2`` when the module is built, as
    the JAX package does. False: ``ops/embed.py`` on the packed table, in
    the compute dtype (K2f/K2b on the card). True: ``ops/embed2.py`` on the
    three tables as they are, its float32 output cast to the compute dtype
    (K5f/K5b on the card; the tables are read as bf16 whatever their
    dtype). The bias is added in the compute dtype either way. Both are
    differentiable in the three tables on both devices, and the parameters
    are the same, so either route loads the same weights.
    """

    def __init__(self, cells: int, features: int, dtype=torch.bfloat16,
                 palettes=None, generator=None, plane_major=None):
        super().__init__()
        self.cells, self.features, self.dtype = cells, features, dtype
        self.widths, self.values = embed_op.vocab(palettes)
        self.plane_major = (bool(os.environ.get(EMBED_V2_VAR))
                            if plane_major is None else bool(plane_major))
        for i, n in enumerate(self.widths):
            w = torch.empty(cells * n, features)
            lecun_normal_(w, cells * n, generator)
            setattr(self, f"w{i}", nn.Parameter(w))
        self.bias = nn.Parameter(torch.zeros(features))

    def tables(self):
        """The three (cells, n_p, H) per-plane tables (views of w0/w1/w2)."""
        return tuple(getattr(self, f"w{i}").reshape(self.cells, n,
                                                    self.features)
                     for i, n in enumerate(self.widths))

    def table(self) -> torch.Tensor:
        """(cells, sum(widths), H) packed table of the three planes."""
        return embed_op.pack_weights(*self.tables())

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        lead, (Fd, S) = obs.shape[:-2], obs.shape[-2:]
        x = obs.reshape((-1, Fd, S))
        if self.plane_major:
            out = embed2_op.onehot_embed2(x, *self.tables(), self.widths,
                                          self.values)
        else:
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


def _dense(lin: nn.Linear, x, dtype):
    """flax's ``Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x, lin.weight.to(dtype), b)


def _linear(in_features: int, out_features: int, generator, bias=True):
    """A Dense layer initialized as flax initializes it: a lecun-normal
    kernel drawn from ``generator`` and a zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(lin.weight, in_features, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class _Torso(nn.Module):
    """What both families share: the stateless torso (mlp ``OneHotEmbed``,
    or a pixels conv stack with the 'rich' extras after it), the dense torso
    layer and the policy/value heads on its output."""

    def _build_torso(self, cfg, view_size: int, generator, tile_size: int,
                     aux_dim: int) -> int:
        """Register the torso's layers; returns the width of its output."""
        if cfg.torso == "cnn":
            raise NotImplementedError(
                "torso='cnn' (one-hot planes and 3x3 convs on encode obs) "
                "is left over from ROADMAP Slice C (pixels)")
        if cfg.torso not in ("mlp",) + tuple(_CONVS):
            raise ValueError(f"unknown torso {cfg.torso!r}")
        if aux_dim and cfg.torso == "mlp":
            raise ValueError("aux features go with the pixels torsos")
        self.dtype = cfg.dtype
        self.kind = cfg.torso
        if cfg.torso == "mlp":
            self.torso0 = OneHotEmbed(view_size * view_size, cfg.hidden,
                                      cfg.dtype, cfg.embed_palettes,
                                      generator)
            return cfg.hidden
        side = view_size * tile_size
        c_in = 3
        if cfg.torso == "cnn_s2d":
            side, c_in = side // 4, 48
        for name, c_out, k, stride in (_CONVS[cfg.torso],) + _CONV_TAIL:
            conv = nn.Conv2d(c_in, c_out, k, stride, bias=name != "conv1")
            lecun_normal_(conv.weight, c_in * k * k, generator)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)
            setattr(self, name, conv)
            side, c_in = -(-side // stride), c_out
        self.conv1_bias = nn.Parameter(torch.zeros(32))
        return side * side * c_in + aux_dim

    def _build_heads(self, width: int, hidden: int, generator):
        self.torso = _linear(width, hidden, generator)
        self.pi = _linear(hidden, C.N_ACTIONS, generator)
        self.v = _linear(hidden, 1, generator)

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

    def features(self, obs: torch.Tensor, aux=None):
        """The per-step stateless torso: ReLU of the embed (mlp), or the
        flattened conv stack with ``aux`` concatenated after it."""
        if self.kind == "mlp":
            if aux is not None:
                raise ValueError("aux features go with the pixels torsos")
            return F.relu(self.torso0(obs))
        x = self._conv_torso(obs)
        if aux is not None:
            x = torch.cat([x, aux.to(self.dtype)], dim=-1)
        return x

    def heads(self, x):
        """The dense torso layer, then (logits float32, value float32)."""
        x = F.relu(_dense(self.torso, x, self.dtype))
        logits = _dense(self.pi, x, self.dtype).float()
        value = _dense(self.v, x, self.dtype).float()
        return logits, value[..., 0]


class ActorCritic(_Torso):
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
            raise ValueError(f"rnn={cfg.rnn!r}: the recurrent family is "
                             f"RecurrentActorCritic")
        dev = resolve(device)
        width = self._build_torso(cfg, view_size, generator, tile_size,
                                  aux_dim)
        self._build_heads(width, cfg.hidden, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, aux=None):
        return self.heads(self.features(obs, aux))


class FusedGRUCell(nn.Module):
    """The GRU cell with gate-fused matmuls, flax's ``FusedGRUCell``:
    ``i`` the biased (in, 3H) input projection, ``h`` the unbiased (H, 3H)
    recurrent one, ``hn_bias`` the candidate's recurrent bias. Gates r, z, n:
    ``n = tanh(gi_n + r * (gh_n + hn_bias))``, ``h' = (1 - z) * n + z * h``,
    every step in ``dtype``. ``forward(carry, x) -> (h', h')``."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.i = _linear(in_features, 3 * features, generator)
        self.h = _linear(features, 3 * features, generator, bias=False)
        self.hn_bias = nn.Parameter(torch.zeros(features))

    def forward(self, carry, x):
        H, dt = self.features, self.dtype
        gi = _dense(self.i, x, dt)
        gh = _dense(self.h, carry, dt)
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:]
                       + r * (gh[..., 2 * H:] + self.hn_bias.to(dt)))
        new_h = (1.0 - z) * n + z * carry
        return new_h, new_h


class FusedLSTMCell(nn.Module):
    """The LSTM cell with gate-fused matmuls, flax's ``FusedLSTMCell``:
    ``i`` the biased (in, 4H) input projection, ``h`` the unbiased (H, 4H)
    recurrent one; gates i, f, g, o; carry ``(c, h)``, every step in
    ``dtype``. ``forward((c, h), x) -> ((c', h'), h')``."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.i = _linear(in_features, 4 * features, generator)
        self.h = _linear(features, 4 * features, generator, bias=False)

    def forward(self, carry, x):
        H, dt = self.features, self.dtype
        c, h = carry
        z = _dense(self.i, x, dt) + _dense(self.h, h, dt)
        i = torch.sigmoid(z[..., :H])
        f = torch.sigmoid(z[..., H:2 * H])
        g = torch.tanh(z[..., 2 * H:3 * H])
        o = torch.sigmoid(z[..., 3 * H:])
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class RecurrentActorCritic(_Torso):
    """The memory-equipped policy: torso -> GRU/LSTM cell -> heads, one
    timestep per call: ``forward(obs, carry, aux=None) -> (logits, value,
    carry')``.

    The torso is :class:`ActorCritic`'s (mlp on feature-major codes, or a
    pixels torso on row-major uint8 POVs with the 'rich' ``aux`` after the
    flatten); ``cfg.rnn`` picks :class:`FusedGRUCell` or
    :class:`FusedLSTMCell`, whose input is the torso's output; the dense
    torso layer and the heads read the cell's output. ``features``,
    ``cell_step`` and ``heads`` are the three stages apart, so the PPO
    update runs the stateless two over all timesteps in one batch and loops
    only the cell. The carry's leaves are ``(..., hidden)`` in ``cfg.dtype``
    (an LSTM carry is the pair (c, h)); resetting it at episode boundaries
    is the caller's job. Weights are initialized as flax initializes them,
    drawn from ``generator``.
    """

    def __init__(self, cfg, view_size: int, generator=None, device="cuda",
                 tile_size: int = 8, aux_dim: int = 0):
        super().__init__()
        if cfg.rnn not in ("gru", "lstm"):
            raise ValueError(f"rnn={cfg.rnn!r}: the recurrent cell is 'gru' "
                             f"or 'lstm'")
        dev = resolve(device)
        width = self._build_torso(cfg, view_size, generator, tile_size,
                                  aux_dim)
        cell = FusedLSTMCell if cfg.rnn == "lstm" else FusedGRUCell
        self.cell = cell(width, cfg.hidden, cfg.dtype, generator)
        self._build_heads(cfg.hidden, cfg.hidden, generator)
        self.rnn, self.hidden = cfg.rnn, cfg.hidden
        self.to(dev)

    def cell_step(self, x, carry):
        """One recurrent step: (features_t, carry) -> (carry', y_t)."""
        return self.cell(carry, x)

    def forward(self, obs: torch.Tensor, carry, aux=None):
        carry, y = self.cell_step(self.features(obs, aux), carry)
        logits, value = self.heads(y)
        return logits, value, carry

    def initial_carry(self, lead):
        """A zero carry for the ``lead`` sample dims (e.g. (N, B)), in the
        compute dtype on the net's device; an LSTM's is two distinct
        tensors."""
        z = torch.zeros(tuple(lead) + (self.hidden,), dtype=self.dtype,
                        device=self.torso.weight.device)
        return (z, torch.zeros_like(z)) if self.rnn == "lstm" else z


def load_flax_params(params) -> Dict[str, torch.Tensor]:
    """A state_dict for :class:`ActorCritic` or :class:`RecurrentActorCritic`
    from the flax model's parameters as numpy arrays (``{'params': {...}}``
    or the inner dict): ``torso0/{w0,w1,w2,bias}`` as they are (mlp), or the
    conv kernels ``conv1``/``Conv_0``/``Conv_1`` (kh, kw, in, out) as torch's
    (out, in, kh, kw) with their biases and ``conv1_bias`` (pixels torsos);
    the recurrent cell's ``cell/{i,h}`` kernels transposed, ``cell/i/bias``
    and the GRU's ``cell/hn_bias``; and the ``torso``, ``pi`` and ``v``
    Dense layers' ``kernel`` (in, out) transposed to torch's ``weight``
    (out, in)."""
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
    if "cell" in p:
        cell = p["cell"]
        sd["cell.i.weight"] = t(cell["i"]["kernel"]).T
        sd["cell.i.bias"] = t(cell["i"]["bias"])
        sd["cell.h.weight"] = t(cell["h"]["kernel"]).T
        if "hn_bias" in cell:
            sd["cell.hn_bias"] = t(cell["hn_bias"])
    for name in ("torso", "pi", "v"):
        sd[f"{name}.weight"] = t(p[name]["kernel"]).T
        sd[f"{name}.bias"] = t(p[name]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
