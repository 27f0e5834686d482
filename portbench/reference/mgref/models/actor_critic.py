"""Actor-critic families, frozen from the port's
``models/actor_critic.py``: the feedforward ``ActorCritic`` and the
recurrent ``RecurrentActorCritic``, each with the mlp torso on 'encode'
observations (``OneHotEmbed`` through the plain embed of ``ops/embed.py``)
or one of the two pixels torsos on image observations; the feedforward
family also takes the 'cnn' torso. Activations run in the compute dtype;
the heads' outputs are cast to float32; parameters are float32 under the
port's names. ``quant`` (None unless the control sets it) rounds every
operand of the policy's products: the embed's table, each dense layer's
input and kernel, each conv's input and kernel.
"""
from __future__ import annotations

import math

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
    #: the control's rounding of each operand of a product (None: none)
    quant = None

    """First layer: per-cell symbolic codes -> hidden, on feature-major
    codes ``(..., 3*cells, S)`` -> ``(..., S, features)``.

    ``palettes``: compact per-scenario code vocabularies
    ((types…), (colors…), (states…)) from ``core/obs.py::encode_palettes``;
    None = the full static vocabularies (state codes clipped at 19).

    ``plane_major`` is accepted and ignored: the reference has one embed.
    """

    def __init__(self, cells: int, features: int, dtype=torch.bfloat16,
                 palettes=None, generator=None, plane_major=None):
        super().__init__()
        self.cells, self.features, self.dtype = cells, features, dtype
        self.widths, self.values = embed_op.vocab(palettes)
        self.plane_major = False
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

    def forward(self, obs: torch.Tensor, cols: slice = None) -> torch.Tensor:
        """``cols``: the columns of the bias that the tables hold (a model
        rank's shard of the tables is H / n_model wide, its bias whole);
        None: all of them."""
        lead, (Fd, S) = obs.shape[:-2], obs.shape[-2:]
        x = obs.reshape((-1, Fd, S))
        table = self.table()
        if self.quant is not None:
            table = self.quant(table)
        out = embed_op.onehot_embed(x, table, self.widths, self.values,
                                    self.dtype)
        out = out.reshape(lead + out.shape[1:]).to(self.dtype)
        bias = self.bias if cols is None else self.bias[cols]
        return out + bias.to(self.dtype)


def onehot_features(obs: torch.Tensor, dtype) -> torch.Tensor:
    """(..., vs, vs, 3) int codes -> (..., vs, vs, 42) one-hot planes in
    ``dtype``: type (``N_TYPES + 1``), color (``N_COLORS + 1``), and state
    clipped to ``0..19``, in that channel order (the JAX
    ``onehot_features``)."""
    nt, nc, ns = embed_op.WIDTHS
    dev = obs.device
    t = obs[..., 0:1] == torch.arange(nt, device=dev)
    c = obs[..., 1:2] == torch.arange(nc, device=dev)
    s = obs[..., 2:3].clamp(0, ns - 1) == torch.arange(ns, device=dev)
    return torch.cat([t, c, s], dim=-1).to(dtype)


def _same_pad(size: int, k: int, stride: int):
    """flax/XLA 'SAME' padding of one spatial axis: (low, high), the odd
    pixel of an uneven total on the high side."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


#: the pixels torsos' conv stack: (name, out channels, kernel, stride);
#: conv1's kernel and stride depend on the torso
_CONVS = {"cnn_s2d": ("conv1", 32, 2, 1), "cnn_image": ("conv1", 32, 8, 4)}
_CONV_TAIL = (("Conv_0", 64, 4, 2), ("Conv_1", 64, 3, 1))


def _dense(lin: nn.Linear, x, dtype, quant=None):
    """flax's ``Dense(dtype=...)``: input, kernel and bias in ``dtype``;
    ``quant`` rounds the input and the kernel first (the control)."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    w = lin.weight.to(dtype)
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, b)


def _linear(in_features: int, out_features: int, generator, bias=True):
    """A Dense layer initialized as flax initializes it: a lecun-normal
    kernel drawn from ``generator`` and a zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(lin.weight, in_features, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class _Torso(nn.Module):
    #: the control's rounding of each operand of a product (None: none)
    quant = None

    """What both families share: the stateless torso (mlp ``OneHotEmbed``,
    the 'cnn' stack on one-hot planes, or a pixels conv stack with the
    'rich' extras after it), the dense torso layer and the policy/value
    heads on its output."""

    def _build_torso(self, cfg, view_size: int, generator, tile_size: int,
                     aux_dim: int, encode: bool = False) -> int:
        """Register the torso's layers; returns the width of its output.
        ``encode``: a pixels torso reads (vs, vs, 3) encode codes, not
        rendered images."""
        if cfg.torso not in ("mlp", "cnn") + tuple(_CONVS):
            raise ValueError(f"unknown torso {cfg.torso!r}")
        if aux_dim and cfg.torso in ("mlp", "cnn"):
            raise ValueError("aux features go with the pixels torsos")
        self.dtype = cfg.dtype
        self.kind = cfg.torso
        if cfg.torso == "mlp":
            self.torso0 = OneHotEmbed(view_size * view_size, cfg.hidden,
                                      cfg.dtype, cfg.embed_palettes,
                                      generator)
            return cfg.hidden
        if cfg.torso == "cnn":
            side, c_in = view_size, sum(embed_op.WIDTHS)
            layers = tuple((f"Conv_{i}", ch, 3, 1)
                           for i, ch in enumerate(cfg.channels))
        else:
            side, c_in = view_size, 3
            if not encode:
                side *= tile_size
                if cfg.torso == "cnn_s2d":
                    side, c_in = side // 4, 48
            layers = (_CONVS[cfg.torso],) + _CONV_TAIL
        for name, c_out, k, stride in layers:
            conv = nn.Conv2d(c_in, c_out, k, stride, bias=name != "conv1")
            lecun_normal_(conv.weight, c_in * k * k, generator)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)
            setattr(self, name, conv)
            side, c_in = -(-side // stride), c_out
        self.convs = tuple(name for name, *_ in layers)
        if cfg.torso != "cnn":
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
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        b = None if conv.bias is None else conv.bias.to(self.dtype)
        if (ht, wl) != (hb, wr):
            x = F.pad(x, (wl, wr, ht, hb))
            ht = wl = 0
        return F.conv2d(x, w, b, stride=stride, padding=(ht, wl))

    def _conv_stack(self, x):
        """(..., h, w, c) -> the conv stack flattened in (h, w, c) order,
        as flax flattens it: 'cnn' is ReLU(conv) per layer; a pixels torso
        is conv1 without bias, ``x / 255 + conv1_bias``, then ReLU(conv)."""
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(
            self.dtype)                        # NCHW, channels-last strides
        for name in self.convs:
            x = self._conv(getattr(self, name), x)
            if name == "conv1":
                x = x / 255.0 + self.conv1_bias.to(self.dtype)[:, None, None]
            x = F.relu(x)
        return x.permute(0, 2, 3, 1).reshape(lead + (-1,))   # (h, w, c)

    def features(self, obs: torch.Tensor, aux=None):
        """The per-step stateless torso: ReLU of the embed (mlp), or the
        flattened conv stack ('cnn': on the one-hot planes of the codes)
        with ``aux`` concatenated after it."""
        if self.kind in ("mlp", "cnn") and aux is not None:
            raise ValueError("aux features go with the pixels torsos")
        if self.kind == "mlp":
            return F.relu(self.torso0(obs))
        if self.kind == "cnn":
            return self._conv_stack(onehot_features(obs, self.dtype))
        x = self._conv_stack(obs)
        if aux is not None:
            x = torch.cat([x, aux.to(self.dtype)], dim=-1)
        return x

    def heads(self, x):
        """The dense torso layer, then (logits float32, value float32)."""
        q = self.quant
        x = F.relu(_dense(self.torso, x, self.dtype, q))
        logits = _dense(self.pi, x, self.dtype, q).float()
        value = _dense(self.v, x, self.dtype, q).float()
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
      after the flatten. With ``encode=True`` either stack reads row-major
      encode codes ``(..., vs, vs, 3)`` instead (int or uint8, cast to the
      compute dtype): its first conv has 3 input channels at side vs.
    - ``torso='cnn'``: row-major encode codes ``(..., vs, vs, 3)`` ->
      :func:`onehot_features` (42 planes: 12 + 10 + 20), then a 3x3
      'SAME' conv with bias and a ReLU for each of ``cfg.channels``
      (flax's ``Conv_0 … Conv_{k-1}``), flattened (h, w, c).

    ``cfg`` is a PPOConfig (hidden, channels, dtype, torso, rnn,
    embed_palettes); ``tile_size`` (the env's view_tile_size), ``encode``
    and ``aux_dim`` size the pixels torsos. Weights are initialized as flax
    initializes them (lecun-normal kernels, fan-in kh*kw*c_in for a conv;
    zero biases), drawn from ``generator``.
    """

    def __init__(self, cfg, view_size: int, generator=None, device="cuda",
                 tile_size: int = 8, aux_dim: int = 0, encode: bool = False):
        super().__init__()
        if cfg.rnn:
            raise ValueError(f"rnn={cfg.rnn!r}: the recurrent family is "
                             f"RecurrentActorCritic")
        dev = resolve(device)
        width = self._build_torso(cfg, view_size, generator, tile_size,
                                  aux_dim, encode)
        self._build_heads(width, cfg.hidden, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, aux=None):
        return self.heads(self.features(obs, aux))


class FusedGRUCell(nn.Module):
    #: the control's rounding of each operand of a product (None: none)
    quant = None

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
        gi = _dense(self.i, x, dt, self.quant)
        gh = _dense(self.h, carry, dt, self.quant)
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
        if cfg.torso == "cnn":
            # the JAX family's setup asserts a pixels torso past the mlp
            raise ValueError("the recurrent family has no 'cnn' torso: "
                             "encode recurrent PPO uses the mlp "
                             "feature-major path")
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
