"""The model operations of a call, frozen: the whole step's work against the
card's bf16 peak (``train.mfu``, ``rollout.mfu``).

Per sample (one agent's observation) the policy's forward counts the embed
as its gather-sum adds (one add of an H-wide row per code), and every dense,
conv and GRU product as 2 x its multiply-adds. A train call is the
rollout's T + 1 forwards of N * B samples plus ``epochs`` passes of the
update over all T * N * B samples, each forward and backward (backward as
2 x forward); an acting call is the rollout alone. Nothing recomputed is
counted: the image path's re-render is not a model operation.
"""
from __future__ import annotations

N_ACTIONS = 7
#: the pixels torsos' conv stacks: (out channels, kernel, stride)
CONVS = {"cnn_s2d": ((32, 2, 1), (64, 4, 2), (64, 3, 1)),
         "cnn_image": ((32, 8, 4), (64, 4, 2), (64, 3, 1))}


def forward_ops(shape: dict) -> float:
    """Operations of one sample's forward. ``shape``: ``view``, ``tile``,
    ``obs``, ``torso`` ('mlp', 'cnn_s2d' or 'cnn_image'), ``hidden``,
    ``rnn`` ('' or 'gru')."""
    vs, H = shape["view"], shape["hidden"]
    if shape["torso"] == "mlp":
        ops = 3 * vs * vs * H
        width = H
    else:
        side, c_in = vs * shape["tile"], 3
        if shape["torso"] == "cnn_s2d":
            side, c_in = side // 4, 48
        ops = 0
        for c_out, k, stride in CONVS[shape["torso"]]:
            side = -(-side // stride)
            ops += 2 * side * side * c_out * k * k * c_in
            c_in = c_out
        width = side * side * c_in
    if shape["rnn"] == "gru":
        ops += 2 * width * 3 * H + 2 * H * 3 * H
        width = H
    elif shape["rnn"]:
        raise ValueError(f"no operation count for rnn={shape['rnn']!r}")
    return ops + 2 * width * H + 2 * H * N_ACTIONS + 2 * H


def call_ops(shape: dict) -> float:
    """Operations of one call of the cell's loop (see the module
    docstring); ``shape`` as :func:`forward_ops` and
    ``roofline.calls`` take it."""
    f = forward_ops(shape)
    samples = shape["N"] * shape["B"]
    ops = (shape["T"] + 1) * samples * f
    if shape["loop"] == "train":
        ops += shape["epochs"] * shape["T"] * samples * 3 * f
    return ops
