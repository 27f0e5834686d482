"""The yardstick's peaks and the least time of each kernel's work, frozen
from ``chip_smoke.py`` (``_bound``, ``_least_route``, ``time_k2f``,
``time_k2b``, ``time_k3`` and K1's entry), so that a roofline share reads
the same work whatever implements it.

A kernel's work per call comes from the cell's configuration and traffic
(its shapes: batch, length, agents, view, hidden width, the encode
palette's width), never from the program. The least time of a call is
``max(bytes / 3.35 TB/s, ops / peak)``, each input byte read once and each
output byte written once; the embeds' operations are the lesser of two
routes, float32 adds at 67 TFLOP/s or the dense bf16 one-hot product at
989 TFLOP/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense

#: the kernels' function names on the card (csrc/*.cu); K2b is two kernels
KERNELS = {
    "k1": ("transpose_bk_kernel",),
    "k2f": ("onehot_embed_fwd_mma_kernel",),
    "k2b": ("onehot_embed_bwd_mma_kernel", "onehot_embed_bwd_reduce_kernel"),
    "k3": ("compose_kernel",),
}
#: the port's kernel wrappers whose ``.launches`` count each kernel
WRAPPERS = {"k1": "transpose_bk", "k2f": "onehot_embed_fwd",
            "k2b": "onehot_embed_bwd", "k3": "compose_image_b"}


def bound_s(nbytes: float, ops: float = 0.0,
            ops_per_s: float = F32_OPS_PER_S) -> float:
    """``chip_smoke.py::_bound``: the larger of the bytes at the memory
    rate and the operations at ``ops_per_s``, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def least_route_s(nbytes: float, adds: float, mma: float) -> float:
    """``chip_smoke.py::_least_route`` then ``_bound``: the operations are
    the lesser route, ``adds`` float32 adds or a dense bf16 product of
    ``mma`` operations."""
    if mma / BF16_OPS_PER_S < adds / F32_OPS_PER_S:
        return bound_s(nbytes, mma, BF16_OPS_PER_S)
    return bound_s(nbytes, adds)


def k1_s(B: int, K: int) -> float:
    """K1, (B, K) int32 -> (K, B): each element read and written once."""
    return bound_s(2 * B * K * 4)


def k2f_s(R: int, F: int, S: int, cells: int, cw: int, H: int) -> float:
    """K2f, codes (R, F, S) uint8 by the (cells, cw, H) bf16 table -> (R,
    S, H) bf16; every code in the palette selects a row (F * H adds a
    sample), or the dense product over cells * cw rows."""
    return least_route_s(R * F * S + cells * cw * H * 2 + R * S * H * 2,
                         R * F * S * H, 2 * R * S * cells * cw * H)


def k2b_s(R: int, F: int, S: int, cells: int, cw: int, H: int) -> float:
    """K2b, codes (R, F, S) and dout (R, S, H) bf16 -> the (cells, cw, H)
    float32 table gradient; the same routes as K2f."""
    return least_route_s(R * F * S + R * S * H * 2 + cells * cw * H * 4,
                         R * F * S * H, 2 * R * S * cells * cw * H)


def k3_s(images: int, view: int, tile: int) -> float:
    """K3, three (N, vs, vs, B) int32 id planes -> ``images`` uint8 images
    of (vs * tile)^2 * 3 bytes. The float multiplies of agent-covered bytes
    (at most 3 a byte) are far under the bytes' time at any coverage, so
    the bytes bound it."""
    return bound_s(images * ((view * tile) ** 2 * 3 + 3 * view * view * 4))


def block_size(B: int, T: int, N: int) -> int:
    """The encode update's env-chunk width (``ppo.block_size``): halve B
    while the half stays >= 128 and N * T * (B // c) stays <= 8192."""
    c = B
    while c % 2 == 0 and c // 2 >= 128 and N * T * (B // c) * 2 <= 8192:
        c //= 2
    return c


def calls(shape: dict) -> dict:
    """Kernel -> ``[(least seconds of one call, calls a step)]`` for one
    call of the cell's timed path. ``shape``: ``loop`` ('train' or
    'rollout'), ``B``, ``T``, ``N`` agents, ``view``, ``tile``, ``obs``
    ('encode' or 'image'), ``hidden``, ``cw`` (the encode palette's codes
    a cell, summed over the three planes), ``epochs``, ``minibatches``.

    Per call: the rollout renders T + 1 observations of B envs (K1, and
    K2f for the mlp policy's forward on the encode codes, or K3 for the
    images). A train step adds the update: ``epochs * minibatches``
    minibatches, each an encode forward and backward over its (G / M, F,
    c) blocks (K2f, K2b), or, on images, a re-render of its T * B / M envs
    (K1, K3)."""
    B, T, N, vs = shape["B"], shape["T"], shape["N"], shape["view"]
    K, F, cells = N * vs * vs, 3 * vs * vs, vs * vs
    steps = shape["epochs"] * shape["minibatches"]
    out = {"k1": [(k1_s(B, K), T + 1)]}
    if shape["obs"] == "encode":
        H, cw = shape["hidden"], shape["cw"]
        out["k2f"] = [(k2f_s(N, F, B, cells, cw, H), T + 1)]
        if shape["loop"] == "train":
            c = block_size(B, T, N)
            R = N * T * (B // c) // shape["minibatches"]
            out["k2f"].append((k2f_s(R, F, c, cells, cw, H), steps))
            out["k2b"] = [(k2b_s(R, F, c, cells, cw, H), steps)]
    else:
        out["k3"] = [(k3_s(N * B, vs, shape["tile"]), T + 1)]
        if shape["loop"] == "train":
            S = T * B // shape["minibatches"]
            out["k1"].append((k1_s(S, K), steps))
            out["k3"].append((k3_s(N * S, vs, shape["tile"]), steps))
    return out


def share(trace, shape: dict, kernel: str, launches_per_call: float):
    """``kernel``'s roofline share in % over the traced calls: the least
    time of its work in those calls over its traced device time. None where
    the cell's path does not run it, or where the launches the program
    counted a call, or the traced launches, are not what the shapes say (a
    later program that calls it otherwise: its work is then not known
    here)."""
    work = calls(shape).get(kernel)
    if not work:
        return None
    per_call = sum(n for _, n in work)
    if round(launches_per_call) != per_call:
        return None
    secs, n = 0.0, 0
    for base in KERNELS[kernel]:
        s, c = trace.kernel_s(base)
        secs, n = secs + s, max(n, c)
    if n != per_call * trace.calls or secs <= 0:
        return None
    least = sum(t * k for t, k in work) * trace.calls
    return 100.0 * least / secs
