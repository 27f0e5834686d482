"""Hand-written Hopper kernels (CUDA C++ under csrc/), each with its plain
PyTorch version beside it."""
from .transpose import transpose_bk  # noqa: F401


def kernel_wrappers():
    """Name -> wrapper of every kernel of the port (the probe K6 included);
    each wrapper counts its launches in ``.launches``."""
    from ..probes import embed_roofline
    from . import embed, embed2, sprite, threefry, transpose

    return {"transpose_bk": transpose.transpose_bk,
            "onehot_embed_fwd": embed.onehot_embed,
            "onehot_embed_bwd": embed.onehot_embed_bwd,
            "compose_image_b": sprite.compose_image_b,
            "onehot_embed2_fwd": embed2.onehot_embed2,
            "onehot_embed2_bwd": embed2.onehot_embed2_bwd,
            "transpose_traj": transpose.transpose_traj,
            "embed_variant": embed_roofline.fwd_variant,
            "threefry2x32": threefry.threefry2x32}
