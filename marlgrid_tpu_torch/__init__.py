"""marlgrid-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``marlgrid_tpu``, laid out module for module like
it. The JAX package is the reference: env transitions, observations and
rewards are bit-equal to it under the same key (``core/rng.py`` ports JAX's
threefry), and each TPU kernel becomes a hand-written CUDA kernel
(``csrc/``) with a plain PyTorch version beside it. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
