"""marlgrid-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``marlgrid_tpu``, laid out module for module like
it. The JAX package is the reference: env transitions, observations and
rewards are bit-equal to it under the same key (``core/rng.py`` ports JAX's
threefry), and each TPU kernel becomes a hand-written CUDA kernel
(``csrc/``) with a plain PyTorch version beside it. Entry points run on the
card unless the caller passes ``device="cpu"``.

Public surface, as the JAX package's:
- ``marlgrid_tpu_torch.envs``: the scenario registry, ``make``,
  ``register_marl_env``, ``env_from_config``, the reference's env ids;
- ``marlgrid_tpu_torch.wrapper.MultiGridEnv``: the gym-classic host API;
- ``marlgrid_tpu_torch.vector.VectorEnv``: the batched functional API;
- ``marlgrid_tpu_torch.agents``: ``GridAgentInterface``,
  ``IndependentLearners``;
- ``marlgrid_tpu_torch.objects``: the ``WorldObj`` classes and ``COLORS``;
- ``marlgrid_tpu_torch.utils.video.GridRecorder``: episode video export;
- ``marlgrid_tpu_torch.parallel``: PPO training and evaluation.
"""

from .core.state import EnvParams, EnvState, default_agent_colors  # noqa: F401

__version__ = "0.1.0"

# Importing the package registers the named envs, as the reference's
# ``marlgrid/__init__.py`` does at import.
from . import envs  # noqa: E402,F401
