"""Packaging (reference analog: marlgrid's setup.py, SURVEY §2.1)."""
from setuptools import find_packages, setup

setup(
    name="marlgrid-tpu",
    version="0.1.0",
    description=("TPU-native multi-agent gridworld RL framework "
                 "(marlgrid capabilities, JAX/XLA re-design)"),
    packages=find_packages(include=["marlgrid_tpu", "marlgrid_tpu.*",
                                    "marlgrid_tpu_torch",
                                    "marlgrid_tpu_torch.*"]),
    # the PyTorch port's CUDA sources, compiled by nvcc at first use
    package_data={"marlgrid_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "flax",
        "optax",
        "orbax-checkpoint",
        "gymnasium",
        "imageio",
    ],
    extras_require={"test": ["pytest", "hypothesis", "chex"],
                    "torch": ["torch"]},
)
