"""The trajectory transpose (kernel K4's plain version,
``marlgrid_tpu_torch/ops/transpose.py::transpose_traj``) against the JAX
package's ``transpose_traj`` on the CPU and against its Pallas kernel body
``_tkernel4`` run in interpret mode, bit-exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from marlgrid_tpu.ops import transpose as JT
from marlgrid_tpu_torch.ops import transpose as T

SHAPES = [(8, 4, 147, 64), (5, 3, 75, 30), (2, 1, 7, 256)]


def _x(shape, dtype, seed):
    rs = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rs.integers(0, 256, shape).astype(np.uint8)
    return rs.integers(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int64).astype(
        np.int32)


@functools.partial(jax.jit, static_argnames=("bb",))
def _pallas_t4_interpret(x, bb):
    """``_pallas_t4``'s pallas_call as the JAX package builds it, in
    interpret mode (its VMEM block specs are accepted on the CPU)."""
    Tn, N, F, B = x.shape
    return pl.pallas_call(
        JT._tkernel4,
        grid=(N, Tn, B // bb),
        in_specs=[pl.BlockSpec((1, 1, F, bb), lambda n, t, i: (t, n, 0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, bb, F), lambda n, t, i: (n, t, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, Tn, B, F), x.dtype),
        interpret=True,
    )(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_plain_matches_jax(shape, dtype):
    x = _x(shape, dtype, seed=sum(shape))
    want = np.asarray(JT.transpose_traj(jnp.asarray(x)))
    got = T.transpose_traj(torch.as_tensor(x))
    assert T.transpose_traj.launches == 0
    assert got.is_contiguous() and got.dtype == torch.as_tensor(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (shape[1], shape[0], shape[3], shape[2])


@pytest.mark.parametrize("shape,bb", [((4, 2, 75, 64), 32),
                                      ((3, 4, 147, 128), 128)])
def test_plain_matches_pallas_kernel(shape, bb):
    x = _x(shape, np.uint8, seed=7)
    want = np.asarray(_pallas_t4_interpret(jnp.asarray(x), bb))
    got = T.transpose_traj_plain(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_raises_by_name():
    """A tensor on a device that neither the plain version nor the kernel
    serves raises, naming the function."""
    with pytest.raises(ValueError, match="transpose_traj"):
        T.transpose_traj(torch.zeros((2, 3, 4, 5), device="meta"))
