"""The trajectory transpose (kernel K4's plain version,
``marlgrid_tpu_torch/ops/transpose.py::transpose_traj``) against the JAX
package's ``transpose_traj`` on the CPU and against its Pallas kernel body
``_tkernel4`` run in interpret mode, bit-exact; and the CUDA kernel's walk
over (plane, column tile) units, emulated in numpy from the wrapper's
``traj_plan``, against the JAX package's ``transpose_traj``."""
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

# the last two: a B off the 16-byte vector with full tiles elsewhere, and
# T * N = 75,000 planes, past the old kernel's 65,535-plane grid
SHAPES = [(8, 4, 147, 64), (5, 3, 75, 30), (2, 1, 7, 256), (4, 2, 75, 4100),
          (300, 250, 3, 20)]


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


def _kernel_walk(x, aligned):
    """``csrc/transpose.cu::transpose_traj_kernel``'s arithmetic in numpy:
    each (plane, column tile) unit fills its shared chunk (the 16-byte
    vector path where the tile is full and ``aligned``, else the element
    path) and copies it to its contiguous run of the flat output."""
    Tn, N, F, B = x.shape
    plan = T.traj_plan(F, B, x.itemsize)
    per_vec = 16 // x.itemsize
    vecs, S = 1 << plan["log_vecs"], plan["cols"]
    xf = x.reshape(-1)
    y = np.zeros(x.size, x.dtype)
    for u in range(Tn * N * plan["tiles"]):
        plane, j = divmod(u, plan["tiles"])
        t, n = divmod(plane, N)
        b0 = j * S
        w = min(S, B - b0)
        xs = plane * F * B + b0
        yc = (n * Tn + t) * F * B + b0 * F
        chunk = np.zeros(S * F, x.dtype)
        if aligned and w == S:
            v = np.arange(F * vecs)
            f, c = v >> plan["log_vecs"], v & (vecs - 1)
            for i in range(per_vec):
                chunk[(c * per_vec + i) * F + f] = xf[xs + f * B
                                                      + c * per_vec + i]
        else:
            e = np.arange(F * w)
            f, s = e // w, e % w
            chunk[s * F + f] = xf[xs + f * B + s]
        y[yc:yc + w * F] = chunk[:w * F]
    return y.reshape(N, Tn, B, F)


@pytest.mark.parametrize("shape", [(3, 2, 147, 256), (2, 3, 75, 300),
                                   (2, 2, 400, 1008), (1, 2, 3100, 80),
                                   (3, 2, 33, 31)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("aligned", [True, False])
def test_kernel_walk_matches_jax(shape, dtype, aligned):
    """Every output element is written once, from the right input element,
    by the kernel's units, on both of its paths, at full and ragged tiles
    and at each tile width the plan picks (8, 4 and 1 vectors a row)."""
    x = _x(shape, dtype, seed=sum(shape) + 1)
    want = np.asarray(JT.transpose_traj(jnp.asarray(x)))
    np.testing.assert_array_equal(_kernel_walk(x, aligned), want)


def test_traj_plan():
    """The trainers' trajectories take 128-byte tile rows (an 18,816-byte
    chunk at F = 147); wider F halves the row; an F whose 16-byte column
    tile passes 227 KB of shared memory is refused by name."""
    assert T.traj_plan(147, 4096, 1) == dict(log_vecs=3, cols=128,
                                             smem=18816, tiles=32)
    assert T.traj_plan(147, 4096, 4) == dict(log_vecs=3, cols=32,
                                             smem=18816, tiles=128)
    assert T.traj_plan(75, 4100, 1)["tiles"] == 33
    assert T.traj_plan(400, 1008, 1)["log_vecs"] == 2
    assert T.traj_plan(14528, 8, 4)["smem"] == 232448
    with pytest.raises(ValueError, match="transpose_traj"):
        T.traj_plan(14529, 8, 1)
