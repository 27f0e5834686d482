"""The port's threefry2x32 samplers against ``jax.random`` (jax 0.9,
threefry partitionable): bit-equal keys, bits, ints, permutations and
uniforms; categorical equal wherever the sample is not a near-tie."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core import rng as jrng
from marlgrid_tpu_torch.core import rng

SEEDS = [0, 1, 7, 42, 1234, 2 ** 31 - 1]


def _t(key):
    """A JAX uint32 key (array) as the port's int64 key tensor."""
    return torch.as_tensor(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bits(seed):
    jk = jax.random.PRNGKey(seed)
    k = rng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(np.asarray(jk), k.numpy())
    for n in (1, 2, 3, 16):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, n)),
                                      rng.split(k, n).numpy())
    for d in (0, 1, 0xA110, 2 ** 31 + 5):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, d)),
                                      rng.fold_in(k, d).numpy())
    for shape in ((), (5,), (3, 7)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
            rng.random_bits(k, shape).numpy())
    # batched: a vmapped split / fold_in over a batch of keys
    jks = jax.random.split(jk, 6)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.fold_in)(jks, jnp.arange(6))),
        rng.fold_in(_t(jks), torch.arange(6)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.split)(jks)),
        rng.split(_t(jks)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_uniform_permutation(seed):
    jk = jax.random.PRNGKey(seed)
    k = rng.PRNGKey(seed, device="cpu")
    # the reset ranges (interior of a 9..15 board, dirs, doorkey draws) and
    # the step's action range
    for lo, hi, shape in ((1, 8, (4, 100)), (1, 14, (29, 100)),
                          (0, 4, (29,)), (2, 13, ()), (1, 14, ()),
                          (0, 7, (64, 3)), (5, 5, (3,)), (0, 2 ** 20, (9,))):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32)),
            rng.randint(k, shape, lo, hi).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (4, 500))),
        rng.uniform(k, (4, 500)).numpy())
    for n in range(1, 9):
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jk, n)),
            rng.permutation(k, n).numpy())
    jks = jax.random.split(jk, 8)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, 4))(jks)),
        rng.permutation(_t(jks), 4).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_draws(seed):
    """reset_draws / step_draws / autoreset_key of the engine, batched."""
    jks = jax.random.split(jax.random.PRNGKey(seed), 5)
    tks = _t(jks)
    a = jax.vmap(lambda kk: jrng.reset_draws(kk, 12, 100, 1, 11, 1, 11,
                                             13, 13))(jks)
    b = rng.reset_draws(tks, 12, 100, 1, 11, 1, 11, 13, 13)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    a = jax.vmap(lambda kk: jrng.step_draws(kk, 3, 100, 1, 9, 1, 9,
                                            True))(jks)
    b = rng.step_draws(tks, 3, 100, 1, 9, 1, 9, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jrng.autoreset_key)(jks)),
        rng.autoreset_key(tks).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    """Same key, same float32 logits: the actions agree wherever the top
    two perturbed scores are more than 1e-5 apart. The margin covers the
    gumbel noise's two float32 ``log``s, which may round 1 ulp apart
    between XLA and torch; at this size no sample falls inside it, and no
    action may differ."""
    rs = np.random.default_rng(seed)
    logits = rs.normal(size=(4, 256, 7)).astype(np.float32)
    jk = jax.random.PRNGKey(seed)
    a = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    b = rng.categorical(rng.PRNGKey(seed, device="cpu"),
                        torch.as_tensor(logits)).numpy()
    g = np.asarray(jax.random.gumbel(jk, logits.shape)) + logits
    top2 = np.sort(g, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert clear.all()
    np.testing.assert_array_equal(a[clear], b[clear])
    np.testing.assert_allclose(
        rng.gumbel(rng.PRNGKey(seed, device="cpu"), logits.shape).numpy(),
        np.asarray(jax.random.gumbel(jk, logits.shape)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("env_axis", [0, 1])
def test_sliced_draws(D, env_axis):
    """A rank's part of a global draw, for both logits layouts (env axis 1
    of feature-major (N, B, A) logits: the rank's flat indices strided;
    env axis 0 of (B, N, A): one contiguous range), at every offset of D
    ranks: ``random_bits``, ``uniform`` and ``gumbel`` with ``part`` are
    the slices of JAX's draws over the global shape (bits and uniforms
    bit-equal, gumbel to float32 rounding of its two logs), and
    ``categorical_slice`` is bit-equal to the same rows of the port's
    global ``categorical`` and of ``jax.random.categorical`` (no sample
    near a tie)."""
    shape = [4, 7]
    shape.insert(env_axis, 64)
    shape = tuple(shape)
    jk = jax.random.PRNGKey(D * 10 + env_axis)
    k = _t(jk)
    logits = np.random.default_rng(D).normal(size=shape).astype(np.float32)
    whole = rng.categorical(k, torch.as_tensor(logits)).numpy()
    jwhole = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    unif = np.asarray(jax.random.uniform(jk, shape))
    gum = np.asarray(jax.random.gumbel(jk, shape))
    B = shape[env_axis] // D
    for r in range(D):
        sl = [slice(None)] * 3
        sl[env_axis] = slice(r * B, (r + 1) * B)
        sl = tuple(sl)
        part = (env_axis, r * B, (r + 1) * B)
        np.testing.assert_array_equal(rng.random_bits(k, shape, part),
                                      bits[sl])
        np.testing.assert_array_equal(rng.uniform(k, shape, part=part),
                                      unif[sl])
        np.testing.assert_allclose(rng.gumbel(k, shape, part), gum[sl],
                                   rtol=1e-6, atol=1e-6)
        a = rng.categorical_slice(k, torch.as_tensor(logits[sl]), shape[
            env_axis], r * B, env_axis).numpy()
        np.testing.assert_array_equal(a, whole[sl[:2]])
        np.testing.assert_array_equal(a, jwhole[sl[:2]])
    # the index of a part is made once per shape
    assert rng.part_counts(shape, part, k.device) is rng.part_counts(
        shape, part, k.device)
    with pytest.raises(ValueError, match="outside"):
        rng.random_bits(k, shape, (env_axis, 0, shape[env_axis] + 1))
