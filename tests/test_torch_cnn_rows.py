"""The torsos on row-major 'encode' codes: the 'cnn' torso
(``onehot_features`` then 3x3 convs) and the 'cnn_s2d'/'cnn_image' stacks
run straight on the (vs, vs, 3) codes, against the flax ``ActorCritic`` on
the CPU, with the flax weights moved across by ``load_flax_params`` on
numpy-seeded codes (states up to 24, past the clip at 19). Float32 within
rtol 1e-4, atol 1e-5 (the bars of ``test_torch_cnn.py``); bf16 within 1e-2
(the bar ``test_torch_embed.py`` states for bf16 activations: about two
bf16 ulps of the largest logit). Also ``onehot_features`` bit-equal to
JAX's, the port's own init (flax's names and shapes) and the recurrent
family's refusal of 'cnn'."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from marlgrid_tpu.models.actor_critic import onehot_features as j_onehot
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.models import (ActorCritic, RecurrentActorCritic,
                                       load_flax_params)
from marlgrid_tpu_torch.models.actor_critic import onehot_features
from marlgrid_tpu_torch.parallel import ppo

F32 = (torch.float32, jnp.float32, 1e-4, 1e-5)
BF16 = (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-2)


def _codes(rs, lead, vs):
    """(*lead, vs, vs, 3) int32 codes: types 0..11, colors 0..9, states
    0..24."""
    return np.stack([rs.integers(0, hi, lead + (vs, vs))
                     for hi in (12, 10, 25)], -1).astype(np.int32)


def test_onehot_features_matches_jax():
    obs = _codes(np.random.default_rng(0), (3, 2), 5)
    got = onehot_features(torch.as_tensor(obs), torch.float32)
    want = np.asarray(j_onehot(jnp.asarray(obs), jnp.float32))
    assert got.shape == (3, 2, 5, 5, 42)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("torso,vs,dtypes", [
    ("cnn", 7, F32), ("cnn", 5, BF16),
    ("cnn_s2d", 5, F32), ("cnn_s2d", 7, BF16),
    ("cnn_image", 7, F32), ("cnn_image", 5, BF16)])
def test_encode_torso_matches_flax(torso, vs, dtypes):
    dtype, jdtype, rtol, atol = dtypes
    rs = np.random.default_rng(vs)
    obs = _codes(rs, (3, 2), vs)
    jcfg = jppo.PPOConfig(hidden=16, channels=(4, 8), torso=torso,
                          dtype=jdtype)
    jnet = JActorCritic(jcfg)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1, 0]))
    # biases are zero at init: give them values, so the test sees them
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (rs.normal(
            scale=0.1, size=a.shape).astype(np.float32) if "bias" in
            jax.tree_util.keystr(path) else 0), params)
    want_l, want_v = jnet.apply(params, jnp.asarray(obs))

    cfg = ppo.PPOConfig(hidden=16, channels=(4, 8), torso=torso, dtype=dtype)
    net = ActorCritic(cfg, vs, device="cpu", encode=True)
    net.load_state_dict(load_flax_params(params))
    with torch.no_grad():
        logits, value = net(torch.as_tensor(obs))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (3, 2, 7) and value.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(want_l, np.float32), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_v, np.float32),
                               rtol=rtol, atol=atol)


def test_cnn_init_shapes_and_names():
    """flax's auto-names Conv_0 … Conv_{k-1} (no conv1, no conv1_bias),
    3x3 kernels on the 42 one-hot planes (12 types, 10 colors, 20
    states), zero biases, lecun-normal spreads; the torso layer reads the
    (h, w, c) flatten."""
    cfg = ppo.PPOConfig(hidden=128, torso="cnn", dtype=torch.float32)
    net = ActorCritic(cfg, 7, torch.Generator().manual_seed(0),
                      device="cpu")
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == {
        "Conv_0.weight": (32, 42, 3, 3), "Conv_0.bias": (32,),
        "Conv_1.weight": (64, 32, 3, 3), "Conv_1.bias": (64,),
        "torso.weight": (128, 7 * 7 * 64), "torso.bias": (128,),
        "pi.weight": (7, 128), "pi.bias": (7,), "v.weight": (1, 128),
        "v.bias": (1,)}
    for name, fan_in in (("Conv_0", 378), ("Conv_1", 288)):
        w = getattr(net, name).weight.detach()
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.1, name
        assert not getattr(net, name).bias.any()


def test_recurrent_cnn_refused():
    """The JAX recurrent family asserts a pixels torso past the mlp, and
    the encode recurrent step the mlp torso: the port refuses alike."""
    with pytest.raises(ValueError, match="mlp feature-major path"):
        RecurrentActorCritic(ppo.PPOConfig(torso="cnn", rnn="gru"), 7,
                             device="cpu")
