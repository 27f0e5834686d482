"""The port's pixels torsos (``ActorCritic`` with torso 'cnn_s2d' or
'cnn_image') against the flax ``ActorCritic``, on the CPU: the flax weights
moved across by ``load_flax_params``, logits and values at float32 within
rtol 1e-4, atol 1e-5 (the same stack, summed in another order), with and
without the 'rich' aux features; and the port's own init (shapes, names,
zero biases)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.models import ActorCritic, load_flax_params
from marlgrid_tpu_torch.parallel import ppo

VS, TILE = 7, 8
SHAPES = {"cnn_s2d": (VS * TILE // 4, VS * TILE // 4, 48),
          "cnn_image": (VS * TILE, VS * TILE, 3)}


@pytest.mark.parametrize("aux_dim", [0, 7])
@pytest.mark.parametrize("torso", ["cnn_s2d", "cnn_image"])
def test_forward_matches_flax(torso, aux_dim):
    jcfg = jppo.PPOConfig(hidden=32, torso=torso, dtype=jnp.float32)
    rs = np.random.default_rng(0)
    obs = rs.integers(0, 256, (3, 2) + SHAPES[torso]).astype(np.uint8)
    aux = rs.normal(size=(3, 2, aux_dim)).astype(np.float32) \
        if aux_dim else None
    jnet = JActorCritic(jcfg)
    kw = {} if aux is None else {"aux": jnp.asarray(aux)}
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1, 0]),
                       **({} if aux is None else {"aux": kw["aux"][:1, 0]}))
    # biases are zero at init: give them values, so the test sees them
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (rs.normal(
            scale=0.1, size=a.shape).astype(np.float32) if "bias" in
            jax.tree_util.keystr(path) else 0), params)
    want_l, want_v = jnet.apply(params, jnp.asarray(obs), **kw)
    assert params["params"]["torso"]["kernel"].shape[0] == 3136 + aux_dim

    cfg = ppo.PPOConfig(hidden=32, torso=torso, dtype=torch.float32)
    net = ActorCritic(cfg, VS, device="cpu", tile_size=TILE, aux_dim=aux_dim)
    net.load_state_dict(load_flax_params(params))
    with torch.no_grad():
        logits, value = net(torch.as_tensor(obs),
                            None if aux is None else torch.as_tensor(aux))
    assert logits.shape == (3, 2, 7) and value.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=1e-5)


def test_init_shapes_and_names():
    """The port's own init has flax's tree: names, shapes, zero biases,
    lecun-normal spreads (std about 1/sqrt(fan_in))."""
    cfg = ppo.PPOConfig(hidden=128, torso="cnn_s2d", dtype=torch.float32)
    net = ActorCritic(cfg, VS, torch.Generator().manual_seed(0),
                      device="cpu", tile_size=TILE, aux_dim=3)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == {
        "conv1.weight": (32, 48, 2, 2), "conv1_bias": (32,),
        "Conv_0.weight": (64, 32, 4, 4), "Conv_0.bias": (64,),
        "Conv_1.weight": (64, 64, 3, 3), "Conv_1.bias": (64,),
        "torso.weight": (128, 3139), "torso.bias": (128,),
        "pi.weight": (7, 128), "pi.bias": (7,), "v.weight": (1, 128),
        "v.bias": (1,)}
    for name, fan_in in (("conv1", 192), ("Conv_0", 512), ("Conv_1", 576)):
        w = getattr(net, name).weight.detach()
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.1, name
    assert not net.conv1_bias.any() and not net.Conv_0.bias.any()
    # the encode 'cnn' torso builds: 3x3 convs on the 42 one-hot planes
    cnn = ActorCritic(ppo.PPOConfig(torso="cnn"), VS, device="cpu")
    assert cnn.kind == "cnn" and cnn.Conv_0.in_channels == 42
