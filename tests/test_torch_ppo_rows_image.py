"""The port's row-major trajectory store on image observations
(``PPOConfig(recompute_image_obs=False)``, the 'cnn_s2d' torso) against the
JAX package, on the CPU: empty 9x9 with 2 agents, 5x5 views of 8-pixel
tiles, B = 8, T = 4, hidden 16, float32, 2 epochs x 4 minibatches. The
same overlap-step pairing and bars as ``test_torch_ppo_rows.py`` (one JAX
compile): stored s2d pixels, actions, rewards, env state and key
bit-equal; logp, values, gradients, metrics and weights within float32
tolerance. Also the encode-obs pixels torsos train from the row store."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams
from marlgrid_tpu_torch.parallel import ppo
from test_torch_ppo_rows import B, T, check_pair, run_pair


@pytest.fixture(scope="module")
def image_s2d():
    jep = JEnvParams(width=9, height=9, n_agents=2, scenario="empty",
                     max_steps=6, view_size=5, observation_style="image",
                     agent_colors=(0, 4))
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=16, board_pool=4,
                          torso="cnn_s2d", recompute_image_obs=False,
                          dtype=jnp.float32)
    return run_pair(jep, jcfg)


def test_image_row_train_step_matches_jax(image_s2d):
    want, got, grads, net = image_s2d
    # (T, B*N, (5*8/4)**2 * 48) uint8 s2d pixels
    assert got["traj"]["obs"].shape == (T, B * 2, 10 * 10 * 48)
    assert net.conv1.weight.shape == (32, 48, 2, 2)
    check_pair(want, got, grads, net)


@pytest.mark.parametrize("torso,width", [("cnn_s2d", 4 * 4 * 64),
                                         ("cnn_image", 64)])
def test_encode_pixels_torsos_train(torso, width):
    """'cnn_s2d' and 'cnn_image' on encode obs: the first conv reads the
    3 code channels at side 7 (as flax infers it), the rollout stores
    (T, B*N, 147) uint8 codes, and two steps change the weights."""
    ep = EnvParams(width=9, height=9, n_agents=2, scenario="empty",
                   max_steps=6, observation_style="encode",
                   agent_colors=(0, 4))
    cfg = ppo.PPOConfig(n_envs=B, rollout_len=T, hidden=16, board_pool=4,
                        torso=torso, dtype=torch.float32)
    net, opt = ppo.init_state(ep, cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    assert net.conv1.in_channels == 3 and net.torso.in_features == width
    w0 = [p.detach().clone() for p in net.parameters()]
    key = rng.PRNGKey(1, device="cpu")
    env = ppo.init_env_batch(ep, B, rng.fold_in(key, 1), device="cpu")
    _, _, traj, _ = ppo.make_rollout(ep, cfg, net, device="cpu")(env, key)
    assert traj["obs"].shape == (T, B * 2, 147)
    assert traj["obs"].dtype == torch.uint8
    step = ppo.make_train_step(ep, cfg, net, opt, device="cpu")
    for _ in range(2):
        env, key, m = step(env, key)
        assert np.isfinite(float(m["loss"]))
    assert not all(torch.equal(p, q) for p, q in zip(net.parameters(), w0))
