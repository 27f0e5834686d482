"""The port's heterogeneous recurrent PPO
(``marlgrid_tpu_torch/parallel/ppo_hetero_rnn.py``) against the JAX
package's ``make_train_step_hetero_rnn``, on the CPU.

One GRU train step on the population of ``test_torch_ppo_hetero.py``
(goal_cycle 13x13, views 7, 5, 7, 5; B = 16, T = 8, hidden 32, float32,
full vocabularies, 2 epochs x 4 minibatches of env-chunk blocks), from the
same weights and key: each group's first-minibatch gradients, the metrics,
the weights, every group's carry, the env state and the key, with
``test_torch_rnn.py``'s tolerances. Also the row alignment at lr = 0 for
both cells and the paths that exit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu.parallel import ppo_hetero_rnn as jhrnn
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import ppo, ppo_hetero_rnn
from test_torch_ppo import _t
from test_torch_ppo_hetero import (B, GOAL_CYCLE, T, check_step,
                                   jax_hetero_step, port_config,
                                   record_first_grads)


@pytest.fixture(scope="module")
def jax_step():
    jcfg = jppo.PPOConfig(n_envs=B, rollout_len=T, hidden=32, board_pool=4,
                          dtype=jnp.float32, rnn="gru")
    return jax_hetero_step(GOAL_CYCLE, jcfg, jhrnn.init_state_hetero_rnn,
                           jhrnn.make_train_step_hetero_rnn, carry=True)


def test_train_step_matches_jax(jax_step):
    j = jax_step
    ep, cfg = port_config(GOAL_CYCLE, j["jcfg"])
    nets, opt, h = ppo_hetero_rnn.init_state_hetero_rnn(ep, cfg,
                                                        device="cpu")
    assert {g: tuple(x.shape) for g, x in h.items()} == {
        0: (2, B, 32), 1: (2, B, 32)}
    for net, sd in zip(nets, load_flax_params(j["params0"])):
        net.load_state_dict(sd)
    grads = record_first_grads(nets, opt)
    step = ppo_hetero_rnn.make_train_step_hetero_rnn(ep, cfg, nets, opt,
                                                     device="cpu")
    env0 = ppo.init_env_batch(ep, B, _t(j["k_env"]), stagger=True,
                              device="cpu")
    env1, h1, key1, m = step(env0, h, _t(j["k_step"]))
    check_step(j, nets, opt, grads, m, env1, key1)
    assert set(h1) == set(j["h1"]) == {0, 1}
    for g in h1:
        np.testing.assert_allclose(h1[g].numpy(), j["h1"][g], rtol=0,
                                   atol=1e-5, err_msg=f"carry of group {g}")


@pytest.mark.parametrize("rnn", ["gru", "lstm"])
def test_alignment_at_lr0(rnn):
    """At lr = 0 the update's re-run of every group's stored sequences from
    the carry entering the rollout gives back the rollout's log-probs
    (|ratio - 1| ~ 0), on the second step too (nonzero entry carries)."""
    ep = EnvParams.from_dict(GOAL_CYCLE.to_dict())
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1, n_minibatches=2,
                        lr=0.0, hidden=16, dtype=torch.float32, rnn=rnn)
    nets, opt, h = ppo_hetero_rnn.init_state_hetero_rnn(
        ep, cfg, torch.Generator().manual_seed(2), device="cpu")
    key = rng.PRNGKey(2, device="cpu")
    env = ppo.init_env_batch(ep, 8, rng.fold_in(key, 1), device="cpu")
    step = ppo_hetero_rnn.make_train_step_hetero_rnn(ep, cfg, nets, opt,
                                                     device="cpu")
    for _ in range(2):
        env, h, key, m = step(env, h, key)
        assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    assert isinstance(h[0], tuple) == (rnn == "lstm")


def test_exits():
    ep = EnvParams.from_dict(GOAL_CYCLE.to_dict())
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, hidden=16, rnn="gru")
    with pytest.raises(SystemExit, match="homogeneous-only"):
        ppo_hetero_rnn.init_state_hetero_rnn(
            ep, ppo.PPOConfig(rnn="gru", bptt_window=2), device="cpu")
    with pytest.raises(SystemExit, match="mlp path"):
        ppo_hetero_rnn.init_state_hetero_rnn(
            ep, ppo.PPOConfig(rnn="gru", torso="cnn_s2d"), device="cpu")
    # B = 12: chunks halve 12 -> 6 -> 3, which is odd: 4 blocks < 8
    with pytest.raises(SystemExit, match="fewer than --minibatches 8"):
        ppo_hetero_rnn.make_update_hetero_rnn(
            ep, ppo.PPOConfig(n_envs=12, rollout_len=4, rnn="gru",
                              n_minibatches=8), None, None, device="cpu")
    nets, opt, h = ppo_hetero_rnn.init_state_hetero_rnn(ep, cfg,
                                                        device="cpu")
    assert len(nets) == 2 and set(h) == {0, 1}
