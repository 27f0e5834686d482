"""Recurrent PPO of the port (``marlgrid_tpu_torch/parallel/ppo_rnn.py``)
on the CPU, mirroring ``tests/test_ppo_rnn.py``: the row alignment
(``ratio_dev`` at lr = 0) for both cells, three BPTT windows and both embed
routes; ``bptt_window == T`` bit-equal to the default; the sequence-block
rules and the paths that raise; the ``--rnn`` CLI with a bit-exact resume
of the carry; and the learning signal. The step against JAX's is in
``test_torch_rnn.py``.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, FIELDS,
                                           default_agent_colors)
from marlgrid_tpu_torch.parallel import ppo, ppo_rnn, train
from marlgrid_tpu_torch.utils import checkpoint as ck

EP = EnvParams(width=9, height=9, n_agents=2, scenario="empty", max_steps=10,
               view_size=5, observation_style="encode",
               agent_colors=default_agent_colors(2))


def _cfg(**kw):
    base = dict(n_envs=8, rollout_len=8, n_epochs=1, n_minibatches=2,
                rnn="gru", hidden=16)
    base.update(kw)
    return ppo.PPOConfig(**base)


def _run(cfg, seed, n_steps=1, ep=EP):
    net, opt, h = ppo_rnn.init_state_rnn(
        ep, cfg, torch.Generator().manual_seed(seed), device="cpu")
    key = rng.PRNGKey(seed, device="cpu")
    env = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                             device="cpu")
    step = ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device="cpu")
    ms = []
    for _ in range(n_steps):
        env, h, key, m = step(env, h, key)
        ms.append({k: float(v) for k, v in m.items()})
    return net, h, ms


@pytest.mark.parametrize("plane_major", [False, True],
                         ids=["k2", "plane_major"])
@pytest.mark.parametrize("L", [0, 4, 2], ids=["L=T", "L=4", "L=2"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_ratio_dev_alignment(cell, L, plane_major, monkeypatch):
    """At lr = 0 the update re-runs every window from its stored entry
    carry and reproduces the rollout's log-probs (|ratio - 1| ~ 0) on both
    embed routes, and no weight moves. Drift would mean the blocked
    sequences, the dones or the stored carries got mispaired."""
    monkeypatch.setenv("MARLGRID_TPU_EMBED_V2", "1" if plane_major else "")
    cfg = _cfg(rnn=cell, lr=0.0, dtype=torch.float32, bptt_window=L)
    net, opt, h = ppo_rnn.init_state_rnn(
        EP, cfg, torch.Generator().manual_seed(3), device="cpu")
    assert net.torso0.plane_major == plane_major
    before = {k: v.clone() for k, v in net.state_dict().items()}
    key = rng.PRNGKey(3, device="cpu")
    env = ppo.init_env_batch(EP, 8, rng.fold_in(key, 1), device="cpu")
    step = ppo_rnn.make_train_step_rnn(EP, cfg, net, opt, device="cpu")
    _, h, _, m = step(env, h, key)
    assert float(m["ratio_dev"]) < 1e-4, float(m["ratio_dev"])
    assert np.isfinite(float(m["loss"])) and float(m["n_episodes"]) > 0
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    for x in (h if cell == "lstm" else (h,)):
        assert x.shape == (2, 8, 16) and bool(torch.isfinite(x).all())


def test_bptt_window_full_equals_default():
    """bptt_window == rollout_len is bit-equal to the default
    full-sequence update (W = 1 reduces the window transforms to the
    full-sequence blocking)."""
    outs = [_run(_cfg(dtype=torch.float32, bptt_window=bw), 5)
            for bw in (0, 8)]
    for (na, a), (nb, b) in zip(outs[0][0].state_dict().items(),
                                outs[1][0].state_dict().items()):
        assert na == nb and torch.equal(a, b), na
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def test_sequence_blocks_and_paths():
    """The two block rules at full width (encode c = 128, G = 32; images
    c = 16, G = 256) and the tiny-batch halving; the paths the port lacks
    raise, naming their ROADMAP slice."""
    assert ppo_rnn.sequence_block_size(4096, 1, 4) == 128
    assert ppo_rnn.sequence_block_size(4096, 1, 4, image=True) == 16
    assert ppo_rnn.sequence_block_size(16, 1, 4, image=True) == 4
    assert ppo_rnn.sequence_block_size(16, 1, 4) == 4
    with pytest.raises(NotImplementedError, match="Slice G"):
        ppo_rnn.make_train_step_rnn_shard_map(EP, _cfg(), None, None)
    with pytest.raises(NotImplementedError, match="Slice D"):
        ppo.init_state(EP, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="bptt_window 3"):
        ppo_rnn.make_rollout_rnn(EP, _cfg(bptt_window=3), None,
                                 device="cpu")
    with pytest.warns(UserWarning, match="dropping"):
        _run(_cfg(n_minibatches=3), 0)


TINY = ["--device", "cpu", "--scenario", "empty", "--grid-size", "9",
        "--agents", "2", "--envs", "8", "--rollout", "4", "--hidden", "16",
        "--max-steps", "6", "--epochs", "1", "--rnn", "gru"]


def test_cli_rnn_resume_is_exact(tmp_path):
    """``--rnn gru``: the run_config is the JAX CLI's for the same flags,
    the checkpoint carries the carry ``h``, and one iteration resumed from
    the step-1 checkpoint gives the same bits (weights, optimizer, env
    state, key, carry) as the second iteration of the uninterrupted run."""
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(TINY + ["--iters", "2", "--checkpoint-dir", str(a),
                       "--checkpoint-every", "1", "--metrics",
                       str(tmp_path / "m.jsonl")])
    config = json.loads((a / "config.json").read_text())
    assert config["ppo"]["rnn"] == "gru"
    assert config["ppo"]["embed_palettes"] is not None
    first = tmp_path / "first"
    first.mkdir()
    shutil.copy(a / "step_1.pt", first / "step_1.pt")
    shutil.copy(a / "config.json", first / "config.json")
    train.main(TINY + ["--iters", "1", "--resume", str(first),
                       "--checkpoint-dir", str(b), "--checkpoint-every",
                       "1"])
    want, got = ck.restore(str(a), step=2), ck.restore(str(b), step=1)
    assert want["h"].shape == (2, 8, 16) and want["h"].abs().sum() > 0
    assert torch.equal(got["h"], want["h"])
    assert torch.equal(got["key"], want["key"])
    for f in FIELDS:
        assert torch.equal(got["env_state"][f], want["env_state"][f]), f
    for k, v in want["net"].items():
        assert torch.equal(got["net"][k], v), k
    assert got["opt"]["state"].keys() == want["opt"]["state"].keys()
    for i, s in want["opt"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["opt"]["state"][i][k], v), (i, k)


@pytest.mark.slow
def test_memory_learning_signal():
    """Recurrent PPO learns on a trivial task (returns rise)."""
    ep = EnvParams(width=7, height=7, n_agents=1, scenario="empty",
                   max_steps=12, view_size=5, observation_style="encode",
                   agent_colors=default_agent_colors(1))
    cfg = ppo.PPOConfig(n_envs=64, rollout_len=24, n_epochs=2,
                        n_minibatches=2, lr=1e-3, ent_coef=0.003,
                        rnn="gru", hidden=64)
    _, _, ms = _run(cfg, 1, n_steps=30, ep=ep)
    rets = [m["episode_return"] for m in ms]
    early, late = np.mean(rets[2:8]), np.mean(rets[-6:])
    assert late > early + 0.05, f"no learning: early={early:.3f} " \
                                f"late={late:.3f}"
