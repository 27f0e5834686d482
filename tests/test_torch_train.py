"""The port's training CLI (``python -m marlgrid_tpu_torch.parallel.train``)
on the CPU, tiny: its JSONL carries the JAX CLI's fields, its checkpoint's
config.json holds the PPOConfig the JAX CLI builds from the same flags
(palettes included), and a flag whose path the port lacks exits with the
ROADMAP slice that brings it. The ``--rnn`` CLI is in
``test_torch_ppo_rnn.py``."""
import json

import pytest
import torch

from marlgrid_tpu.core import obs as jobs
from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.core.state import default_agent_colors
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.parallel import train

TINY = ["--device", "cpu", "--scenario", "empty", "--grid-size", "9",
        "--agents", "2", "--envs", "8", "--rollout", "8", "--iters", "2",
        "--hidden", "16", "--max-steps", "6"]
FIELDS = {"step", "time", "env_steps", "env_steps_per_s",
          "agent_steps_per_s", "loss", "pg_loss", "vf_loss", "entropy",
          "ratio_dev", "episode_return", "episode_length",
          "episode_cycles", "n_episodes"}


def test_cli_tiny(tmp_path):
    metrics = tmp_path / "m.jsonl"
    ck = tmp_path / "ck"
    train.main(TINY + ["--metrics", str(metrics), "--checkpoint-dir",
                       str(ck), "--checkpoint-every", "2"])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r) == FIELDS
    assert recs[-1]["env_steps"] == 2 * 8 * 8
    assert recs[-1]["n_episodes"] > 0 and recs[-1]["entropy"] > 0

    # the JAX CLI's run_config for the same flags
    jep = JEnvParams(width=9, height=9, n_agents=2, scenario="empty",
                     max_steps=6, view_size=7, observation_style="encode",
                     reward_decay=True,
                     agent_colors=default_agent_colors(2))
    jcfg = jppo.PPOConfig(n_envs=8, rollout_len=8, lr=3e-4, torso="mlp",
                          n_epochs=2, n_minibatches=4, hidden=16,
                          board_pool=256, rnn="", bptt_window=0,
                          embed_palettes=jobs.encode_palettes(jep))
    config = json.loads((ck / "config.json").read_text())
    want = json.loads(json.dumps(dict(format=1, env_params=jep.to_dict(),
                                      ppo=jppo.ppo_config_to_dict(jcfg))))
    assert config["ppo"]["embed_palettes"] is not None
    assert config == want

    # resume from it, with the overlap step and two steps per call
    train.main(TINY + ["--resume", str(ck), "--overlap",
                       "--steps-per-call", "2", "--metrics", str(metrics)])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1]


IMAGE = ["--device", "cpu", "--scenario", "empty", "--grid-size", "7",
         "--agents", "2", "--view-size", "5", "--envs", "8", "--rollout",
         "4", "--iters", "2", "--hidden", "16", "--max-steps", "4",
         "--obs", "image"]


def test_cli_image(tmp_path):
    """--obs image at a tiny size: the cnn_s2d torso by default, no embed
    palettes in config.json (the JAX CLI's run_config for the same flags),
    two iterations with a checkpoint, then one resumed from it."""
    metrics = tmp_path / "m.jsonl"
    ck = tmp_path / "ck"
    net = train.main(IMAGE + ["--metrics", str(metrics), "--checkpoint-dir",
                              str(ck), "--checkpoint-every", "2"])
    assert net.conv1.weight.shape == (32, 48, 2, 2)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[-1]["n_episodes"] > 0 and recs[-1]["entropy"] > 0
    jep = JEnvParams(width=7, height=7, n_agents=2, scenario="empty",
                     max_steps=4, view_size=5, observation_style="image",
                     reward_decay=True,
                     agent_colors=default_agent_colors(2))
    jcfg = jppo.PPOConfig(n_envs=8, rollout_len=4, lr=3e-4, torso="cnn_s2d",
                          n_epochs=2, n_minibatches=4, hidden=16,
                          board_pool=256, rnn="", bptt_window=0)
    config = json.loads((ck / "config.json").read_text())
    assert config == json.loads(json.dumps(dict(
        format=1, env_params=jep.to_dict(),
        ppo=jppo.ppo_config_to_dict(jcfg))))
    resumed = train.main(IMAGE + ["--resume", str(ck), "--iters", "1",
                                  "--metrics", str(metrics)])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0]
    assert not torch.equal(resumed.conv1.weight, net.conv1.weight)


@pytest.mark.parametrize("flag,slice_", [
    (["--rnn", "gru", "--shard-map"], "Slice G"),
    (["--rnn", "gru", "--agent-config", "[{}]"], "Slice E"),
    (["--torso", "cnn"], "Slice C"),
    (["--torso", "cnn_s2d"], "Slice C"),
    (["--agent-config", "[{}]"], "Slice E"),
    (["--shard-map"], "Slice G"),
    (["--model-shards", "2"], "Slice G"),
    (["--profile-dir", "p"], "Slice F"),
])
def test_unsupported_flag_names_its_slice(flag, slice_):
    with pytest.raises(SystemExit, match=slice_):
        train.main(TINY + flag)
