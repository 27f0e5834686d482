"""The port's training CLI (``python -m marlgrid_tpu_torch.parallel.train``)
on the CPU, tiny: its JSONL carries the JAX CLI's fields, its checkpoint's
config.json holds the PPOConfig the JAX CLI builds from the same flags
(palettes included), and a flag whose path the port lacks exits with the
ROADMAP slice that brings it (``--model-shards`` that does not divide the
world size exits with JAX's mesh message). ``--distributed`` trains on two
gloo ranks,
on the sharded default path (feedforward, ``--overlap``, recurrent encode
and image) and with ``--shard-map``, checkpoints the global batch and
resumes in one process; the JAX CLI's ``--shard-map`` exits are
reproduced. ``--agent-config`` trains on two gloo ranks too. ``--torso
cnn`` trains
from the row store and evaluates; ``--profile-dir`` writes a trace;
``--debug-nans`` raises.
``--agent-config`` trains each of the three hetero trainers, checkpoints
and resumes, and rejects bad specs with the JAX CLI's messages. The
``--rnn`` CLI is in ``test_torch_ppo_rnn.py``."""
import json

import numpy as np
import pytest
import torch

from marlgrid_tpu.core import constants as C
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
    # a 'model' axis the ranks do not make: JAX's make_mesh message
    (["--rnn", "gru", "--model-shards", "2"], r"^0x2 mesh != 1 devices$"),
    (["--rnn", "gru", "--agent-config", "[{}]", "--distributed",
      "--num-processes", "3", "--model-shards", "2"],
     r"^1x2 mesh != 3 devices$"),
    (["--agent-config", "[{}]", "--model-shards", "2"],
     r"^0x2 mesh != 1 devices$"),
    (["--overlap", "--agent-config", "[{}]", "--distributed",
      "--num-processes", "3", "--model-shards", "2"],
     r"^1x2 mesh != 3 devices$"),
    (["--model-shards", "2"], r"^0x2 mesh != 1 devices$"),
    # not a missing slice: the JAX CLI stops at init_state_rnn's assert
    (["--rnn", "gru", "--torso", "cnn"], "mlp feature-major path"),
])
def test_unsupported_flag_names_its_slice(flag, slice_):
    with pytest.raises(SystemExit, match=slice_):
        train.main(TINY + flag)


@pytest.mark.parametrize("flag", [
    ["--model-shards", "2", "--shard-map"],
    ["--model-shards", "2", "--distributed", "--num-processes", "3"],
], ids=["model-shards", "multi-rank"])
def test_later_refusals_name_slice_g2(flag, monkeypatch):
    """What stays refused after the 'model' axis came: a --model-shards
    that the world size (one process; three ranks) does not take exits
    with JAX's make_mesh message before any process group is made, also
    in a torchrun rank (its WORLD_SIZE set)."""
    world = 3 if "--distributed" in flag else 1
    with pytest.raises(SystemExit, match=rf"^{world // 2}x2 mesh != "
                                         rf"{world} devices$"):
        train.main(TINY + flag)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match=r"^1x2 mesh != 3 devices$"):
        train.main(TINY + ["--distributed", "--model-shards", "2",
                           "--agent-config", "[{}]"])


#: the JAX CLI's multi-process test config (tests/test_shard_map.py::
#: _run_train_procs), narrowed
DIST = ["--device", "cpu", "--scenario", "empty", "--grid-size", "9",
        "--agents", "2", "--envs", "16", "--rollout", "8", "--max-steps",
        "20", "--hidden", "16"]


def _two_ranks(tmp_path, flags, tag):
    """Two gloo ranks of the CLI (a ``file://`` coordinator) with
    ``flags``; each rank's JSONL records. Both ranks are killed and reaped
    however the wait ends (``torch_dist_worker.reap``)."""
    import os
    import sys

    import torch_dist_worker

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = torch_dist_worker.spawn([
        [sys.executable, "-m", "marlgrid_tpu_torch.parallel.train"] + flags
        + ["--distributed", "--coordinator", f"file://{tmp_path}/{tag}store",
           "--num-processes", "2", "--process-id", str(i), "--metrics",
           str(tmp_path / f"{tag}{i}.jsonl")] for i in range(2)],
        root, dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1"))
    for i, (p, out) in enumerate(zip(procs, torch_dist_worker.reap(procs,
                                                                   300))):
        assert p.returncode == 0, f"rank {i}:\n{out[-3000:]}"
    return [[json.loads(line) for line in
             (tmp_path / f"{tag}{i}.jsonl").read_text().splitlines()]
            for i in range(2)]


@pytest.mark.parametrize("flags,h_shape", [
    ([], None),
    (["--overlap"], None),
    (["--rnn", "gru", "--bptt-window", "4"], (2, 16, 16)),
    (["--rnn", "gru", "--obs", "image", "--grid-size", "7", "--view-size",
      "3"], (16, 2, 16)),
], ids=["feedforward", "overlap", "gru", "gru-image"])
def test_cli_distributed_default_path(tmp_path, flags, h_shape):
    """``--distributed`` without ``--shard-map`` in two CPU processes trains
    on the sharded default path, as the JAX CLI's multi-process run does:
    both ranks log the same finite metrics over the global batch's
    env-steps, rank 0's checkpoint holds the global batch (the carry in
    global env order on its env axis), and ``--resume`` trains on in one
    process."""
    from marlgrid_tpu_torch.utils import checkpoint

    ck = tmp_path / "ck"
    recs = _two_ranks(tmp_path, DIST + flags + [
        "--iters", "2", "--checkpoint-dir", str(ck), "--checkpoint-every",
        "2"], "m")
    assert [r["step"] for r in recs[0]] == [0, 1]
    for a, b in zip(*recs):
        assert set(a) == FIELDS and np.isfinite(a["loss"])
        for k in FIELDS - {"time", "env_steps_per_s", "agent_steps_per_s"}:
            assert a[k] == b[k], k
    assert recs[0][-1]["env_steps"] == 2 * 16 * 8
    tree = checkpoint.restore(ck, map_location="cpu")
    assert all(v.shape[0] == 16 for v in tree["env_state"].values())
    assert ("h" in tree) == (h_shape is not None)
    if h_shape:
        assert tree["h"].shape == h_shape
    log = tmp_path / "r.jsonl"
    train.main(DIST + flags + ["--resume", str(ck), "--iters", "1",
                               "--metrics", str(log)])
    rec = json.loads(log.read_text().splitlines()[-1])
    assert np.isfinite(rec["loss"]) and rec["entropy"] > 0


@pytest.mark.parametrize("flag,match", [
    (["--agent-config", '[{"view_size":5},{"view_size":3}]', "--shard-map"],
     r"GSPMD path \(no --overlap/--shard-map\)"),
    (["--overlap", "--shard-map"], r"--overlap \+ --shard-map not supported"),
    (["--rnn", "gru", "--obs", "image", "--shard-map"],
     "--rnn --shard-map is the encode path; image recurrent runs use the "
     "default GSPMD mesh"),
], ids=["hetero", "overlap", "rnn-image"])
def test_shard_map_exits_as_the_jax_cli(flag, match):
    with pytest.raises(SystemExit, match=match):
        train.main(TINY + flag)


def test_cli_shard_map_two_ranks(tmp_path):
    """``--distributed --shard-map`` in two CPU processes (gloo, a
    ``file://`` coordinator): both ranks log the same finite losses over
    the global batch's env-steps; rank 0's checkpoint holds the global
    batch, resumes in one process (D = 1, with and without --shard-map)
    and evaluates from its path alone."""
    from marlgrid_tpu_torch.parallel import evaluate
    from marlgrid_tpu_torch.utils import checkpoint

    ck = tmp_path / "ck"
    recs = _two_ranks(tmp_path, TINY + [
        "--shard-map", "--checkpoint-dir", str(ck), "--checkpoint-every",
        "2"], "m")
    assert [r["step"] for r in recs[0]] == [0, 1]
    for a, b in zip(*recs):
        assert set(a) == FIELDS and np.isfinite(a["loss"])
        for k in FIELDS - {"time", "env_steps_per_s", "agent_steps_per_s"}:
            assert a[k] == b[k], k
    assert recs[0][-1]["env_steps"] == 2 * 8 * 8
    assert checkpoint.steps(ck) == [2]
    tree = checkpoint.restore(ck, map_location="cpu")
    assert all(v.shape[0] == 8 for v in tree["env_state"].values())
    assert checkpoint.load_config(ck)["ppo"]["n_envs"] == 8
    for flags in (["--shard-map"], []):
        log = tmp_path / f"r{len(flags)}.jsonl"
        train.main(TINY + flags + ["--resume", str(ck), "--iters", "1",
                                   "--metrics", str(log)])
        rec = json.loads(log.read_text().splitlines()[-1])
        assert np.isfinite(rec["loss"]) and rec["n_episodes"] > 0
    stats = evaluate.main(["--checkpoint", str(ck), "--episodes", "1",
                           "--device", "cpu"])
    assert stats["episodes"] == 1 and stats["steps"] == 6


@pytest.mark.parametrize("torso", ["cnn", "cnn_s2d"])
def test_cli_encode_conv_torso(tmp_path, torso):
    """--torso cnn (and cnn_s2d) on encode obs: two iterations from the row
    store with a checkpoint, no palettes in config.json; the cnn
    checkpoint evaluates from its path alone, and the cnn_s2d one is
    refused where the JAX evaluate fails (its space-to-depth relabel of
    the codes)."""
    from marlgrid_tpu_torch.parallel import evaluate

    ck = tmp_path / "ck"
    net = train.main(TINY + ["--torso", torso, "--checkpoint-dir", str(ck),
                             "--checkpoint-every", "2"])
    assert net.kind == torso
    config = json.loads((ck / "config.json").read_text())
    assert config["ppo"]["torso"] == torso
    assert config["ppo"]["embed_palettes"] is None
    argv = ["--checkpoint", str(ck), "--episodes", "1", "--device", "cpu"]
    if torso == "cnn_s2d":
        with pytest.raises(ValueError, match="JAX at fault"):
            evaluate.main(argv)
        return
    stats = evaluate.main(argv)
    assert stats["episodes"] == 1 and stats["steps"] == 6


def test_cli_profile_dir(tmp_path):
    """--profile-dir with 5 iterations traces calls 2-4 (on the CPU the
    step as it runs there, eager, with its stage labels; on the card the
    graph replays with their stage map): a trace that
    ``profiling.kernel_times`` reads, and whose hotspots name the
    rollout's and the update's stages; a run that ends inside the traced
    calls writes none, as the JAX CLI."""
    from marlgrid_tpu_torch.utils import profiling

    prof = tmp_path / "prof"
    train.main(TINY + ["--iters", "5", "--rollout", "4", "--profile-dir",
                       str(prof)])
    assert len(list(prof.iterdir())) == 1
    times = profiling.kernel_times(str(prof))
    assert sum(times.values()) > 0
    names = [name for _, name in profiling.hotspots(str(prof), top=50)]
    assert any(n.startswith("rollout.") for n in names)
    assert any(n.startswith("update.") for n in names)
    short = tmp_path / "short"
    train.main(TINY + ["--iters", "3", "--rollout", "4", "--profile-dir",
                       str(short)])
    assert not short.exists() or not list(short.iterdir())


def test_cli_debug_nans():
    """--debug-nans: a NaN learning rate makes NaN weights in the first
    update, and the check after the first call raises, naming it."""
    with pytest.raises(FloatingPointError, match="after iteration 0"):
        train.main(TINY + ["--debug-nans", "--lr", "nan"])
    train.main(TINY + ["--debug-nans"])


HETERO = ["--device", "cpu", "--scenario", "goal_cycle", "--grid-size", "9",
          "--envs", "8", "--rollout", "4", "--iters", "2", "--hidden", "16",
          "--max-steps", "4", "--epochs", "1", "--minibatches", "2"]
VIEWS = '[{"view_size":5},{"view_size":3},{"view_size":5}]'
MIXED = ('[{"view_size":5},{"view_size":5,"observation_style":"image",'
         '"view_tile_size":4}]')


@pytest.mark.parametrize("spec,rnn,kinds", [
    (VIEWS, [], ["mlp", "mlp"]),
    (VIEWS, ["--rnn", "gru"], ["mlp", "mlp"]),
    (MIXED, [], ["mlp", "cnn_s2d"]),
], ids=["views", "views-gru", "mixed"])
def test_cli_agent_config(tmp_path, spec, rnn, kinds):
    """--agent-config at a tiny size: one policy per observation group, no
    embed palettes, the JAX CLI's env params for the same flags in
    config.json, two iterations with a checkpoint (the per-group weights,
    and the per-group carry with --rnn), then one resumed from it."""
    from marlgrid_tpu.agents import GridAgentInterface as JAgent
    from marlgrid_tpu.agents import agents_to_params_fields as j_fields

    metrics = tmp_path / "m.jsonl"
    ck = tmp_path / "ck"
    nets = train.main(HETERO + rnn + ["--agent-config", spec, "--metrics",
                                      str(metrics), "--checkpoint-dir",
                                      str(ck), "--checkpoint-every", "2"])
    assert [n.kind for n in nets] == kinds
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[-1]["n_episodes"] > 0 and recs[-1]["entropy"] > 0
    agents = []
    for i, kw in enumerate(json.loads(spec)):
        kw.setdefault("color", ("red", "blue", "purple")[i])
        kw.setdefault("observation_style", "encode")
        agents.append(JAgent(**kw))
    jep = JEnvParams(width=9, height=9, scenario="goal_cycle", max_steps=4,
                     reward_decay=False, **j_fields(agents))
    config = json.loads((ck / "config.json").read_text())
    assert config["env_params"] == json.loads(json.dumps(jep.to_dict()))
    assert config["ppo"]["embed_palettes"] is None
    assert config["ppo"]["rnn"] == (rnn[-1] if rnn else "")
    tree = torch.load(ck / "step_2.pt", weights_only=True)
    assert isinstance(tree["net"], list) and len(tree["net"]) == len(kinds)
    if rnn:
        assert {g: tuple(h.shape) for g, h in tree["h"].items()} == {
            0: (2, 8, 16), 1: (1, 8, 16)}
    resumed = train.main(HETERO + rnn + ["--agent-config", spec, "--resume",
                                         str(ck), "--iters", "1",
                                         "--metrics", str(metrics)])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0]
    for a, b in zip(resumed, nets):
        assert not torch.equal(next(a.parameters()), next(b.parameters()))


@pytest.mark.parametrize("spec,rnn", [
    (VIEWS, []), (VIEWS, ["--rnn", "gru"]), (MIXED, []),
], ids=["views", "views-gru", "mixed"])
def test_cli_distributed_hetero(tmp_path, spec, rnn):
    """``--agent-config`` with ``--distributed`` in two CPU processes
    trains each hetero trainer on the sharded default path
    (``make_train_step_hetero*(mesh=...)``), as the JAX CLI trains a hetero
    population over its mesh: both ranks log the same finite metrics over
    the global batch's env-steps, and rank 0's checkpoint holds the global
    batch (with ``--rnn``, each group's carry in global env order)."""
    from marlgrid_tpu_torch.utils import checkpoint

    ck = tmp_path / "ck"
    recs = _two_ranks(tmp_path, HETERO + rnn + [
        "--agent-config", spec, "--checkpoint-dir", str(ck),
        "--checkpoint-every", "2"], "h")
    assert [r["step"] for r in recs[0]] == [0, 1]
    for a, b in zip(*recs):
        assert set(a) == FIELDS and np.isfinite(a["loss"])
        for k in FIELDS - {"time", "env_steps_per_s", "agent_steps_per_s"}:
            assert a[k] == b[k], k
    assert recs[0][-1]["env_steps"] == 2 * 8 * 4
    assert recs[0][-1]["n_episodes"] > 0
    tree = checkpoint.restore(ck, map_location="cpu")
    assert all(v.shape[0] == 8 for v in tree["env_state"].values())
    if rnn:
        assert {g: tuple(h.shape) for g, h in tree["h"].items()} == {
            0: (2, 8, 16), 1: (1, 8, 16)}


@pytest.mark.parametrize("flag,match", [
    (["--agent-config", "[not json"], "invalid JSON"),
    (["--agent-config", '{"view_size": 5}'], "non-empty JSON list"),
    (["--agent-config", "[]"], "non-empty JSON list"),
    (["--agent-config", '[{"view_size": 4}]'], "agent 0: view_size must be"),
    (["--agent-config", '[{}, {"color": "mauve"}]'], "agent 1"),
    (["--agent-config", MIXED, "--rnn", "gru"], "encode-only"),
    (["--agent-config", VIEWS, "--overlap"], "without --overlap"),
    (["--agent-config", VIEWS, "--rnn", "gru", "--bptt-window", "2"],
     "homogeneous-only"),
])
def test_agent_config_rejects(flag, match):
    """Bad --agent-config specs exit with the JAX CLI's messages, as do
    --rnn with mixed styles, --overlap and a BPTT window."""
    with pytest.raises(SystemExit, match=match):
        train.main(HETERO + flag)


CUSTOM = ["--device", "cpu", "--scenario", "my_cluttered", "--grid-size",
          "9", "--agents", "2", "--envs", "8", "--rollout", "4", "--iters",
          "1", "--minibatches", "2", "--hidden", "16"]


@pytest.fixture
def my_cluttered():
    """Registers ``my_cluttered`` (the cluttered builder under another name,
    so the palette check runs) in both packages with the palette the test
    passes, and removes it from both afterwards."""
    from marlgrid_tpu.core import grid_gen as jgg
    from marlgrid_tpu_torch.core import grid_gen as tgg

    def register(palette):
        for gg in (jgg, tgg):
            gg.register_scenario("my_cluttered", gg.SCENARIOS["cluttered"],
                                 lambda p: p.n_clutter + 1, palette=palette)
        return "my_cluttered"

    yield register
    for gg in (jgg, tgg):
        for table in (gg.SCENARIOS, gg._N_EVENTS, gg.SCENARIO_PALETTES):
            table.pop("my_cluttered", None)


def test_custom_palette_missing_codes_refused(my_cluttered):
    """A custom scenario whose palette misses the goal: the port's CLI
    refuses to train with the JAX check's ValueError, word for word (type
    code 7 missing at random-walk step 0, from the same keys and boards)."""
    my_cluttered(())
    jep = JEnvParams(width=9, height=9, n_agents=2, scenario="my_cluttered",
                     agent_colors=default_agent_colors(2))
    with pytest.raises(ValueError) as jax_err:
        jobs.validate_encode_palette(jep)
    with pytest.raises(ValueError) as port_err:
        train.main(CUSTOM)
    assert "misses type codes [7] (observed at random-walk step 0" in str(
        port_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_custom_palette_complete_accepted(my_cluttered):
    """The same scenario with a palette that holds the goal: the port's
    check sweeps every step without error, and the CLI trains with it."""
    from marlgrid_tpu_torch.core import obs as tobs
    from marlgrid_tpu_torch.core.state import EnvParams

    my_cluttered(((C.GOAL, 3, 0),))
    ep = EnvParams(width=9, height=9, n_agents=2, scenario="my_cluttered",
                   agent_colors=default_agent_colors(2))
    assert tobs.validate_encode_palette(ep, device="cpu") is None
    train.main(CUSTOM)


def test_profiling_trace(tmp_path):
    """``profiling.trace`` writes a trace of the block; on a CPU run
    ``kernel_times`` sums its ops and ``hotspots`` its labels."""
    from torch.profiler import record_function

    from marlgrid_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        with record_function("update.probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert profiling.kernel_times(str(tmp_path))["aten::mm"] > 0
    assert "update.probe" in [n for _, n in profiling.hotspots(
        str(tmp_path))]


@pytest.mark.parametrize("rnn,error,match", [
    ([], ValueError, "mlp torso on feature-major"),
    (["--rnn", "gru"], SystemExit, "mlp path")])
def test_cli_hetero_encode_conv_torso_refused(rnn, error, match):
    """All-encode hetero groups train with the mlp torso: the JAX trainers'
    nets assert the feature-major path, and the port's inits refuse."""
    with pytest.raises(error, match=match):
        train.main(HETERO + rnn + ["--agent-config", VIEWS, "--torso",
                                   "cnn_s2d"])
