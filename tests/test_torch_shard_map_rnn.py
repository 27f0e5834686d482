"""The port's recurrent explicit-collective train step
(``ppo_rnn.make_train_step_rnn_shard_map``, a GRU of hidden 16) on two gloo
ranks against the JAX package's on a 2-device mesh, on the CPU: the cases,
bounds and D = 2 against D = 1 check of ``test_torch_shard_map.py``, with
the carry gathered from the ranks (leaves (N, B, H), each rank holding
its envs' slice) against JAX's within 1e-5. Then truncated BPTT
(``bptt_window=4``, bf16, autoreset on, 2 epochs x 2 minibatches, three
steps) runs finite on the two ranks, as the JAX package's
``test_shard_map_rnn_bptt_runs``.
"""
import numpy as np
import pytest
import torch

from test_torch_shard_map import (CASES, check_against_jax,
                                  check_d2_against_d1, jax_case, jax_step,
                                  port_d1, port_run)
import torch_dist_worker


@pytest.fixture(scope="module")
def results(tmp_path_factory, devices8):
    cases = {name: jax_case(name, rnn="gru", hidden=16) for name in CASES}
    bptt = port_run(cases["resets"], steps=3, dtype=torch.bfloat16)
    bptt["cfg"] = dict(bptt["cfg"], bptt_window=4)
    with torch_dist_worker.start(
            tmp_path_factory.mktemp("shard_map_rnn"), "train",
            dict(runs=[port_run(c) for c in cases.values()] + [bptt])) as wait:
        jax_out = {name: jax_step(c, devices8) for name, c in cases.items()}
        d1 = port_d1(cases["no_resets"])
        ranks = wait()
    out = {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}
    return dict(jax=jax_out, d1=d1, ranks=out,
                bptt=[r[len(CASES)] for r in ranks])


@pytest.mark.parametrize("case", list(CASES))
def test_shard_map_rnn_step_matches_jax(results, case):
    check_against_jax(results["jax"][case], results["ranks"][case],
                      rnn=True)
    h = results["ranks"][case][0]["snaps"][0]["h"]
    assert h.shape == (2, CASES[case][1]["n_envs"], 16)


def test_shard_map_rnn_two_ranks_match_one(results):
    check_d2_against_d1(results["ranks"]["no_resets"], results["d1"])


def test_shard_map_rnn_bptt_runs(results):
    for rank in results["bptt"]:
        m = rank["snaps"][-1]["metrics"]
        assert np.isfinite(m["loss"]) and m["entropy"] > 0
        assert m["n_episodes"] > 0
        assert bool(torch.isfinite(rank["snaps"][-1]["h"]).all())
    assert results["bptt"][0]["snaps"][-1]["metrics"] == \
        results["bptt"][1]["snaps"][-1]["metrics"]


def test_shard_map_rnn_refuses_image_obs():
    """Image and rich recurrent obs with a mesh: the JAX step's assert."""
    from marlgrid_tpu_torch.core.state import EnvParams
    from marlgrid_tpu_torch.parallel import mesh as mesh_mod
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn

    ep = EnvParams(width=7, height=7, n_agents=2, view_size=5,
                   observation_style="image", agent_colors=(0, 4))
    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, hidden=16, rnn="gru",
                        torso="cnn_s2d")
    mesh = mesh_mod.make_mesh(device="cpu")
    for style in ("image", "rich"):
        with pytest.raises(AssertionError, match="GSPMD path"):
            ppo_rnn.make_train_step_rnn_shard_map(
                ep.replace(observation_style=style), cfg, None, None, mesh,
                device="cpu")
