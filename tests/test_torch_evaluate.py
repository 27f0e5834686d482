"""The port's evaluation CLI (``marlgrid_tpu_torch/parallel/evaluate.py``)
against the JAX package's, on the CPU: a tiny JAX checkpoint is trained
(as tests/test_evaluate.py does), its weights carried across with
``models/actor_critic.py::load_flax_params`` into a port checkpoint with
the same ``config.json``, and both ``evaluate.main`` calls, given the same
flags, print the same stats line, greedy and with ``--sample``.

The two frameworks' bf16 policies agree within ``LOGIT_TOL`` (the
accumulation order differs). A step where JAX's top two scores (logits,
or logits plus the Gumbel noise of ``--sample``) lie within twice that of
each other could pick another action in the port; :func:`tie_report`
replays JAX's evaluation loop with both policies to find such steps, and
the stats lines are held equal wherever the port's choices all equal
JAX's (a choice may differ only at a near tie; else the test reports it).
At the seeds used here, runs on one host found 1-20 near ties in 40-60
agent steps per family and mode, with the logits within 0.006 of JAX's;
choices differed only in the hetero greedy run (0 or 6 of 60 agent steps
in two runs, all at near ties: the tiny policy's bf16 logits tie
exactly), whose stats line is then reported instead of compared.

This file covers the mlp policy and the flag cross-check;
``test_torch_evaluate_rnn.py`` and ``test_torch_evaluate_hetero.py`` the
GRU and a hetero population (one JAX train compile per file).
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlgrid_tpu.parallel import evaluate as jeval, train as jtrain
from marlgrid_tpu.wrapper import MultiGridEnv as JEnv
from marlgrid_tpu_torch.models.actor_critic import load_flax_params
from marlgrid_tpu_torch.parallel import evaluate
from marlgrid_tpu_torch.utils import checkpoint as ckpt_mod

ENV_ARGS = ["--scenario", "empty", "--grid-size", "9", "--agents", "2",
            "--max-steps", "10", "--view-size", "5"]
#: |JAX logit - port logit| bound of the bf16 policies on the CPU
LOGIT_TOL = 0.02


def make_checkpoints(tmp, extra=(), env_args=ENV_ARGS):
    """(JAX checkpoint dir, port checkpoint dir): a tiny JAX training run
    and its weights written as a port checkpoint with the same
    config.json."""
    jck, tck = str(tmp / "jax_ck"), str(tmp / "torch_ck")
    jtrain.main(list(env_args) + [
        "--envs", "8", "--rollout", "4", "--iters", "2", "--epochs", "1",
        "--minibatches", "1", "--checkpoint-dir", jck,
        "--checkpoint-every", "2", *extra])
    jargs = jeval.parse_args(["--checkpoint", jck])
    jep, jcfg = jeval.resolve_config(jargs)
    _, jparams, _ = jeval.restore_policy(jargs, jep, jcfg)
    sd = load_flax_params(jax.device_get(jparams))
    with open(os.path.join(jck, "config.json")) as f:
        config = json.load(f)
    ckpt_mod.save(tck, dict(net=sd), step=2, config=config)
    return jck, tck


def stats_line(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def tie_report(jck, tck, flags, sample):
    """Replay JAX's evaluation loop (its env, its key, its actions) with
    both policies. Asserts that the port's logits lie within LOGIT_TOL of
    JAX's at every step, and that wherever the port's choice (its argmax,
    or its categorical draw on the same key) differs from JAX's, JAX's top
    two scores lie within ``2 * LOGIT_TOL``. Returns ``(agent steps, near
    ties, choices that differ, max |logit error|)``."""
    from marlgrid_tpu_torch.core import rng

    jargs = jeval.parse_args(["--checkpoint", jck, *flags])
    jep, jcfg = jeval.resolve_config(jargs)
    jnet, jparams, jh0 = jeval.restore_policy(jargs, jep, jcfg)
    targs = evaluate.parse_args(["--checkpoint", tck, "--device", "cpu",
                                 *flags])
    tep, tcfg = evaluate.resolve_config(targs)
    tnet, th0 = evaluate.restore_policy(targs, tep, tcfg)
    hetero = jep.has_hetero_obs
    if hetero:
        from marlgrid_tpu.parallel import ppo_hetero_mixed
        from marlgrid_tpu.vector import obs_groups

        groups = [(list(idxs), gp.observation_style,
                   ppo_hetero_mixed.group_cfg(jcfg, gp).torso
                   if gp.observation_style != "encode" else "mlp")
                  for idxs, gp in obs_groups(jep)]
        nets = list(zip(jnet, jparams, tnet))
    else:
        groups = [(list(range(jep.n_agents)), jargs.obs, jcfg.torso)]
        nets = [(jnet, jparams, tnet)]
    env = JEnv(params=jep, seed=jargs.seed)
    key = jax.random.PRNGKey(jargs.seed + 1)
    steps = ties = differ = 0
    worst = 0.0
    for _ in range(jargs.episodes):
        obs_list = env.reset()
        jh, th = jh0(), th0()
        if not hetero:
            jh, th = {0: jh}, {0: th}
        done = False
        while not done:
            key, ak = jax.random.split(key)
            acts = np.zeros(jep.n_agents, np.int32)
            for g, ((idxs, style, torso), (jn, jp, tn)) in enumerate(
                    zip(groups, nets)):
                entries = [obs_list[i] for i in idxs]
                jo, jaux = jeval.style_obs_batch(entries, jep, style, torso)
                kw = {} if jaux is None else dict(aux=jaux)
                if jh is None or jh.get(g) is None:
                    jl, _ = jn.apply(jp, jo, **kw)
                else:
                    jl, _, jh[g] = jn.apply(jp, jo, jh[g], **kw)
                to, taux = evaluate.style_obs_batch(entries, tep, style,
                                                    torso, "cpu")
                with torch.no_grad():
                    tl, hg = evaluate.policy_logits(
                        tn, to, taux, None if th is None else th.get(g))
                if th is not None and th.get(g) is not None:
                    th[g] = hg
                jl = np.asarray(jl, np.float32)
                tl = tl.numpy()
                np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
                worst = max(worst, float(np.abs(tl - jl).max()))
                k = jax.random.fold_in(ak, g) if hetero else ak
                score, tscore = jl, tl
                if sample:
                    score = jl + np.asarray(jax.random.gumbel(k, jl.shape))
                    tk = torch.as_tensor(np.asarray(k).astype(np.int64))
                    tscore = tl + rng.gumbel(tk, tl.shape).numpy()
                top = np.sort(score, -1)
                near = top[:, -1] - top[:, -2] <= 2 * LOGIT_TOL
                other = np.argmax(tscore, -1) != np.argmax(score, -1)
                assert not (other & ~near).any(), (steps, score, tscore)
                ties += int(near.sum())
                differ += int(other.sum())
                acts[idxs] = np.argmax(score, -1)
            obs_list, _, done, _ = env.step(acts)
            steps += jep.n_agents
    return steps, ties, differ, worst


def check_family(capsys, jck, tck, flags):
    """Both evaluate.main calls, greedy and sampled: the same stats line
    wherever :func:`tie_report` finds every choice equal."""
    report = []
    for sample in (False, True):
        f = list(flags) + (["--sample"] if sample else [])
        want = stats_line(capsys, jeval.main, ["--checkpoint", jck, *f])
        got = stats_line(capsys, evaluate.main,
                         ["--checkpoint", tck, "--device", "cpu", *f])
        steps, ties, differ, worst = tie_report(jck, tck, f, sample)
        report.append(f"evaluate {f}: {steps} agent steps, {ties} near "
                      f"ties, {differ} choices differ, max |logit err| "
                      f"{worst:.3g}")
        assert steps > 0
        if differ:
            warnings.warn(f"evaluate {f}: {differ} near-tie choices of "
                          f"{steps} differ; stats not compared")
            continue
        assert got == want, (f, got, want)
    print("\n".join(report))


@pytest.fixture(scope="module")
def mlp_ck(tmp_path_factory):
    return make_checkpoints(tmp_path_factory.mktemp("eval_mlp"))


def test_evaluate_mlp_matches_jax(capsys, mlp_ck):
    check_family(capsys, *mlp_ck, ["--episodes", "2"])


def test_evaluate_flags_and_mismatch(tmp_path, capsys, mlp_ck):
    """A mismatched ``--view-size`` exits as in JAX; ``--max-steps``
    overrides; ``--out`` writes the gif; the default device is the card."""
    jck, tck = mlp_ck
    for main, ck, dev in ((jeval.main, jck, []),
                          (evaluate.main, tck, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="contradict"):
            main(["--checkpoint", ck, "--view-size", "7", *dev])
    out = str(tmp_path / "ev.gif")
    stats = stats_line(capsys, evaluate.main, [
        "--checkpoint", tck, "--device", "cpu", "--episodes", "1",
        "--max-steps", "4", "--out", out])
    assert stats["mean_length"] <= 4 and stats["video"] == out
    assert os.path.getsize(out) > 0
    assert evaluate.parse_args(["--checkpoint", tck]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--checkpoint", tck])


def test_style_obs_batch_layouts():
    """The mlp torso's feature-major codes and the s2d relabel from host
    entries, against the JAX batch they come from."""
    from marlgrid_tpu.core.state import EnvParams as JParams

    jp = JParams(width=9, height=9, n_agents=2, view_size=5,
                 agent_colors=(0, 1))
    rs = np.random.default_rng(0)
    enc = [rs.integers(0, 11, (5, 5, 3)).astype(np.int32) for _ in range(2)]
    codes, aux = evaluate.style_obs_batch(enc, jp, "encode", "mlp", "cpu")
    assert codes.shape == (2, 75, 1) and codes.dtype == torch.uint8
    assert aux is None
    np.testing.assert_array_equal(
        codes[..., 0].numpy(),
        np.stack(enc).transpose(0, 3, 1, 2).reshape(2, 75))
    img = [rs.integers(0, 256, (40, 40, 3)).astype(np.uint8)
           for _ in range(2)]
    s2d, _ = evaluate.style_obs_batch(img, jp, "image", "cnn_s2d", "cpu")
    want, _ = jeval.style_obs_batch(img, jp, "image", "cnn_s2d")
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(want))
    rich = [dict(pov=i, reward=0.5, position=(3, 4), orientation=2)
            for i in img]
    _, taux = evaluate.style_obs_batch(rich, jp, "rich", "cnn_image", "cpu")
    _, jaux = jeval.style_obs_batch(rich, jp, "rich", "cnn_image")
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    assert jnp.asarray(jaux).dtype == jnp.float32
