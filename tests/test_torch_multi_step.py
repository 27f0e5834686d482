"""The port's fused multi-step (``ppo.multi_step``, ``ppo.multi_step_overlap``,
``ppo_rnn.multi_step_rnn``), the carry flattening of ``parallel/graph.py``
and the train CLI's ``--steps-per-call``, on the CPU.

On the CPU there is no CUDA graph: a graphed step runs its raw step, and
``multi_step`` calls it k times. So k steps in one call must equal k
single steps bit for bit, as ``tests/test_ppo.py``'s
``test_multi_step_matches_repeated_single_steps`` holds JAX's. The port's
``multi_step`` is also held against JAX's ``multi_step`` from the same
weights, env batch and key: the key and the env state bit-equal (its
reward fields too), the weights within ``test_torch_ppo.py``'s tolerance.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlgrid_tpu.core.state import EnvParams as JEnvParams
from marlgrid_tpu.parallel import ppo as jppo
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, EnvState, FIELDS,
                                           default_agent_colors,
                                           state_to_numpy)
from marlgrid_tpu_torch.models import load_flax_params
from marlgrid_tpu_torch.parallel import graph, ppo, ppo_rnn, train

EP = EnvParams(width=9, height=9, n_agents=2, scenario="empty", max_steps=6,
               view_size=5, observation_style="encode",
               agent_colors=default_agent_colors(2))
K = 3


def _cfg(rnn=""):
    return ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1,
                         n_minibatches=2, hidden=16, rnn=rnn, board_pool=4,
                         dtype=torch.float32)


def _start(kind):
    """(net, optimizer, make(jit) -> step, carry) of one trainer, from seed
    3: ``kind`` 'ff', 'overlap' (the carry after the priming rollout),
    'gru' or 'lstm'."""
    gen = torch.Generator().manual_seed(3)
    key = rng.PRNGKey(3, device="cpu")
    rnn = kind if kind in ("gru", "lstm") else ""
    cfg = _cfg(rnn)
    env = ppo.init_env_batch(EP, cfg.n_envs, rng.fold_in(key, 1),
                             device="cpu")
    key = rng.fold_in(key, 2)
    if rnn:
        net, opt, h = ppo_rnn.init_state_rnn(EP, cfg, gen, device="cpu")
        return net, opt, lambda jit: ppo_rnn.make_train_step_rnn(
            EP, cfg, net, opt, device="cpu", jit=jit), (env, h, key)
    net, opt = ppo.init_state(EP, cfg, gen, device="cpu")
    if kind == "ff":
        return net, opt, lambda jit: ppo.make_train_step(
            EP, cfg, net, opt, device="cpu", jit=jit), (env, key)
    _, prime = ppo.make_train_step(EP, cfg, net, opt, device="cpu",
                                   overlap=True)
    return net, opt, lambda jit: ppo.make_train_step(
        EP, cfg, net, opt, device="cpu", overlap=True, jit=jit)[0], \
        prime(env, key)


MULTI = {"ff": ppo.multi_step, "overlap": ppo.multi_step_overlap,
         "gru": ppo_rnn.multi_step_rnn, "lstm": ppo_rnn.multi_step_rnn}


@pytest.mark.parametrize("kind", list(MULTI))
def test_multi_step_matches_single_steps(kind):
    """k steps in one call (from the raw step) equal k calls of the step
    from ``jit=True``, bit for bit: weights, Adam's moments, the whole
    carry (env state, key; ``h``, or the overlap step's trajectory) and the
    last step's metrics."""
    net1, opt1, make1, carry = _start(kind)
    step = make1(True)
    for _ in range(K):
        *carry, m1 = step(*carry)
    net3, opt3, make3, carry3 = _start(kind)
    *carry3, m3 = MULTI[kind](make3(False), K)(*carry3)

    got, _ = graph.flatten(tuple(carry3))
    want, _ = graph.flatten(tuple(carry))
    assert len(got) == len(want) > len(FIELDS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(net3.state_dict().values(), net1.state_dict().values()):
        assert torch.equal(a, b)
    for i, s in opt1.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(opt3.state_dict()["state"][i][k], v), (i, k)
    assert {k: float(v) for k, v in m3.items()} == \
        {k: float(v) for k, v in m1.items()}
    assert float(m1["n_episodes"]) > 0


def _record_first_grad():
    """An optax stage that passes updates through and keeps the first
    ones it sees: placed after the clip, it holds the first minibatch's
    clipped gradient (as in ``test_torch_ppo.py``)."""
    def init(params):
        return dict(g=jax.tree.map(jnp.zeros_like, params),
                    n=jnp.zeros((), jnp.int32))

    def update(updates, state, params=None):
        g = jax.tree.map(lambda a, b: jnp.where(state["n"] == 0, a, b),
                         updates, state["g"])
        return updates, dict(g=g, n=state["n"] + 1)

    return optax.GradientTransformation(init, update)


def test_multi_step_matches_jax():
    """The port's ``multi_step`` against JAX's ``multi_step`` (k = 3 steps
    under one ``lax.scan``), from the same flax weights, env batch and
    key: the key and every field of the env state bit-equal, every metric of the last step within 1e-5, and the
    weights within 1e-4 where JAX's first clipped gradient is above 1e-6
    (``test_torch_ppo.py``'s bounds: Adam moves a weight by +-lr whatever
    its gradient's size, so a gradient at float32 noise level may take the
    other sign in the other framework)."""
    jep = JEnvParams.from_dict(EP.to_dict())
    jcfg = jppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1,
                          n_minibatches=2, hidden=16, board_pool=4,
                          dtype=jnp.float32)
    k_net, k_env, k_step = jax.random.split(jax.random.PRNGKey(5), 3)
    net, params, _, _ = jppo.init_state(jep, jcfg, k_net)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     _record_first_grad(), optax.adam(jcfg.lr))
    params = jax.tree.map(np.asarray, params)
    env0 = jppo.init_env_batch(jep, 8, k_env, stagger=True)
    multi = jppo.multi_step(
        jppo.make_train_step(jep, jcfg, net, tx, jit=False), K)
    p3, o3, env3, key3, jm = jax.tree.map(np.asarray, multi(
        jax.tree.map(jnp.asarray, params), tx.init(params), env0, k_step))
    want_g = load_flax_params(o3[1]["g"])

    def t(k):
        return torch.as_tensor(np.asarray(k).astype(np.int64))

    cfg = ppo.PPOConfig(n_envs=8, rollout_len=4, n_epochs=1,
                        n_minibatches=2, hidden=16, board_pool=4,
                        dtype=torch.float32)
    pnet, opt = ppo.init_state(EP, cfg, device="cpu")
    pnet.load_state_dict(load_flax_params(params))
    env = ppo.init_env_batch(EP, 8, t(k_env), stagger=True, device="cpu")
    env, key, m = ppo.multi_step(ppo.make_train_step(
        EP, cfg, pnet, opt, device="cpu", jit=False), K)(env, t(k_step))

    got = state_to_numpy(env)
    for f in FIELDS:
        want = np.asarray(getattr(env3, f))
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    np.testing.assert_array_equal(key.numpy(), key3)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(jm["n_episodes"]) > 0
    want_p = load_flax_params(p3)
    for name, p in pnet.state_dict().items():
        sure = want_g[name].abs() > 1e-6
        assert sure.any(), name
        np.testing.assert_allclose(p[sure].numpy(),
                                   want_p[name][sure].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def _assert_same(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb and len(la) == len(lb)
    assert all(x is y for x, y in zip(la, lb))


def test_flatten_round_trips():
    """Each carry a trainer hands a graphed step flattens to its tensors
    and back to the same structure: an EnvState, an LSTM's (c, h), a
    hetero {group: h} dict (of tensors or LSTM pairs) and the overlap
    step's prev = (traj dict with an EnvState of stored states,
    last_value); dicts flatten alike whatever their insertion order."""
    g = torch.Generator().manual_seed(0)
    env = EnvState(**{f: torch.randn(2, 3, generator=g) for f in FIELDS})
    lstm = (torch.zeros(2, 4), torch.ones(2, 4))
    hetero = {1: torch.randn(3, generator=g), 0: lstm}
    traj = {"obs": env, "act": torch.arange(4), "rew": torch.randn(4)}
    prev = (traj, torch.randn(4, generator=g))
    for carry in ((env, torch.arange(2)), (env, lstm, torch.arange(2)),
                  (env, hetero, torch.arange(2)),
                  (env, prev, torch.arange(2))):
        leaves, spec = graph.flatten(carry)
        back = graph.unflatten(spec, leaves)
        _assert_same(back, carry)
        assert type(back[0]) is type(carry[0])
    leaves, spec = graph.flatten(hetero)
    assert leaves[0] is lstm[0] and leaves[2] is hetero[1]
    assert graph.flatten({0: lstm, 1: hetero[1]})[1] == spec
    with pytest.raises(TypeError, match="cannot flatten"):
        graph.flatten((env, [lstm]))
    with pytest.raises(ValueError, match="more leaves"):
        graph.unflatten(spec, leaves + leaves)


def test_graphed_step_on_cpu_runs_raw_step():
    """On the CPU a graphed step is its raw step: no graph, nothing
    captured, the raw step's own results."""
    calls = []

    def fn(x, key):
        calls.append(1)
        return x + 1, key, {"loss": x.sum()}

    step = graph.GraphedStep(fn, "toy")
    x = torch.zeros(3)
    for i in range(3):
        x, key, m = step(x, torch.arange(2))
    assert len(calls) == 3 and step.graph is None and step.capture_s is None
    assert torch.equal(x, torch.full((3,), 3.0)) and float(m["loss"]) == 6


CLI = ["--device", "cpu", "--scenario", "empty", "--grid-size", "9",
       "--agents", "2", "--envs", "8", "--rollout", "4", "--iters", "2",
       "--hidden", "16", "--max-steps", "6", "--epochs", "1"]


@pytest.mark.parametrize("flags", [
    ["--rnn", "gru"],
    ["--agent-config", '[{"view_size":5},{"view_size":3}]'],
    ["--overlap"]], ids=["rnn-gru", "agent-config", "overlap"])
def test_cli_steps_per_call(tmp_path, flags):
    """``--steps-per-call 2`` (one call of ``ppo.multi_step`` /
    ``multi_step_rnn`` / ``multi_step_overlap``) logs the same last-step
    metrics, at the same step and env-step count, as ``--steps-per-call
    1`` over the same two iterations, and the same weights."""
    recs, nets = {}, {}
    for spc in ("1", "2"):
        path = tmp_path / f"m{spc}.jsonl"
        nets[spc] = train.main(CLI + flags + ["--steps-per-call", spc,
                                              "--metrics", str(path)])
        recs[spc] = [json.loads(line)
                     for line in path.read_text().splitlines()]
    assert len(recs["1"]) == 2 and len(recs["2"]) == 1
    a, b = recs["1"][-1], recs["2"][-1]
    for k in ("time", "env_steps_per_s", "agent_steps_per_s"):
        a.pop(k), b.pop(k)
    assert a == b and a["step"] == 1 and a["env_steps"] == 2 * 8 * 4
    for x, y in zip(nets["1"].state_dict().values(),
                    nets["2"].state_dict().values()):
        assert torch.equal(x, y)


def test_resume_keeps_the_optimizers_form(tmp_path):
    """A checkpoint's Adam state resumes in the resuming device's form: a
    CPU run resumes a checkpoint whose param groups say ``capturable`` (as
    the card writes them) in the CPU's plain form, and one iteration from
    it gives the same bits as from the CPU's own checkpoint. (The card
    resuming a CPU checkpoint, which must come out capturable, is
    ``chip_smoke.py``'s ``phase_cli_cpu_resume``.)"""
    from marlgrid_tpu_torch.utils import checkpoint as ck

    a, b, c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    train.main(CLI + ["--iters", "1", "--checkpoint-dir", str(a),
                      "--checkpoint-every", "1"])
    tree = ck.restore(str(a))
    assert not tree["opt"]["param_groups"][0]["capturable"]
    for group in tree["opt"]["param_groups"]:
        group["capturable"] = True
    ck.save(str(b), tree, step=1, config=ck.load_config(str(a)))
    outs = []
    for src, dst in ((a, c / "a"), (b, c / "b")):
        train.main(CLI + ["--iters", "1", "--resume", str(src),
                          "--checkpoint-dir", str(dst),
                          "--checkpoint-every", "1"])
        outs.append(ck.restore(str(dst)))
    assert not outs[1]["opt"]["param_groups"][0]["capturable"]
    for k, v in outs[0]["net"].items():
        assert torch.equal(outs[1]["net"][k], v), k
    assert torch.equal(outs[1]["key"], outs[0]["key"])
