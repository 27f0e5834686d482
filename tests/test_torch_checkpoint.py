"""The port's torch-native checkpoint (``marlgrid_tpu_torch/utils/
checkpoint.py``): exact resume of the whole training state, as
``tests/test_checkpoint.py`` checks it for the JAX package, and the
``config.json`` round trip."""
import json

import torch

from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import (EnvParams, EnvState, FIELDS,
                                           default_agent_colors)
from marlgrid_tpu_torch.parallel import ppo
from marlgrid_tpu_torch.utils import checkpoint as ck

EP = EnvParams(width=9, height=9, n_agents=2, scenario="cluttered",
               n_clutter=6, max_steps=10, view_size=5,
               observation_style="encode",
               agent_colors=default_agent_colors(2))
CFG = ppo.PPOConfig(n_envs=8, rollout_len=8, n_epochs=2, n_minibatches=2,
                    hidden=16)


def _fresh():
    net, opt = ppo.init_state(EP, CFG, torch.Generator().manual_seed(0),
                              device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    env = ppo.init_env_batch(EP, CFG.n_envs, rng.fold_in(key, 1),
                             device="cpu")
    return net, opt, env, rng.fold_in(key, 2)


def _tree(net, opt, env, key):
    return dict(net=net.state_dict(), opt=opt.state_dict(),
                env_state={f: getattr(env, f) for f in FIELDS}, key=key)


def _assert_equal(a, b, path="tree"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_exact_resume(tmp_path):
    """Two train steps, save, two more; against a restore into a fresh
    net/optimizer followed by the same two: weights, optimizer state, env
    state and key are bit-equal on the CPU."""
    net, opt, env, key = _fresh()
    step = ppo.make_train_step(EP, CFG, net, opt, device="cpu")
    for _ in range(2):
        env, key, _ = step(env, key)
    ck.save(str(tmp_path / "ck"), _tree(net, opt, env, key), step=2,
            config=dict(format=1, env_params=EP.to_dict(),
                        ppo=ppo.ppo_config_to_dict(CFG)))
    for _ in range(2):
        env, key, m = step(env, key)
    want = _tree(net, opt, env, key)

    net2, opt2, _, _ = _fresh()
    tree = ck.restore(str(tmp_path / "ck"), map_location="cpu")
    net2.load_state_dict(tree["net"])
    opt2.load_state_dict(tree["opt"])
    env2, key2 = EnvState(**tree["env_state"]), tree["key"]
    step2 = ppo.make_train_step(EP, CFG, net2, opt2, device="cpu")
    for _ in range(2):
        env2, key2, m2 = step2(env2, key2)
    _assert_equal(_tree(net2, opt2, env2, key2), want)
    for k in m:
        assert torch.equal(m[k], m2[k]), k
    assert ck.steps(str(tmp_path / "ck")) == [2]


def test_config_round_trip(tmp_path):
    """config.json is written as the JAX package writes it (sorted keys,
    indent 1) and rebuilds the same EnvParams and PPOConfig."""
    cfg = ppo.PPOConfig(n_envs=8, hidden=16,
                        embed_palettes=((0, 1, 2), (0, 5), (0, 1)))
    config = dict(format=1, env_params=EP.to_dict(),
                  ppo=ppo.ppo_config_to_dict(cfg))
    path = str(tmp_path / "ck")
    ck.save(path, dict(x=torch.arange(3)), step=5, config=config)
    ck.save(path, dict(x=torch.arange(4)), step=12)
    got = ck.load_config(path)
    with open(tmp_path / "ck" / "config.json") as f:
        assert f.read() == json.dumps(config, indent=1, sort_keys=True)
    assert EnvParams.from_dict(got["env_params"]) == EP
    assert ppo.ppo_config_from_dict(got["ppo"]) == cfg
    assert ck.steps(path) == [5, 12]
    assert torch.equal(ck.restore(path)["x"], torch.arange(4))
    assert torch.equal(ck.restore(path, step=5)["x"], torch.arange(3))
    assert ck.load_config(str(tmp_path / "none")) is None
