"""The PyTorch port stands alone: no JAX, and no silent CPU fallback.

A static AST scan (not ``sys.modules``: a site customization may import
jax at interpreter start) of every module of ``marlgrid_tpu_torch`` and of
``chip_smoke.py`` finds no import of jax, flax, optax or the JAX package.
"""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "marlgrid_tpu"}
FILES = sorted((ROOT / "marlgrid_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, an entry point called without ``device=`` raises;
    with ``device="cpu"`` it runs."""
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.core.state import EnvParams
    from marlgrid_tpu_torch.models import ActorCritic, RecurrentActorCritic
    from marlgrid_tpu_torch.parallel import ppo, ppo_rnn, train
    from marlgrid_tpu_torch.vector import VectorEnv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ep = EnvParams(width=7, height=7, n_agents=1,
                   observation_style="encode")
    cfg = ppo.PPOConfig(n_envs=4, rollout_len=2, hidden=8)
    rcfg = ppo.PPOConfig(n_envs=4, rollout_len=2, hidden=8, rnn="gru")
    key = rng.PRNGKey(0, device="cpu")
    for call in (lambda: rng.PRNGKey(0),
                 lambda: VectorEnv(ep, 4),
                 lambda: ppo.init_env_batch(ep, 4, key),
                 lambda: ActorCritic(cfg, ep.view_size),
                 lambda: ppo.make_rollout(ep, cfg, None),
                 lambda: ppo.init_state(ep, cfg),
                 lambda: ppo.make_train_step(ep, cfg, None, None),
                 lambda: RecurrentActorCritic(rcfg, ep.view_size),
                 lambda: ppo_rnn.init_state_rnn(ep, rcfg),
                 lambda: ppo_rnn.make_train_step_rnn(ep, rcfg, None, None),
                 lambda: train.main(["--scenario", "empty", "--agents", "1",
                                     "--envs", "4", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state, obs = VectorEnv(ep, 4, device="cpu").reset(key)
    assert obs.shape == (4, 1, 7, 7, 3) and obs.device.type == "cpu"
