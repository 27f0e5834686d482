"""The PyTorch port stands alone: no JAX, and no silent CPU fallback.

A static AST scan (not ``sys.modules``: a site customization may import
jax at interpreter start) of every module of ``marlgrid_tpu_torch`` (the
data axis ``parallel/mesh.py`` among them), of ``chip_smoke.py`` and
``chip_pair.py``, of the port's entry points
``__graft_entry_torch__.py``, of the multi-process tests' worker
``tests/torch_dist_worker.py`` and of the port's examples
(``examples/torch_*.py``) finds no import of jax, flax, optax or the JAX
package. The package imports, and its host env runs, without
gymnasium, imageio and PIL (the card's machine has none of them).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "marlgrid_tpu"}
EXAMPLES = [ROOT / "examples" / f"torch_{name}.py" for name in (
    "batched_rollout", "custom_env", "hetero_population", "random_rollout")]
FILES = sorted((ROOT / "marlgrid_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_pair.py",
    ROOT / "__graft_entry_torch__.py",
    ROOT / "tests" / "torch_dist_worker.py"] + EXAMPLES


def load_example(path: Path):
    """An example script as a module (its ``main(argv)`` not called)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_the_walk_covers_the_data_axis():
    assert ROOT / "marlgrid_tpu_torch" / "parallel" / "mesh.py" in FILES


def test_the_walk_covers_the_model_axis_and_the_entry_points():
    assert ROOT / "marlgrid_tpu_torch" / "parallel" / \
        "tensor_parallel.py" in FILES
    assert ROOT / "__graft_entry_torch__.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, an entry point called without ``device=`` raises;
    with ``device="cpu"`` it runs."""
    from marlgrid_tpu_torch import envs, wrapper
    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.core.state import EnvParams
    from marlgrid_tpu_torch.models import ActorCritic, RecurrentActorCritic
    from marlgrid_tpu_torch.parallel import (evaluate, mesh, ppo, ppo_hetero,
                                             ppo_hetero_mixed, ppo_hetero_rnn,
                                             ppo_rnn, train)
    from marlgrid_tpu_torch.vector import VectorEnv

    from marlgrid_tpu_torch.parallel import tensor_parallel

    graft = load_example(ROOT / "__graft_entry_torch__.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ep = EnvParams(width=7, height=7, n_agents=1,
                   observation_style="encode")
    het = EnvParams(width=7, height=7, n_agents=2, agent_colors=(0, 4),
                    observation_style="encode", agent_view_sizes=(5, 3))
    mix = het.replace(agent_obs_styles=("encode", "image"))
    cfg = ppo.PPOConfig(n_envs=4, rollout_len=2, hidden=8)
    rcfg = ppo.PPOConfig(n_envs=4, rollout_len=2, hidden=8, rnn="gru")
    key = rng.PRNGKey(0, device="cpu")
    cpu_mesh = mesh.make_mesh(device="cpu")
    mesh_calls = (
        lambda: mesh.init_distributed(),
        lambda: mesh.make_mesh(),
        lambda: ppo.make_train_step_shard_map(ep, cfg, None, None, cpu_mesh),
        lambda: ppo_rnn.make_train_step_rnn_shard_map(ep, rcfg, None, None,
                                                      cpu_mesh),
        lambda: ppo.make_train_step(ep, cfg, None, None, mesh=cpu_mesh),
        lambda: ppo.make_train_step(ep, cfg, None, None, overlap=True,
                                    mesh=cpu_mesh),
        lambda: ppo.make_rollout(ep, cfg, None, mesh=cpu_mesh),
        lambda: ppo.make_update(ep, cfg, None, None, mesh=cpu_mesh),
        lambda: ppo_rnn.make_train_step_rnn(ep, rcfg, None, None,
                                            mesh=cpu_mesh),
        lambda: ppo_rnn.make_rollout_rnn(ep, rcfg, None, mesh=cpu_mesh),
        lambda: ppo_rnn.make_update_rnn(ep, rcfg, None, None,
                                        mesh=cpu_mesh),
        lambda: train.main(["--scenario", "empty", "--agents", "1", "--envs",
                            "4", "--iters", "1", "--distributed",
                            "--num-processes", "1", "--process-id", "0",
                            "--coordinator", "localhost:1"]),
        lambda: train.main(["--scenario", "empty", "--agents", "1", "--envs",
                            "4", "--iters", "1", "--shard-map"]),
        # the 'model' axis and the entry points
        lambda: mesh.make_mesh(n_model=1),
        lambda: tensor_parallel.TensorParallelActorCritic(cfg, ep.view_size,
                                                          cpu_mesh),
        lambda: graft.entry(),
        lambda: graft.dryrun_multichip(1),
        lambda: train.main(["--scenario", "empty", "--agents", "1", "--envs",
                            "4", "--iters", "1", "--shard-map",
                            "--distributed", "--num-processes", "1",
                            "--process-id", "0", "--coordinator",
                            "localhost:1"]))
    hetero_calls = (
        lambda: VectorEnv(het, 4),
        lambda: ppo_hetero.init_state_hetero(het, cfg),
        lambda: ppo_hetero.make_train_step_hetero(het, cfg, None, None),
        lambda: ppo_hetero_rnn.init_state_hetero_rnn(het, rcfg),
        lambda: ppo_hetero_rnn.make_train_step_hetero_rnn(het, rcfg, None,
                                                          None),
        lambda: ppo_hetero_mixed.init_state_hetero_mixed(mix, cfg),
        lambda: ppo_hetero_mixed.make_train_step_hetero_mixed(mix, cfg, [],
                                                              None),
        lambda: train.main(["--scenario", "empty", "--agent-config",
                            '[{"view_size":5},{"view_size":3}]', "--envs",
                            "4", "--iters", "1"]),
        # the hetero trainers' sharded default path
        lambda: ppo_hetero.make_rollout_hetero(het, cfg, None,
                                               mesh=cpu_mesh),
        lambda: ppo_hetero.make_update_hetero(het, cfg, None, None,
                                              mesh=cpu_mesh),
        lambda: ppo_hetero.make_train_step_hetero(het, cfg, None, None,
                                                  mesh=cpu_mesh),
        lambda: ppo_hetero_rnn.make_update_hetero_rnn(het, rcfg, None, None,
                                                      mesh=cpu_mesh),
        lambda: ppo_hetero_rnn.make_train_step_hetero_rnn(
            het, rcfg, None, None, mesh=cpu_mesh),
        lambda: ppo_hetero_mixed.make_update_hetero_mixed(
            mix, cfg, [], None, mesh=cpu_mesh),
        lambda: ppo_hetero_mixed.make_train_step_hetero_mixed(
            mix, cfg, [], None, mesh=cpu_mesh),
        lambda: train.main(["--scenario", "empty", "--agent-config",
                            '[{"view_size":5},{"view_size":3}]', "--envs",
                            "4", "--iters", "1", "--distributed",
                            "--num-processes", "1", "--process-id", "0",
                            "--coordinator", "localhost:1"]))
    example_calls = tuple((lambda m=load_example(p): m.main([]))
                          for p in EXAMPLES)
    host_calls = (
        lambda: wrapper.MultiGridEnv(params=ep),
        lambda: envs.make("MarlGrid-3AgentCluttered15x15-v0"),
        lambda: envs.env_from_config(dict(env_class="empty", n_agents=1)),
        lambda: envs.ENV_CLASSES["goal_cycle"](grid_size=9),
        lambda: VectorEnv(ep, 4, independent_resets=True),
        lambda: evaluate.restore_policy(
            evaluate.parse_args(["--checkpoint", "unused"]), ep, cfg))
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
                                     "--envs", "4", "--iters", "1"])
                 ) + mesh_calls + hetero_calls + host_calls + example_calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state, obs = VectorEnv(ep, 4, device="cpu").reset(key)
    assert obs.shape == (4, 1, 7, 7, 3) and obs.device.type == "cpu"


def test_imports_without_gymnasium_imageio_pil():
    """In a fresh interpreter where gymnasium, imageio and PIL cannot be
    imported: the package imports, registers its envs and runs an episode
    step of the host env on the CPU; the spaces and the viewer name what
    they miss."""
    code = """
import sys
for m in ("gymnasium", "imageio", "PIL"):
    sys.modules[m] = None
import marlgrid_tpu_torch
from marlgrid_tpu_torch import envs, rendering
env = envs.make("MarlGrid-2AgentEmpty9x9-v0", device="cpu")
obs = env.reset()
obs, rew, done, info = env.step([2, 1])
assert len(obs) == 2 and rew.shape == (2,) and env.render().ndim == 3
assert "MarlGrid-3AgentCluttered15x15-v0" in envs.REGISTRY
for what in (lambda: env.agents[0].action_space,
             lambda: rendering.SimpleImageViewer().imshow(env.render())):
    try:
        what()
    except ImportError as e:
        print("refused:", e)
    else:
        raise AssertionError("no ImportError")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert "gymnasium" in lines[-3] and "PIL" in lines[-2], lines


def test_every_device_default_is_cuda():
    """Every ``device=`` default of the port's functions and methods, and
    of ``__graft_entry_torch__``'s ``entry`` and ``dryrun_multichip``, is
    ``"cuda"``."""
    import importlib
    import inspect
    import pkgutil

    import marlgrid_tpu_torch

    mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        marlgrid_tpu_torch.__path__, "marlgrid_tpu_torch.")]
    mods.append(load_example(ROOT / "__graft_entry_torch__.py"))
    seen = {}
    for mod in mods:
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else [
                (f"{name}.{k}", v) for k, v in vars(obj).items()
                if inspect.isfunction(v)] if inspect.isclass(obj) else []
            for qual, fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not p.empty:
                    seen[f"{mod.__name__}.{qual}"] = p.default
    assert seen["__graft_entry_torch__.entry"] == "cuda"
    assert seen["__graft_entry_torch__.dryrun_multichip"] == "cuda"
    assert seen["marlgrid_tpu_torch.parallel.tensor_parallel."
                "TensorParallelActorCritic.__init__"] == "cuda"
    assert len(seen) > 30
    assert {k: v for k, v in seen.items() if v != "cuda"} == {}
