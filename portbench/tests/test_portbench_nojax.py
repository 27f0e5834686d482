"""No run may hold jax, jaxlib, flax or the JAX package: names compared
whole at their first dot, so the port's own name passes."""
import ast
from pathlib import Path

from portbench import harness

PORTBENCH = Path(harness.__file__).resolve().parent


def test_whole_top_level_names():
    assert harness.banned_modules(["marlgrid_tpu_torch",
                                   "marlgrid_tpu_torch.parallel.ppo",
                                   "jaxtyping", "flaxen", "torch"]) == []
    assert harness.banned_modules(["marlgrid_tpu.parallel.ppo"]) == [
        "marlgrid_tpu"]
    assert harness.banned_modules(["jax.numpy", "jaxlib", "flax.linen",
                                   "marlgrid_tpu"]) == [
        "flax", "jax", "jaxlib", "marlgrid_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_banned():
    for path in PORTBENCH.rglob("*.py"):
        bad = harness.banned_modules(list(_imports(path)))
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        names = {n.split(".")[0] for n in _imports(path)}
        assert "marlgrid_tpu_torch" not in names, path
        assert "portbench" not in names or path.name == "__init__.py", path
