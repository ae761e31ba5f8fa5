"""Import guard: the port (facerecon_tpu_torch/ and chip_smoke.py) imports
nothing of JAX and nothing of the JAX package. It keeps its own copies of
what it needs from modules that do not import JAX."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "facerecon_tpu")
SOURCES = sorted((ROOT / "facerecon_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_sources_exist():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("module", [
    "oracle.py", "evaluate.py", "ops/probes.py", "utils/native_oracle.py",
    "utils/metrics.py"])
def test_contract_slice_modules_are_checked(module):
    """The third slice's modules are among the sources checked here."""
    assert ROOT / "facerecon_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
