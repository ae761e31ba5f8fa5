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


@pytest.mark.parametrize("module", [
    "checkpoint.py", "fit.py", "infer.py", "data/feeder.py",
    "data/folder.py", "data/preprocess.py", "utils/obj_io.py"])
def test_driver_slice_modules_are_checked(module):
    """The drivers' slice (checkpoints, host data, fit, infer) is among
    the sources checked here."""
    assert ROOT / "facerecon_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "parallel/mesh.py", "graft_entry.py", "data/video.py", "track.py",
    "convert_weights.py", "convert_assets.py"])
def test_tracking_and_converter_slice_modules_are_checked(module):
    """The eighth slice (tracking, data parallelism, the converters) is
    among the sources checked here."""
    assert ROOT / "facerecon_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", ["bench.py", "graft_entry.py",
                                    "profile_trace.py", "render_bench.py",
                                    "raster_bench.py"])
def test_benchmark_slice_modules_are_checked(module):
    """The ninth, tenth and eleventh slices (the benchmark's entry points,
    entry(), the trace endpoint, the render-chain and rasterizer
    benchmarks) are among the sources checked here."""
    assert ROOT / "facerecon_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "benchmarks/_timing.py", "benchmarks/calib_probe.py",
    "benchmarks/roofline_probe.py", "benchmarks/cnn_probe.py",
    "benchmarks/cnn_micro_probe.py", "benchmarks/gather_probe.py",
    "benchmarks/scatter_probe.py"])
def test_probe_slice_modules_are_checked(module):
    """The probes' twins (the twelfth slice) are among the sources checked
    here."""
    assert ROOT / "facerecon_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
