"""The harness end to end on the CPU at a tiny size: every cell's run
comes out correct against the plain reference, the control and each
planted fault come out not correct, the result's line has its contract's
keys, a new cell is found by its files alone, and nothing the harness
runs loads JAX or the JAX package (nor the reference the program)."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import control, faults, run, spec
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 987
CELLS = ("infer224.b256", "train224.b128", "render512.b256",
         "infer224.frame")
FAULTS = {"infer224.b256": ["altered"], "render512.b256": ["altered"],
          "infer224.frame": ["altered"],
          "train224.b128": ["unchanged", "half_batch", "altered"]}


@pytest.fixture(autouse=True)
def _restore_render():
    import facerecon_tpu_torch.ops.render as render_mod
    real = render_mod.render_coeffs
    yield
    render_mod.render_coeffs = real


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(name):
    r = run.run_cell(tiny.cell(name), SEED, 0.05, False, CPU)
    assert r["correct"], r["compared"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in spec.cell(name)["end_to_end"]}
    assert set(r["metrics"]) == want and "setup_s" in want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = tiny.cell(name)
    numbers = control.control_numbers(c, SEED, CPU)
    from perfbench import check
    ok, compared = check.verdict(numbers, c["traffic"]["limits"])
    assert not ok, compared


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in FAULTS[n]])
def test_a_planted_fault_is_not_correct(name, fault):
    r = run.run_cell(tiny.cell(name), SEED, 0.05, False, CPU,
                     fault=faults.FAULTS[fault])
    assert not r["correct"], r["compared"]


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "infer224.b256", "--seed", "1",
                     "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


NEW_KIND = '''"""render_whole: render_coeffs over the whole resident batch in
one call."""

import torch

from perfbench.kinds.render import Kind as Render


class Kind(Render):
    def step(self):
        from facerecon_tpu_torch.ops.render import render_coeffs
        from facerecon_tpu_torch.utils.coeffs import split_coeff
        with torch.no_grad():
            out = render_coeffs(split_coeff(self.coeffs, self.cfg), self.bfm,
                                self.cfg, inference=True)
        self.last = [(self.coeffs, out)]
'''


def test_a_new_cell_is_found_by_its_files(tmp_path):
    """A configuration, a traffic mix that drives a new entry point (its
    kind file), and a metric dropped into a copy, with their entries in
    BENCHMARK.json: the run drives the new kind, comes out correct and
    reports the cell's metrics, and the metric's reader is found."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    conf = json.loads((spec.HERE / "configs" / "bfm-render-512.json")
                      .read_text())
    conf["camera"]["image_size"] = 256
    (root / "perfbench" / "configs" / "bfm-render-256.json").write_text(
        json.dumps(conf))
    traffic = json.loads((spec.HERE / "traffic" / "render512.b256.json")
                         .read_text())
    (root / "perfbench" / "traffic" / "render256.b8.json").write_text(
        json.dumps(dict(traffic, kind="render_whole", batch=8,
                        microbatch=8)))
    (root / "perfbench" / "kinds" / "render_whole.py").write_text(NEW_KIND)
    (root / "perfbench" / "metrics" / "faces_seen.render.py").write_text(
        "def read(ctx):\n    return float(ctx['faces'])\n")
    bench["configs"].append({"name": "bfm-render-256", "source": "x",
                             "file": "perfbench/configs/bfm-render-256.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "render256.b8",
                               "config": "bfm-render-256",
                               "traffic": "render256.b8", "chips": 1,
                               "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "render_faces_s")[
        "workloads"].append("render256.b8")
    bench["per_layer"].append({"name": "faces_seen.render", "unit": "faces",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "render_faces_s",
                               "workloads": ["render256.b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("render256.b8", root=root)
    assert cell["config_file"]["camera"]["image_size"] == 256
    assert [m["name"] for m in cell["per_layer"]] == ["faces_seen.render"]
    assert spec.kind(cell).__module__ == "perfbench_kinds_render_whole"
    read = spec.reader("faces_seen.render", cell["here"])
    assert read({"faces": 8}) == 8.0
    r = run.run_cell(tiny.cell("render256.b8", root=root), SEED, 0.05,
                     False, CPU)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"render_faces_s", "setup_s"}


def test_the_harness_loads_no_jax():
    code = ("import sys, torch\n"
            "from perfbench import run, kinds, check, control, readers\n"
            "from perfbench.tests import tiny\n"
            "r = run.run_cell(tiny.cell('render512.b256'), 1, 0.01, False,"
            " torch.device('cpu'))\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "facerecon_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "facerecon_tpu.ops", sys)
    assert run.forbidden_modules() == ["facerecon_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("facerecon_tpu_torch", "facerecon_tpu",
                               "jax", "flax"), (path, name)
    code = ("import sys\n"
            "import perfbench.reference.pipeline, perfbench.reference.cnn\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'facerecon_tpu_torch', 'facerecon_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr


def test_nothing_reads_the_jax_benchmarks():
    for path in spec.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in ("benchmarks", "bench",
                                              "facerecon_tpu", "jax")
            assert not name.startswith("facerecon_tpu_torch.bench")
