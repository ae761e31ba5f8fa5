"""Finds a cell's files by name: BENCHMARK.json at the checkout's root,
configs/<config>.json and traffic/<cell>.json beside this file, the
entry point the traffic file names in kinds/<kind>.py, and the metric
readers in metrics/<metric>.py."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, root=ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its traffic file under
    `traffic`, its configuration file under `config_file`, and its
    end-to-end and per-layer metrics under `end_to_end` and
    `per_layer`."""
    here = Path(root) / HERE.name
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def mine(m):
        return name in m.get("workloads", [name])
    return dict(entry, traffic=load_json(here / "traffic" / f"{name}.json"),
                config_file=load_json(Path(root) / conf["file"]),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                here=str(here))


def _load(folder: str, name: str, here):
    path = Path(here) / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here=HERE):
    """The `read(ctx)` function of metrics/<metric>.py."""
    return _load("metrics", metric, here).read


def kind(cell: dict):
    """The class `Kind` of kinds/<kind>.py, the entry point that the
    cell's traffic file names under "kind"."""
    return _load("kinds", cell["traffic"]["kind"], cell["here"]).Kind
