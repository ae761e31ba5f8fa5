"""Runs one cell of BENCHMARK.json once and prints the result's line.

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Set-up (timed as setup_s from the start of the process): the mesh, the
leaves and the traffic from the seed, the program built from them, and
one warm-up unit at the cell's own shapes (the first run in a checkout
also builds the program's kernels into facerecon_tpu_torch/_build/).
Then units run for --seconds on the host clock, and the window ends
with a synchronisation of the device (kinds/: a batch cell's units are
enqueued one after another; a frame waits for its results). With
--trace 1 more units run under torch.profiler once the window has
closed: one unit that warms the profiler up and is thrown away, then
the cell's trace_units, whose trace and the window give the per-layer
metrics. Once the window has closed, the peak memory is
read, the program is freed, and what the last unit produced is judged
against the plain reference (check.py). The last line of standard output
is one JSON object: correct, attempted, failed, metrics, device,
breakdown (--trace 1) and compared (each number judged beside its
limit), which also ends standard error.

Exits 1 without a result when no CUDA device is present or fewer than
the cell asks for, when the program cannot be imported, and when JAX,
jaxlib, flax or facerecon_tpu is loaded once the window has closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from perfbench import spec as specs, tracing, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "facerecon_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: facerecon_tpu_torch is not
    facerecon_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev,
             fault=None, t_start=None) -> dict:
    """One run of one cell; returns the result's dict. `fault`, where
    given, is called with the built cell to break the timed path (the
    harness's tests)."""
    from perfbench.kinds import sync
    t_start = T_START if t_start is None else t_start
    t = time.perf_counter()
    phases = {"start": t - t_start}
    kind = specs.kind(cell)(cell, seed, dev)
    phases.update(kind.phases)
    t = time.perf_counter()
    kind.setup()
    if fault is not None:
        fault(kind)
    sync(dev)
    phases["program"] = time.perf_counter() - t
    t = time.perf_counter()
    kind.warm()
    phases["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f" s; setup_s {setup_s:.3f}", file=sys.stderr)

    units = 0
    t0 = time.perf_counter()
    while True:
        kind.step()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0

    ctx = {"cell": cell, "kind": kind, "units": units,
           "faces": units * kind.unit_faces, "window_s": window_s}
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
                     "count": 1}
    metrics, breakdown = {}, None
    if trace:
        hooks = []
        n = cell["traffic"]["trace_units"]
        path = os.path.join(tempfile.gettempdir(),
                            f"perfbench_{cell['name']}_{seed}_trace.json")

        def warm():
            kind.step()
            sync(dev)

        def stretch():
            hooks.extend(kind.traced())
            for _ in range(n):
                kind.step()
            sync(dev)
        tr = tracing.capture(warm, stretch, path)
        for h in hooks:
            h.remove()
        ctx.update(trace=tr, trace_units=n)
        result_device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        print(f"traced stretch: {n} units, device busy {tr.busy_s:.6f} s of "
              f"{tr.window_s:.6f} s; window: {units} units in "
              f"{window_s:.6f} s", file=sys.stderr)
        breakdown = tr.breakdown()
        for m in cell["per_layer"]:
            value = specs.reader(m["name"], cell["here"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(kind, ctx, setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result_device["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    prog = kind.outputs()
    if isinstance(prog, dict) and kind.cnn:
        print("coefficient spread (std, target) " + spread_line(
            prog["coeff"], kind.sizes), file=sys.stderr)
    kind.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from perfbench import check
    numbers = kind.judge(prog)
    correct, compared = check.verdict(numbers,
                                      cell["traffic"]["limits"])
    result = {"correct": correct, "attempted": ctx["faces"], "failed": 0,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def spread_line(coeff, sizes) -> str:
    from perfbench import frozen
    target = frozen.coeff_spread(sizes)
    return " ".join(f"{g} {float(coeff[:, sl].std()):.4f} {target[g][1]:.4f}"
                    for g, sl in frozen.group_slices(sizes).items())


def end_to_end(kind, ctx, setup_s) -> dict:
    out = {"setup_s": setup_s}
    tr = ctx["cell"]["traffic"]
    if "rate_metric" in tr:
        out[tr["rate_metric"]] = ctx["faces"] / ctx["window_s"]
    if "latency_metric" in tr:
        import numpy as np
        ms = 1e3 * np.asarray(kind.latency)
        out[tr["latency_metric"]] = float(np.percentile(ms,
                                                        tr["percentile"]))
        print(f"latency ms over {len(ms)} requests: p50 "
              f"{np.percentile(ms, 50):.3f} p95 {np.percentile(ms, 95):.3f} "
              f"p99 {np.percentile(ms, 99):.3f} max {ms.max():.3f}",
              file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = specs.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
