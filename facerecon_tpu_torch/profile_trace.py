"""Trace endpoint (twin of benchmarks/profile_trace.py).

Captures a torch.profiler trace of the flagship forward (regress + the
differentiable render, kernel K2 on the card), for inspection in
Perfetto or chrome://tracing:

  python -m facerecon_tpu_torch.profile_trace --out /tmp/fr_trace --batch 32
  python -m facerecon_tpu_torch.profile_trace --device cpu --batch 1 --steps 1

The model is the bf16 BatchNorm ResNet-50 as the reference initialises
it from seed 0 (zero head, eval mode: every image regresses the mean
face) at default_config() on synthetic_bfm(cfg, 0); the images come from
np.random.default_rng(0). One warm-up call runs outside the trace, ended
by a host read; then `--steps` calls run under the profiler, each inside
record_function("reconstruct") (the counterpart of the jitted function
that xprof shows as one step), ended by one host read. The Chrome trace
goes to <out>/trace.json. `--device` (default cuda) raises without a
card unless it is "cpu".

`summarize(events)` reads a trace's events: the device's busy time (the
union of its kernels' and copies' intervals), its share of the window
from the first host op to the last device event, the longest idle gaps
with the innermost host op open as each began, the device ops with the
most time, and the device events of each of the port's kernels.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import tempfile

import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.bench import headline_images
from facerecon_tpu_torch.graft_entry import reconstruct_fn
from facerecon_tpu_torch.ops import _build

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def setup(batch: int, device="cuda", cfg=None, assets=None,
          dtype=torch.bfloat16):
    """(fn, (model, bfm, images)): the traced function, without autograd
    (the reference's jitted forward keeps no residuals), and its inputs
    as the reference's main builds them."""
    forward, pipe = reconstruct_fn(cfg, assets, device, dtype)
    images = torch.from_numpy(headline_images(
        batch, pipe.cfg.image_size)).to(pipe.device)
    return torch.no_grad()(forward), (pipe.model, pipe.bfm, images)


def trace(out, batch: int = 32, steps: int = 3, device="cuda", cfg=None,
          assets=None):
    """Traces `steps` calls after one warm-up; returns (the path of
    <out>/trace.json, the profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = resolve_device(device)
    fn, args = setup(batch, dev, cfg, assets)
    res = fn(*args)             # the kernels build at their first launch
    float(res[0].sum())
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            with record_function("reconstruct"):
                res = fn(*args)
        float(res[0].sum())
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    return path, prof


def load_events(path) -> list:
    """A Chrome trace's events."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def trace_events(prof) -> list:
    """The profiler's events as its Chrome trace writes them."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return load_events(path)


def timeline(device, host, n_gaps: int = 5) -> dict:
    """device and host: (start, end, name) intervals in us. Returns
    busy_us (the union of the device intervals), window_us (the first
    host op's start, or the first device event's if earlier, to the last
    device event's end), busy_share, idle_us (window_us - busy_us) and
    gaps: the n_gaps longest idle stretches of the window, longest
    first, each (length us, start us, the innermost host op open at its
    start: the latest started, or None). Raises on an empty device
    list."""
    if not device:
        raise ValueError("the trace holds no device event")
    merged = []
    for s, e, _ in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    t0 = min([merged[0][0]] + [s for s, _, _ in host])
    window = merged[-1][1] - t0
    busy = sum(e - s for s, e in merged)
    starts = [t0] + [e for _, e in merged[:-1]]
    idle = sorted(((s - prev, prev) for prev, (s, _) in zip(starts, merged)
                   if s > prev), reverse=True)[:n_gaps]

    def open_at(t):
        live = [(s, -e, name) for s, e, name in host if s <= t < e]
        return max(live)[2] if live else None

    return {"busy_us": busy, "window_us": window,
            "busy_share": busy / window if window > 0 else 1.0,
            "idle_us": window - busy,
            "gaps": [(n, t, open_at(t)) for n, t in idle]}


def _runs(name: str, symbol: str) -> bool:
    """Whether a device event's (demangled) name is the device function
    `symbol`."""
    return re.search(rf"(^|[\s:]){symbol}[(<]", name) is not None


def summarize(events, n_top: int = 10, n_gaps: int = 5) -> dict:
    """A Chrome trace's events -> timeline()'s figures in ms (busy_ms,
    window_ms, idle_ms, busy_share, gaps as (ms, host op)), plus top: the
    n_top device ops with the most time, each (name, count, ms, share of
    the device time), and kernels: each port kernel -> its device events
    (of its function in _build.SYMBOLS). Raises when the trace holds no
    device event."""
    spans = [e for e in events if e.get("ph") == "X"]

    def intervals(cats):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e["name"]) for e in spans if e.get("cat") in cats]

    device = intervals(DEVICE_CATS)
    t = timeline(device, intervals(HOST_CATS), n_gaps)
    per_op = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        per_op[name][0] += 1
        per_op[name][1] += e - s
    total = sum(us for _, us in per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:n_top]
    return {
        "busy_ms": t["busy_us"] / 1e3, "window_ms": t["window_us"] / 1e3,
        "idle_ms": t["idle_us"] / 1e3, "busy_share": t["busy_share"],
        "gaps": [(us / 1e3, op) for us, _, op in t["gaps"]],
        "top": [(name, n, us / 1e3, us / total if total else 0.0)
                for name, (n, us) in top],
        "kernels": {k: sum(n for name, (n, _) in per_op.items()
                           if _runs(name, symbol))
                    for k, symbol in _build.SYMBOLS.items()}}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="/tmp/facerecon_trace")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain PyTorch "
                        "path)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    res = trace(args.out, args.batch, args.steps, args.device)
    print(f"trace written to {args.out}")
    return res


if __name__ == "__main__":
    main()
