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
most time, the device events of each of the port's kernels, and the
port's stages.

The stages are spans the port opens with `span(name)` (and instants it
leaves with `mark(name)`) while a profiler records, and only then: with
none recording each costs one check. `stages(events)` reads them: for
each name its spans' host time, the device time and launch calls of
what they launched (on any thread), and the device's idle time within
them; `main` prints it before its last line. The port's spans:
  fr.cnn        the regressor's forward (Pipeline.reconstruct,
                pipeline.regress_coeffs)
  fr.render     ops/render.render_coeffs, one a call
  fr.geometry   coeffs_to_geometry (the basis products and the geometry
                kernel where autograd records nothing), and sh.illuminate
                on the differentiable path, inside fr.render
  fr.records    the render records, inside fr.render
  fr.binning    rasterize.band_windows, inside fr.render
  fr.losses     the train step's total_loss
  fr.backward   the train step's backward, on the calling thread
  fr.coeff_grad (a mark) the coefficients' gradient is complete: the
                render's backward ends and the CNN's begins
  fr.optimizer  the train step's Adam step and schedule step
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import re
import tempfile

import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.ops import _build

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
CALL_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel"
                    r"|cuLaunchKernelEx|cudaGraphLaunch|cuGraphLaunch|"
                    r"cudaLaunchCooperativeKernel)(_v\d+|_ptsz)?$")
# the port's stage spans carry this prefix; a mark splits the span named
# beside it into what was launched before it and what after
PREFIX = "fr."
SPLITS = {"fr.coeff_grad": "fr.backward"}

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A stage of the port: record_function(name) while a profiler
    records, so the span lands in its trace beside the device events;
    otherwise one shared no-op context."""
    if recording():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def mark(name: str) -> None:
    """An instant of the port: record_function(name) entered and left at
    once while a profiler records; nothing otherwise."""
    if recording():
        with torch.autograd.profiler.record_function(name):
            pass


def setup(batch: int, device="cuda", cfg=None, assets=None,
          dtype=torch.bfloat16):
    """(fn, (model, bfm, images)): the traced function, without autograd
    (the reference's jitted forward keeps no residuals), and its inputs
    as the reference's main builds them."""
    from facerecon_tpu_torch.bench import headline_images
    from facerecon_tpu_torch.graft_entry import reconstruct_fn
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


def _union(intervals) -> list:
    """Sorted, disjoint [start, end] lists covering the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


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
    merged = _union((s, e) for s, e, _ in device)
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


def _overlap(a, b) -> float:
    """The length two unions (_union) share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stages(events) -> dict:
    """The port's stage spans (user annotations named PREFIX...) of a
    Chrome trace: name -> count (spans), host_ms (the union of their
    intervals), device_ms (the kernels, copies and fills whose launch
    call, matched by correlation id, falls inside one of them, on any
    thread: the autograd engine launches a CUDA backward from a thread
    of its own), launches (launch calls inside them), idle_ms (the
    window's device-idle stretches inside them; None without device
    events) and early (device events that start before their span's
    host start: 0 on one clock). Each mark of SPLITS (mark -> span)
    adds the rows "<span> before <mark>" and "<span> after <mark>", each
    span of that name cut at the marks inside it.
    Spans in the order they first began, then the splits. Totals over
    the trace: divide by a count for a unit."""
    spans = [e for e in events if e.get("ph") == "X"]
    named = collections.defaultdict(list)
    calls, device = [], {}
    for e in spans:
        ts = float(e["ts"])
        te = ts + float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            named[e["name"]].append((ts, te))
        elif e.get("cat") in CALL_CATS:
            calls.append((ts, corr, bool(LAUNCH.match(e["name"]))))
        elif e.get("cat") in DEVICE_CATS and corr is not None:
            us, first = device.get(corr, (0.0, te))
            device[corr] = (us + te - ts, min(first, ts))
    calls.sort(key=lambda c: c[0])
    call_ts = [c[0] for c in calls]
    idle = None
    dev_iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in spans if e.get("cat") in DEVICE_CATS]
    if dev_iv:
        busy = _union(dev_iv)
        t0 = min([busy[0][0]] + [float(e["ts"]) for e in spans
                                 if e.get("cat") in HOST_CATS])
        edges = [t0] + [e for _, e in busy]
        idle = [[a, s] for a, (s, _) in zip(edges, busy) if s > a]

    def row(intervals, count):
        merged = _union(intervals)
        corr, launches, early = set(), 0, 0
        for s, e in merged:
            lo, hi = (bisect.bisect_left(call_ts, s),
                      bisect.bisect_left(call_ts, e))
            for _, c, launch in calls[lo:hi]:
                launches += launch
                if c in device and c not in corr:
                    corr.add(c)
                    early += device[c][1] < s
        return {"count": count,
                "host_ms": sum(e - s for s, e in merged) / 1e3,
                "device_ms": sum(device[c][0] for c in corr) / 1e3,
                "launches": launches,
                "idle_ms": None if idle is None
                else _overlap(merged, idle) / 1e3,
                "early": early}

    out = {name: row(named[name], len(named[name]))
           for name in sorted(named, key=lambda n: min(named[n]))}
    for m, within in SPLITS.items():
        if m not in named or within not in named:
            continue
        before, after = [], []
        for s, e in named[within]:
            cuts = sorted(t for t, _ in named[m] if s <= t < e)
            if cuts:
                before.append((s, cuts[0]))
                after.append((cuts[-1], e))
        out[f"{within} before {m}"] = row(before, len(before))
        out[f"{within} after {m}"] = row(after, len(after))
    return out


def stage_lines(st: dict) -> list:
    """One line a row of stages()."""
    lines = []
    for name, r in st.items():
        idle = ("n/a" if r["idle_ms"] is None
                else f"{r['idle_ms']:.3f} ms")
        lines.append(f"stage {name}: {r['count']} spans, host "
                     f"{r['host_ms']:.3f} ms, device {r['device_ms']:.3f} "
                     f"ms, {r['launches']} launches, idle {idle}")
    return lines


def summarize(events, n_top: int = 10, n_gaps: int = 5) -> dict:
    """A Chrome trace's events -> timeline()'s figures in ms (busy_ms,
    window_ms, idle_ms, busy_share, gaps as (ms, host op)), plus top: the
    n_top device ops with the most time, each (name, count, ms, share of
    the device time), kernels: each port kernel -> its device events
    (of its function in _build.SYMBOLS), and stages: the port's spans
    (stages()). Raises when the trace holds no device event."""
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
                    for k, symbol in _build.SYMBOLS.items()},
        "stages": stages(events)}


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
    for line in stage_lines(stages(load_events(res[0]))):
        print(line)
    print(f"trace written to {args.out}")
    return res


if __name__ == "__main__":
    main()
