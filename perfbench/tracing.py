"""The trace: a torch.profiler stretch of the timed path, and what the
per-layer readers take from it.

`timeline` is a frozen copy of facerecon_tpu_torch.profile_trace's: the
union of the device's kernels, copies and fills, the window from the
first host op (or device event) to the last device event, and the
longest idle gaps with the innermost host op open as each began.
`Trace` adds the sums by device op, the device time of the kernels that
host spans launched (by the profiler's correlation ids), and the count
of host launch calls."""

from __future__ import annotations

import collections
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel"
                    r"|cuLaunchKernelEx|cudaGraphLaunch|cuGraphLaunch|"
                    r"cudaLaunchCooperativeKernel)(_v\d+|_ptsz)?$")


def timeline(device, host, n_gaps: int = 5) -> dict:
    """device and host: (start, end, name) intervals in us. Returns
    busy_us, window_us, busy_share, idle_us and gaps: the n_gaps longest
    idle stretches, longest first, each (length us, start us, the
    innermost host op open at its start or None). Raises on an empty
    device list."""
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


class Trace:
    """A Chrome trace's complete events, read once."""

    def __init__(self, events: list, n_gaps: int = 10):
        spans = [e for e in events if e.get("ph") == "X"]
        self.spans = spans
        self.device = [e for e in spans if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in spans if e.get("cat") in HOST_CATS]

        def iv(evs):
            return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"]) for e in evs]
        self.timeline = timeline(iv(self.device), iv(self.host), n_gaps)

    @property
    def busy_s(self) -> float:
        return self.timeline["busy_us"] / 1e6

    @property
    def window_s(self) -> float:
        return self.timeline["window_us"] / 1e6

    def by_op(self) -> list:
        """[(device op name, count, seconds)], most time first."""
        acc = collections.defaultdict(lambda: [0, 0.0])
        for e in self.device:
            acc[e["name"]][0] += 1
            acc[e["name"]][1] += float(e.get("dur", 0)) / 1e6
        return sorted(((k, n, s) for k, (n, s) in acc.items()),
                      key=lambda r: -r[2])

    def kernel_seconds(self, symbol: str):
        """(launches, seconds) of the device function named `symbol`."""
        pat = re.compile(rf"(^|[\s:]){re.escape(symbol)}[(<]|^{re.escape(symbol)}$")
        hits = [e for e in self.device if e.get("cat") == "kernel"
                and pat.search(e["name"])]
        return len(hits), sum(float(e.get("dur", 0)) for e in hits) / 1e6

    def span_device_seconds(self, name: str):
        """(spans, seconds): the host spans named `name` and the device
        time of the kernels, copies and fills launched inside them."""
        spans = [e for e in self.host if e["name"] == name
                 and e.get("cat") == "user_annotation"]
        corr = set()
        for sp in spans:
            s0, s1 = float(sp["ts"]), float(sp["ts"]) + float(sp["dur"])
            for e in self.host:
                if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and s0 <= float(e["ts"]) <= s1
                        and e.get("tid") == sp.get("tid")):
                    c = (e.get("args") or {}).get("correlation")
                    if c is not None:
                        corr.add(c)
        secs = sum(float(e.get("dur", 0)) for e in self.device
                   if (e.get("args") or {}).get("correlation") in corr)
        return len(spans), secs / 1e6

    def launches(self) -> int:
        """Host calls that launch a kernel or a captured graph (one
        each)."""
        return sum(1 for e in self.host
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and LAUNCH.match(e["name"]))

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": [[name, s] for name, _, s in self.by_op()[:n]],
                "idle_gaps": [[op or "(no host op)", us / 1e6]
                              for us, _, op in self.timeline["gaps"][:n]]}


def capture(warm, run_stretch, path: str) -> Trace:
    """Runs `warm()` under torch.profiler's warm-up step, which traces and
    throws the events away (the profiler's own start-up stays out of the
    trace), then `run_stretch()` under its recording step, host and
    device; writes that step's Chrome trace to `path` and reads it
    back."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        prof.step()
        run_stretch()
        prof.step()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"])
