"""The program's own stage spans in the traced stretch, and what the
per-layer metric files (metrics/<name>.py) read from them.

The program opens `fr.`-named record_function spans at its layer
boundaries while a profiler records (facerecon_tpu_torch/profile_trace.
span and mark): fr.cnn, fr.render, and inside fr.render fr.geometry,
fr.records and fr.binning; in a training step fr.losses, fr.backward
(on the calling thread) with the mark fr.coeff_grad inside it (on the
autograd engine's thread, as the coefficients' gradient is complete),
and fr.optimizer. A program without them (the parent of the change that
added them) gives None for every reading here, and raises nothing.

The rules, a frozen restatement of profile_trace.stages:
  device ms  the kernels, copies and fills whose launch call (matched by
             the profiler's correlation id) falls inside a span of the
             name, on any thread of the process: the autograd engine
             launches a CUDA backward from a thread of its own;
  idle ms    the traced window's device-idle stretches (the complement
             of the busy union from the window's start, tracing.
             timeline's window) inside the spans' host intervals;
  launches   host launch calls (tracing.LAUNCH) inside the spans;
  split      a span cut at the mark inside it: what was launched before
             the mark and what after.
Spans of one name are merged first, so nested or repeated spans count
their contents once. Each reading is a total over the trace divided by
the unit's count: the fr.render spans for a microbatch, the fr.backward
spans for a training step, the traced units for a request.

Reading a trace also checks that every device event attributed to a
span starts after that span's host start (the profiler puts host and
device on one clock), and says on standard error how many do not."""

from __future__ import annotations

import bisect
import collections
import functools
import sys

from perfbench import tracing

PREFIX = "fr."


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length two unions share."""
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


class Stages:
    """The program's spans of one trace (a tracing.Trace), read once."""

    def __init__(self, tr):
        self.named = collections.defaultdict(list)
        calls, self.device = [], {}
        for e in tr.spans:
            ts = float(e["ts"])
            te = ts + float(e.get("dur", 0))
            corr = (e.get("args") or {}).get("correlation")
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                self.named[e["name"]].append((ts, te))
            elif cat in ("cuda_runtime", "cuda_driver"):
                calls.append((ts, corr, bool(tracing.LAUNCH.match(
                    e["name"]))))
            elif cat in tracing.DEVICE_CATS and corr is not None:
                us, first = self.device.get(corr, (0.0, te))
                self.device[corr] = (us + te - ts, min(first, ts))
        calls.sort(key=lambda c: c[0])
        self.calls = calls
        self.call_ts = [c[0] for c in calls]
        busy = _union((float(e["ts"]), float(e["ts"]) + float(e.get("dur",
                                                                   0)))
                      for e in tr.device)
        self.idle = []
        if busy:
            t0 = min([busy[0][0]] + [float(e["ts"]) for e in tr.host])
            edges = [t0] + [e for _, e in busy]
            self.idle = [[a, s] for a, (s, _) in zip(edges, busy) if s > a]
        if self.named:
            got = [self.read(iv) for iv in self.named.values()]
            print(f"spans: {len(set().union(*(r['events'] for r in got)))} "
                  f"device events launched inside the program's spans, "
                  f"{len(set().union(*(r['early'] for r in got)))} of them "
                  f"start before their span's host start", file=sys.stderr)

    def read(self, intervals) -> dict:
        """device_ms, idle_ms and launches of the union of intervals;
        events: the correlations of the device events counted, early:
        those of them that start before the interval their launch fell
        in."""
        merged = _union(intervals)
        corr, launches, early = set(), 0, set()
        for s, e in merged:
            lo = bisect.bisect_left(self.call_ts, s)
            hi = bisect.bisect_left(self.call_ts, e)
            for _, c, launch in self.calls[lo:hi]:
                launches += launch
                if c in self.device and c not in corr:
                    corr.add(c)
                    if self.device[c][1] < s:
                        early.add(c)
        return {"device_ms": sum(self.device[c][0] for c in corr) / 1e3,
                "idle_ms": _overlap(merged, self.idle) / 1e3,
                "launches": launches, "events": corr, "early": early}

    def count(self, name: str) -> int:
        return len(self.named.get(name, ()))

    def total(self, name: str, what: str):
        """A span's reading (device_ms, idle_ms or launches) over the
        trace; None when the trace holds no span of the name."""
        if not self.count(name):
            return None
        return self.read(self.named[name])[what]

    def split(self, within: str, mark: str, side: str):
        """Device ms launched inside the `within` spans before (side
        "before") or after ("after") the mark inside each; None unless
        every such span holds the mark."""
        parts = []
        for s, e in self.named.get(within, ()):
            cuts = sorted(t for t, _ in self.named.get(mark, ())
                          if s <= t < e)
            if not cuts:
                return None
            parts.append((s, cuts[0]) if side == "before" else (cuts[-1], e))
        if not parts:
            return None
        return self.read(parts)["device_ms"]


@functools.lru_cache(maxsize=1)
def stages(tr) -> Stages:
    return Stages(tr)


def _per(ctx, value, per):
    """value over the unit's count: the `per` spans, or the traced units
    when per is None."""
    if value is None:
        return None
    n = ctx["trace_units"] if per is None else stages(ctx["trace"]).count(per)
    return value / n if n else None


def reading(ctx, name: str, what: str, per):
    """A span's device_ms, idle_ms or launches a unit; None without a
    trace or a span of the name."""
    if ctx.get("trace") is None:
        return None
    return _per(ctx, stages(ctx["trace"]).total(name, what), per)


def split_ms(ctx, within: str, mark: str, side: str, per: str):
    """Device ms a unit launched inside `within` before or after `mark`."""
    if ctx.get("trace") is None:
        return None
    return _per(ctx, stages(ctx["trace"]).split(within, mark, side), per)
