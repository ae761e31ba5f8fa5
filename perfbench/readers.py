"""What the per-layer metric files (metrics/<name>.py) share: each reads
one number from the run's context (the window's units and seconds, the
traced stretch, the coefficients the traced units regressed or
rendered) or returns None when the run holds nothing to read."""

from __future__ import annotations

import torch

from perfbench import work
from perfbench.reference import geometry as refgeo

K3_SYMBOLS = ("count_rows", "scan_rows", "scatter_pixels", "sum_rows")


def mfu(ctx, with_cnn: bool, train: bool):
    """Least seconds a face (each precision's FLOPs over its data-sheet
    peak) over the window's seconds a face, in %."""
    kind = ctx["kind"]
    least = work.least_seconds_per_face(kind.cfgf, kind.n_vertices,
                                        with_cnn, train)
    return 100.0 * least * ctx["faces"] / ctx["window_s"]


def idle_pct(ctx):
    """Share of the window in which the device is idle, in %: 100 - the
    device's busy seconds a unit in the traced stretch over the window's
    seconds a unit. The busy time is the device's own, so it holds under
    the profiler; the window is untraced, so the profiler's host cost,
    which slows a unit whose pace the host sets, stays out of it."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    busy = tr.busy_s / ctx["trace_units"]
    return 100.0 * (1.0 - busy * ctx["units"] / ctx["window_s"])


def span_ms(ctx, name: str):
    """Device ms of the kernels launched inside each `name` span."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    n, secs = tr.span_device_seconds(name)
    return 1e3 * secs / n if n else None


def launches_per_unit(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return tr.launches() / ctx["trace_units"]


def roofline_pct(ctx, kernel: str, symbols):
    """The function's least time (work.raster_work over the data-sheet
    peaks) over the kernel's device time in the trace, in %: the bound of
    each launch from the coefficients its unit used, averaged, times the
    launches in the trace."""
    tr = ctx.get("trace")
    kind = ctx["kind"]
    if tr is None or not kind.captured:
        return None
    launches, secs = 0, 0.0
    for s in symbols:
        n, t = tr.kernel_seconds(s)
        secs += t
        launches = max(launches, n)
    if launches == 0 or secs <= 0:
        return None
    size = kind.size
    bounds = []
    with torch.no_grad():
        for coeff in kind.captured:
            g = refgeo.geometry(coeff.float(), kind.mesh, kind.cam,
                                kind.sizes)
            nbytes, ops = work.raster_work(kernel, g.screen, kind.mesh.faces,
                                           kind.n_vertices, size, size)
            bounds.append(work.bound_seconds(nbytes, ops))
    return 100.0 * sum(bounds) / len(bounds) * launches / secs
