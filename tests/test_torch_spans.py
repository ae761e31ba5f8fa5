"""The port's stage spans (profile_trace.span and mark) on the CPU at
tiny_config(), and the benchmark's readers of them (perfbench/spans.py)
on hand-made Chrome events:

  - with no profiler recording, Pipeline.reconstruct, render_coeffs and
    a train step enter no record_function of the port's (the same
    counter sees the port's spans once a profiler records);
  - under torch.profiler each render_coeffs call gives one fr.render
    span holding fr.geometry, fr.records and fr.binning, and each train
    step fr.cnn, fr.render, fr.losses, fr.backward holding exactly one
    fr.coeff_grad mark, and fr.optimizer, in that order;
  - the readers attribute a span's launches on any thread by interval,
    split fr.backward at the mark, clip the device's idle stretches to a
    span, divide by the fr.render and fr.backward counts, read None
    where a span is absent, flag device events that start before their
    span, and agree with profile_trace.stages.
"""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from facerecon_tpu_torch import profile_trace as PT
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.pipeline import make_pipeline, make_train_pipeline
from facerecon_tpu_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff
from perfbench import spans, tracing

torch.set_num_threads(2)
BATCH = 2
RENDER = ("fr.geometry", "fr.records", "fr.binning")


@pytest.fixture(scope="module")
def port():
    """The port's tiny config and assets, an inference pipeline, a train
    step on a depth-18 float32 BatchNorm pipeline, and inputs."""
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    gen = torch.Generator().manual_seed(5)
    images = torch.rand((BATCH, cfg.image_size, cfg.image_size, 3),
                        generator=gen)
    lmk = torch.rand((BATCH, 68, 2), generator=gen) * cfg.image_size
    infer = make_pipeline(cfg, assets, device="cpu", dtype=torch.float32,
                          depth=18)
    train = make_train_pipeline(cfg, assets, device="cpu",
                                dtype=torch.float32, depth=18)
    state = TrainState(*make_optimizer(cfg, train.model.parameters(), 10))
    step = make_train_step(train)
    coeff = infer.model(images).detach()
    paths = {
        "reconstruct": lambda: infer.reconstruct(images),
        "render": lambda: render_coeffs(split_coeff(coeff, cfg), infer.bfm,
                                        cfg, inference=True),
        "train_step": lambda: step(state, images, lmk)}
    return cfg, paths


def _port_entries(monkeypatch):
    """Patches record_function, as the port looks it up, to note each
    construction from a module of the port; returns the list of notes."""
    seen = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, name, *args, **kwargs):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("facerecon_tpu_torch"):
                seen.append((caller, name))
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    return seen


@pytest.mark.parametrize("path", ["reconstruct", "render", "train_step"])
def test_no_record_function_without_a_profiler(port, monkeypatch, path):
    _, paths = port
    seen = _port_entries(monkeypatch)
    assert not PT.recording()
    paths[path]()
    assert seen == []
    with profile(activities=[ProfilerActivity.CPU]):
        paths[path]()
    assert seen and all(name.startswith("fr.") for _, name in seen)


def _annotations(prof):
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in PT.trace_events(prof)
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("fr.")), key=lambda a: a[0])


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_each_render_call_gives_one_render_span_holding_its_stages(port):
    _, paths = port
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            paths["render"]()
    ann = _annotations(prof)
    renders = [a for a in ann if a[2] == "fr.render"]
    assert len(renders) == 2
    for r in renders:
        held = [a[2] for a in ann if a is not r and _inside(a, r)]
        # where autograd records nothing coeffs_to_geometry also lights
        # the mesh (the geometry kernel): one fr.geometry span
        assert sorted(held) == sorted(RENDER)
    assert {a[2] for a in ann} == {"fr.render", *RENDER}


def test_reconstruct_gives_the_cnn_span_then_the_render_span(port):
    _, paths = port
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        paths["reconstruct"]()
    ann = _annotations(prof)
    top = [a[2] for a in ann if a[2] in ("fr.cnn", "fr.render")]
    assert top == ["fr.cnn", "fr.render"]


def test_each_train_step_gives_its_spans_in_order(port):
    _, paths = port
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            paths["train_step"]()
    ann = _annotations(prof)
    outer = [a for a in ann if a[2] not in RENDER + ("fr.coeff_grad",)]
    assert [a[2] for a in outer] == 2 * ["fr.cnn", "fr.render", "fr.losses",
                                         "fr.backward", "fr.optimizer"]
    for a, b in zip(outer, outer[1:]):
        assert a[1] <= b[0]                      # one after another
    marks = [a for a in ann if a[2] == "fr.coeff_grad"]
    backwards = [a for a in outer if a[2] == "fr.backward"]
    assert len(marks) == 2
    for bw in backwards:
        assert sum(_inside(m, bw) for m in marks) == 1


# hand-made Chrome events: the calling thread (tid 1) renders twice and
# runs a backward whose launches come from the autograd thread (tid 2),
# where the mark falls; then the optimizer. Times in us.
def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 2, tid, corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return _x(cat, f"k{corr}", ts, dur, 7, corr)


EVENTS = [
    {"ph": "M", "name": "process_name"},
    _x("user_annotation", "fr.render", 0, 100),
    _x("user_annotation", "fr.geometry", 5, 15),
    _launch(10, 1), _kernel(30, 10, 1),
    _x("user_annotation", "fr.binning", 40, 20),
    _launch(45, 2), _kernel(50, 20, 2),
    _x("gpu_user_annotation", "fr.render", 30, 40, 7),
    _x("user_annotation", "fr.backward", 100, 100),
    _launch(120, 3, tid=2), _kernel(130, 20, 3),
    _x("user_annotation", "fr.coeff_grad", 160, 1, tid=2),
    _launch(170, 4, tid=2, name="cuLaunchKernel"), _kernel(175, 20, 4),
    _x("cuda_runtime", "cudaMemcpyAsync", 180, 2, 2, 5),
    _kernel(196, 2, 5, cat="gpu_memcpy"),
    _x("user_annotation", "fr.optimizer", 200, 60),
    _launch(210, 6), _kernel(250, 5, 6),
    _x("user_annotation", "fr.render", 300, 20),
    _launch(305, 7), _kernel(310, 8, 7),
]
# busy [30,40] [50,70] [130,150] [175,195] [196,198] [250,255] [310,318]
# from the window's start at 0: idle [0,30] [40,50] [70,130] [150,175]
# [195,196] [198,250] [255,310]


def _ctx(events=EVENTS, units=2):
    return {"trace": tracing.Trace(events), "trace_units": units}


def test_readers_attribute_launches_on_any_thread_by_interval(capsys):
    ctx = _ctx()
    # the autograd thread's launches fall inside fr.backward's interval
    # (per fr.backward span: one step)
    assert spans.reading(ctx, "fr.backward", "device_ms",
                         per="fr.backward") == pytest.approx(0.042)
    # the same-thread rule of Trace.span_device_seconds reads none of it
    assert ctx["trace"].span_device_seconds("fr.backward") == (1, 0.0)
    assert "7 device events launched inside the program's spans, 0 of " \
        "them start before" in capsys.readouterr().err


def test_readers_split_the_backward_at_the_mark():
    ctx = _ctx()
    before = spans.split_ms(ctx, "fr.backward", "fr.coeff_grad", "before",
                            per="fr.backward")
    after = spans.split_ms(ctx, "fr.backward", "fr.coeff_grad", "after",
                           per="fr.backward")
    assert before == pytest.approx(0.020)            # corr 3
    assert after == pytest.approx(0.022)             # corr 4 and the copy
    # a backward that holds no mark has no split
    no_mark = [e for e in EVENTS if e.get("name") != "fr.coeff_grad"]
    assert spans.split_ms(_ctx(no_mark), "fr.backward", "fr.coeff_grad",
                          "before", per="fr.backward") is None


def test_readers_clip_idle_to_the_span():
    ctx = _ctx()
    # fr.optimizer [200,260]: idle [200,250] and [255,260]; one step
    assert spans.reading(ctx, "fr.optimizer", "idle_ms",
                         per="fr.backward") == pytest.approx(0.055)
    # fr.render [0,100] and [300,320]: 30 + 10 + 30 + 10 us over 2 calls
    assert spans.reading(ctx, "fr.render", "idle_ms",
                         per="fr.render") == pytest.approx(0.040)
    # per traced unit (a request) when no span is the unit
    assert spans.reading(ctx, "fr.render", "idle_ms",
                         per=None) == pytest.approx(0.040)
    assert spans.reading(_ctx(units=4), "fr.render", "idle_ms",
                         per=None) == pytest.approx(0.020)


def test_readers_divide_by_the_unit_spans():
    ctx = _ctx()
    # fr.render: corr 1, 2, 7 = 38 us over 2 spans; 3 launches
    assert spans.reading(ctx, "fr.render", "device_ms",
                         per="fr.render") == pytest.approx(0.019)
    assert spans.reading(ctx, "fr.render", "launches",
                         per="fr.render") == 1.5
    assert spans.reading(ctx, "fr.binning", "device_ms",
                         per="fr.render") == pytest.approx(0.010)
    # the backward's launches: cudaLaunchKernel and cuLaunchKernel, no copy
    assert spans.reading(ctx, "fr.backward", "launches",
                         per="fr.backward") == 2


def test_readers_read_none_where_a_span_is_absent():
    ctx = _ctx()
    assert spans.reading(ctx, "fr.losses", "device_ms",
                         per="fr.backward") is None
    assert spans.reading(ctx, "fr.geometry", "device_ms",
                         per="fr.cnn") is None          # no unit span
    assert spans.reading({"trace": None}, "fr.render", "device_ms",
                         per="fr.render") is None
    assert spans.split_ms({}, "fr.backward", "fr.coeff_grad", "after",
                          per="fr.backward") is None
    # a trace of a program without spans reads None and raises nothing
    bare = [e for e in EVENTS if not str(e.get("name")).startswith("fr.")]
    assert spans.reading(_ctx(bare), "fr.render", "device_ms",
                         per="fr.render") is None


def test_readers_flag_device_events_before_their_span(capsys):
    early = EVENTS + [_x("user_annotation", "fr.losses", 400, 10),
                      _launch(405, 8), _kernel(395, 3, 8)]
    spans.stages(tracing.Trace(early))
    assert "8 device events launched inside the program's spans, 1 of " \
        "them start before" in capsys.readouterr().err
    assert PT.stages(early)["fr.losses"]["early"] == 1
    assert PT.stages(EVENTS)["fr.render"]["early"] == 0


@pytest.mark.parametrize("name,per", [
    ("fr.render", "fr.render"), ("fr.geometry", "fr.render"),
    ("fr.binning", "fr.render"), ("fr.backward", "fr.backward"),
    ("fr.optimizer", "fr.backward")])
def test_readers_agree_with_the_ports_stages(name, per):
    ctx = _ctx()
    st = PT.stages(EVENTS)
    n = st[per]["count"]
    for what in ("device_ms", "idle_ms", "launches"):
        assert spans.reading(ctx, name, what, per=per) == pytest.approx(
            st[name][what] / n)
    for side in ("before", "after"):
        assert spans.split_ms(ctx, "fr.backward", "fr.coeff_grad", side,
                              per="fr.backward") == pytest.approx(
            st[f"fr.backward {side} fr.coeff_grad"]["device_ms"])
