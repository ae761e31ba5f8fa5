"""The port's trace endpoint (facerecon_tpu_torch/profile_trace.py) on the
CPU, against the reference's benchmarks/profile_trace.py:

  - its flags and their defaults are the reference's (read from the
    reference's source), plus --device, default cuda;
  - its images are the reference's draw, exactly;
  - the traced function (the BatchNorm model in eval, the
    differentiable render) against the reference's
    make_reconstruct_fn(pipe), tiny_config() in float32, the reference's
    init_params variables carried over (jax_params) with the head
    perturbed from a seed so the coefficients are not all zero:
    coefficients within 1e-4 x max|c|, image within 1e-4 where tri_id
    agrees, tri_id agreeing on >= 99.9% of pixels;
  - trace(..., device="cpu") writes a trace.json that parses, with one
    "reconstruct" span a traced call and no kernel launch; main prints
    the reference's line, and raises without a card unless asked for the
    CPU;
  - the trace reader (timeline, summarize) on hand-made intervals and
    events.
On the CPU the reference renders through rasterize_tiled (Pallas does not
run there) and the port through the plain versions of its kernels.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecon_tpu.pipeline import (init_params, make_pipeline,
                                    make_reconstruct_fn)

from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch import profile_trace as PT
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops import _build

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
BATCH = 2


def _reference_defaults():
    """--flag -> default of each add_argument call in the reference's
    benchmarks/profile_trace.py."""
    tree = ast.parse((ROOT / "benchmarks" / "profile_trace.py").read_text())
    return {node.args[0].value: next(
                ast.literal_eval(k.value) for k in node.keywords
                if k.arg == "default")
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"}


def test_flags_default_to_the_reference():
    want = _reference_defaults()
    assert want == {"--out": "/tmp/facerecon_trace", "--batch": 32,
                    "--steps": 3}
    args = vars(PT.parse_args([]))
    assert {f"--{k}": v for k, v in args.items() if k != "device"} == want
    assert args["device"] == "cuda"


@pytest.fixture(scope="module")
def traced(cfg, assets):
    """The port's traced function in float32 with the reference's
    init_params variables, the head perturbed from a seed, and the
    reference's make_reconstruct_fn(pipe) on the same variables: (the
    port's images, the reference's (coefficients, image, tri_id), the
    port's)."""
    rng = np.random.default_rng(3)
    pipe = make_pipeline(cfg, assets, dtype=jnp.float32)
    # jitted: the same variables, drawn in half the time of the eager init
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda key: init_params(pipe, key))(jax.random.PRNGKey(0)))
    head = variables["params"]["Dense_0"]
    head["kernel"] = (rng.standard_normal(head["kernel"].shape)
                      * 2e-3).astype(np.float32)
    head["bias"] = sample_coeffs(rng, cfg, 1)[0]
    fn, (model, bfm, images) = PT.setup(BATCH, "cpu", cfg, assets,
                                        dtype=torch.float32)
    model.load_state_dict(jax_params.train_state_dict(variables))
    assert not model.training
    cv, out = fn(model, bfm, images)
    assert not cv.requires_grad               # traced without autograd
    got = (cv.numpy(), out.image.numpy(), out.tri_id.numpy())
    ref_cv, _, ref_out = make_reconstruct_fn(pipe)(
        variables, pipe.bfm, jnp.asarray(images.numpy()))
    want = (np.asarray(ref_cv), np.asarray(ref_out.image),
            np.asarray(ref_out.tri_id))
    return images.numpy(), want, got


def test_images_are_the_reference_draw(cfg, traced):
    images, _, _ = traced
    want = np.asarray(jnp.asarray(np.random.default_rng(0).random(
        (BATCH, cfg.image_size, cfg.image_size, 3)), dtype=jnp.float32))
    np.testing.assert_array_equal(images, want)


def test_traced_function_matches_reference(cfg, traced):
    _, (rc, ri, rt), (gc, gi, gt) = traced
    assert gc.shape == (BATCH, cfg.n_coeff)
    assert gi.shape == ri.shape == (BATCH, cfg.image_size, cfg.image_size, 3)
    # the head is not zero: each image has coefficients of its own
    assert np.abs(rc[0] - rc[1]).max() > 1e-3
    assert np.abs(gc - rc).max() <= 1e-4 * np.abs(rc).max()
    agree = gt == rt
    assert agree.mean() >= 0.999
    assert (rt >= 0).mean() > 0.05                    # a face is drawn
    assert np.abs(gi - ri)[agree].max() <= 1e-4


def _spans(path, name="reconstruct"):
    return [e for e in PT.load_events(path)
            if e.get("cat") == "user_annotation" and e["name"] == name]


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path, cfg, assets):
    before = dict(_build.LAUNCHES)
    path, _ = PT.trace(str(tmp_path / "t"), batch=1, steps=2,
                       device="cpu", cfg=cfg, assets=assets)
    assert path == str(tmp_path / "t" / "trace.json")
    assert len(_spans(path)) == 2
    assert dict(_build.LAUNCHES) == before       # the plain versions
    # a CPU trace holds no device event, and the reader says so
    with pytest.raises(ValueError, match="no device event"):
        PT.summarize(PT.load_events(path))


def test_main_prints_the_reference_line(tmp_path, monkeypatch, capsys, cfg):
    """main at the command line's flags, default_config() swapped for
    tiny_config() to keep it small."""
    from facerecon_tpu_torch import config
    monkeypatch.setattr(config, "default_config", lambda: cfg)
    out = str(tmp_path / "o")
    path, _ = PT.main(["--out", out, "--batch", "1", "--steps", "1",
                       "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"trace written to {out}"
    assert len(_spans(path)) == 1


def test_main_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.main(["--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_timeline_takes_the_union_and_the_longest_gaps():
    # device: [0,1], [2,3] and [2.5,4] overlapping, [7,8] -> busy 4
    device = [(7, 8, "d"), (0, 1, "a"), (2.5, 4, "c"), (2, 3, "b")]
    host = [(-1, 10, "outer"), (3.5, 6, "inner"), (0.5, 1.5, "launch")]
    t = PT.timeline(device, host, n_gaps=2)
    assert t["busy_us"] == 4
    assert t["window_us"] == 9                  # from the first host op
    assert t["busy_share"] == pytest.approx(4 / 9)
    assert t["idle_us"] == 5
    # idle: [-1,0] 1, [1,2] 1, [4,7] 3; the innermost open op at each start
    assert t["gaps"] == [(3, 4, "inner"), (1, 1, "launch")]
    all_gaps = PT.timeline(device, host, n_gaps=10)["gaps"]
    assert sorted(all_gaps) == [(1, -1, "outer"), (1, 1, "launch"),
                                (3, 4, "inner")]
    assert sum(g[0] for g in all_gaps) == t["idle_us"]
    # no host op: the window starts at the first device event
    t = PT.timeline(device, [])
    assert t["window_us"] == 8 and t["gaps"][0] == (3, 4, None)


def test_timeline_raises_on_an_empty_device_list():
    with pytest.raises(ValueError, match="no device event"):
        PT.timeline([], [(0, 1, "aten::add")])


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_reads_kernels_copies_and_the_ports_kernels():
    k2 = ("(anonymous namespace)::raster_select_kernel(float const*, "
          "float const*, int const*)")
    events = [
        {"ph": "M", "name": "process_name"},
        _event("Trace", "PyTorch Profiler (0)", -50, 500),
        _event("user_annotation", "reconstruct", 10, 90),
        _event("cpu_op", "aten::conv2d", 55, 15),
        _event("gpu_user_annotation", "reconstruct", 10, 90),
        _event("kernel", k2, 20, 10),
        _event("kernel", k2, 40, 10),
        _event("kernel", "void at::native::elementwise_kernel<4>()", 45, 15),
        _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 80, 20),
        _event("kernel", "(anonymous namespace)::scan_rows(int*, int)",
               100, 0),
    ]
    s = PT.summarize(events, n_top=2, n_gaps=1)
    # busy: [20,30] + [40,60] + [80,100] = 50 us of the window [10,100]
    assert s["busy_ms"] == pytest.approx(0.05)
    assert s["window_ms"] == pytest.approx(0.09)
    assert s["busy_share"] == pytest.approx(5 / 9)
    assert s["idle_ms"] == pytest.approx(0.04)
    # idle [10,20], [30,40], [60,80]: conv2d is the innermost op at 60
    assert s["gaps"] == [(pytest.approx(0.02), "aten::conv2d")]
    assert [(n, c) for n, c, _, _ in s["top"]] == [(k2, 2), (
        "Memcpy DtoH (Device -> Pinned)", 1)]
    assert s["top"][0][3] == pytest.approx(20 / 55)
    # K3 counts by its last pass (sum_rows), which this trace lacks
    assert s["kernels"] == {"raster_shade": 0, "raster_select": 2,
                            "select_grad": 0, "raster_pos": 0,
                            "ctz_walk": 0, "bin_setup": 0,
                            "bin_windows": 0, "raster_texture": 0,
                            "geometry": 0, "records": 0, "uv_detail": 0,
                            "raster_texfetch": 0, "upconv": 0, "outconv": 0}


def test_summarize_reads_the_ports_stages():
    """summarize's stages on hand-made events: a render span holding a
    binning span, a backward whose launches come from another thread,
    cut at the fr.coeff_grad mark there, and an optimizer span."""
    def x(cat, name, ts, dur, tid=1, corr=None):
        e = _event(cat, name, ts, dur)
        e["tid"] = tid
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [
        x("user_annotation", "fr.render", 0, 100),
        x("user_annotation", "fr.binning", 40, 20),
        x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        x("kernel", "k1", 30, 10, tid=7, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        x("kernel", "k2", 50, 20, tid=7, corr=2),
        x("user_annotation", "fr.backward", 100, 100),
        x("cuda_runtime", "cudaLaunchKernel", 120, 2, tid=2, corr=3),
        x("kernel", "k3", 130, 20, tid=7, corr=3),
        x("user_annotation", "fr.coeff_grad", 160, 1, tid=2),
        x("cuda_driver", "cuLaunchKernel", 170, 2, tid=2, corr=4),
        x("kernel", "k4", 175, 20, tid=7, corr=4),
        x("cuda_runtime", "cudaMemcpyAsync", 180, 2, tid=2, corr=5),
        x("gpu_memcpy", "Memcpy DtoD", 196, 2, tid=7, corr=5),
        x("user_annotation", "fr.optimizer", 200, 60),
        x("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=6),
        x("kernel", "k6", 250, 5, tid=7, corr=6),
        x("user_annotation", "reconstruct", 0, 300),
    ]
    st = PT.summarize(events)["stages"]
    assert list(st) == ["fr.render", "fr.binning", "fr.backward",
                        "fr.coeff_grad", "fr.optimizer",
                        "fr.backward before fr.coeff_grad",
                        "fr.backward after fr.coeff_grad"]
    assert st["fr.render"] == {"count": 1, "host_ms": pytest.approx(0.1),
                               "device_ms": pytest.approx(0.03),
                               "launches": 2,
                               "idle_ms": pytest.approx(0.07), "early": 0}
    assert st["fr.binning"]["device_ms"] == pytest.approx(0.02)
    # the other thread's launches, by interval; the copy is no launch
    assert st["fr.backward"]["device_ms"] == pytest.approx(0.042)
    assert st["fr.backward"]["launches"] == 2
    assert st["fr.backward before fr.coeff_grad"]["device_ms"] == \
        pytest.approx(0.02)
    assert st["fr.backward after fr.coeff_grad"]["device_ms"] == \
        pytest.approx(0.022)
    assert st["fr.backward before fr.coeff_grad"]["host_ms"] == \
        pytest.approx(0.06)
    # idle [198,250] from the optimizer's start at 200; the window ends
    # at the last device event, 255
    assert st["fr.optimizer"]["idle_ms"] == pytest.approx(0.05)
    lines = PT.stage_lines(st)
    assert lines[0] == ("stage fr.render: 1 spans, host 0.100 ms, device "
                        "0.030 ms, 2 launches, idle 0.070 ms")


def test_main_prints_the_stages(tmp_path, monkeypatch, capsys, cfg):
    """main's stage lines (before its last line), on the CPU: the render
    and its stages, no device time and no idle reading."""
    from facerecon_tpu_torch import config
    monkeypatch.setattr(config, "default_config", lambda: cfg)
    PT.main(["--out", str(tmp_path / "o"), "--batch", "1", "--steps", "2",
             "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    stages = {ln.split(":")[0]: ln for ln in lines if ln.startswith("stage ")}
    assert set(stages) == {"stage fr.render", "stage fr.geometry",
                           "stage fr.records", "stage fr.binning"}
    assert stages["stage fr.render"].startswith("stage fr.render: 2 spans,")
    assert stages["stage fr.geometry"].startswith(
        "stage fr.geometry: 2 spans,")
    assert all(ln.endswith("device 0.000 ms, 0 launches, idle n/a")
               for ln in stages.values())
    assert lines[-1].startswith("trace written to")
