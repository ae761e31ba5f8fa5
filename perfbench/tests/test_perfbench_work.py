"""The yardstick's own arithmetic on the CPU: seeds, the head's
calibration, the FLOP and byte counts, the needed tests and the trace
reader."""

import numpy as np
import pytest
import torch

from perfbench import frozen, tracing, weights, work
from perfbench.reference import cnn, raster

SIZES = {"n_id": 80, "n_exp": 64, "n_tex": 80, "n_angles": 3, "n_gamma": 27,
         "n_trans": 3, "n_vertices": 500, "n_faces": 900}
INIT = {"bn_last_scale": [0.1, 0.3], "bn_bias_std": 0.05,
        "bn_mean_std": 0.05, "bn_var": [0.8, 1.25]}
BIG_SEED = 2 ** 31 + 12345


def test_traffic_is_deterministic_by_seed():
    a = frozen.headline_images(2, 16, BIG_SEED)
    assert np.array_equal(a, frozen.headline_images(2, 16, BIG_SEED))
    assert not np.array_equal(a, frozen.headline_images(2, 16, BIG_SEED + 1))
    c = frozen.sample_coeffs(np.random.default_rng(BIG_SEED), SIZES, 3)
    assert np.array_equal(c, frozen.sample_coeffs(
        np.random.default_rng(BIG_SEED), SIZES, 3))
    im, lmk = frozen.train_inputs(2, 2, 16, BIG_SEED)
    im2, lmk2 = frozen.train_inputs(2, 2, 16, BIG_SEED)
    assert np.array_equal(im, im2) and np.array_equal(lmk, lmk2)
    assert not np.array_equal(im[0], im[1])


def test_weights_are_deterministic_by_seed():
    a = weights.make_leaves(257, BIG_SEED, "cpu", INIT)
    b = weights.make_leaves(257, BIG_SEED, "cpu", INIT)
    c = weights.make_leaves(257, BIG_SEED + 1, "cpu", INIT)
    assert sorted(a) == sorted(n for n, _, _ in cnn.layout(257))
    assert all(tuple(a[n].shape) == s for n, s, _ in cnn.layout(257))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.weight"], c["stem.weight"])
    last = a["blocks.0.bn2.weight"]
    assert float(last.min()) >= 0.1 and float(last.max()) <= 0.3
    assert float(a["blocks.0.bn0.running_var"].min()) >= 0.8


def test_head_calibration_reaches_the_target_spread():
    leaves = weights.make_leaves(257, 7, "cpu", INIT)
    images = torch.from_numpy(frozen.headline_images(8, 64, [7, 1]))
    with torch.no_grad():
        feats = cnn.features(leaves, images, train=False)
    weights.calibrate_head(leaves, feats, SIZES)
    with torch.no_grad():
        coeff = cnn.head(leaves, feats)
    spread = frozen.coeff_spread(SIZES)
    for g, sl in frozen.group_slices(SIZES).items():
        mean, std = spread[g]
        got = coeff[:, sl]
        assert abs(float(got.var(0, unbiased=False).mean().sqrt()) - std) \
            < 1e-3 * max(std, 1e-3)
        assert abs(float(got.mean()) - mean) < 1e-4


def test_resnet50_flops():
    assert work.cnn_flops(224, 257) / 2 / 1e9 == pytest.approx(4.0877,
                                                               abs=1e-3)
    # the 7x7 stride-2 stem alone: 112 x 112 x 64 x 3 x 49 MACs
    assert work.cnn_flops(224, 257) > 2 * 112 * 112 * 64 * 3 * 49
    assert work.basis_flops(35721, SIZES) == 2 * 3 * 35721 * 224


def _mesh():
    """Two triangles in an 8 x 8 image: one of 3 x 2 px centres in its box,
    one degenerate."""
    screen = torch.tensor([[[1.0, 1.0], [4.0, 1.0], [1.0, 3.0],
                            [5.0, 5.0], [5.0, 5.0], [5.0, 5.0]]])
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    return screen, faces


def test_needed_tests_and_bytes_on_a_hand_built_mesh():
    screen, faces = _mesh()
    tests, ops = work.needed_tests(screen, faces, 8, 8)
    # centres x in {1.5, 2.5, 3.5}, y in {1.5, 2.5}; the degenerate none
    assert tests == 6
    assert ops == 7 * 6 + 4 * (3 + 2)
    nbytes, ops1 = work.raster_work("shade", screen, faces, 6, 8, 8)
    assert nbytes == 6 * 24 + 64 * 28 + 2 * 12 and ops1 == ops
    nbytes, _ = work.raster_work("select", screen, faces, 6, 8, 8)
    assert nbytes == 6 * 24 + 64 * 84 + 6 * 4 + 2 * 12
    assert work.raster_work("grad", screen, faces, 6, 8, 8) == (
        64 * 72 + 2 * 68, 0)
    assert work.bound_seconds(3.35e12, 0) == pytest.approx(1.0)


def test_reference_raster_on_a_hand_built_mesh():
    screen, faces = _mesh()
    depth = torch.tensor([[2.0, 2.0, 2.0, 1.0, 1.0, 1.0]])
    tri = raster.winners(screen, depth, faces, 8, 8)
    covered = {(int(y), int(x)) for y, x in torch.nonzero(tri[0] == 0)}
    # inside x >= 1, y >= 1, x/3 + y/2 <= 1 (from vertex (1, 1))
    want = {(y, x) for y in range(8) for x in range(8)
            if (x + 0.5 - 1) / 3 + (y + 0.5 - 1) / 2 <= 1
            and x + 0.5 >= 1 and y + 0.5 >= 1}
    assert covered == want
    assert int((tri[0] == 1).sum()) == 0


def _events():
    """Two spans, four kernels (one a copy), launch calls with their
    correlation ids, on one host thread; times in us."""
    def x(cat, name, ts, dur, corr=None, tid=1):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    return [
        x("cpu_op", "aten::conv", 0, 100),
        x("user_annotation", "cnn", 0, 50),
        x("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=2),
        x("user_annotation", "cnn", 60, 20),
        x("cuda_runtime", "cudaMemcpyAsync", 62, 5, corr=3),
        x("cuda_driver", "cuLaunchKernel", 70, 5, corr=4),
        x("cuda_runtime", "cudaGraphLaunch", 90, 2, corr=5),
        x("kernel", "void raster_shade_kernel<3>(float*)", 30, 40, corr=1,
          tid=7),
        x("kernel", "gemm", 65, 10, corr=2, tid=7),
        x("gpu_memcpy", "Memcpy HtoD", 80, 10, corr=3, tid=7),
        x("kernel", "sum_rows(float*)", 120, 30, corr=4, tid=7),
    ]


def test_trace_reader_on_a_synthetic_event_list():
    tr = tracing.Trace(_events())
    t = tr.timeline
    # device union [30, 75) + [80, 90) + [120, 150): 85 us busy of 150
    assert t["busy_us"] == 85 and t["window_us"] == 150
    # idle [90, 120) under the graph launch, [0, 30) under the span
    # (the innermost op open), [75, 80) under the second span
    assert t["gaps"] == [(30, 90, "cudaGraphLaunch"), (30, 0, "cnn"),
                         (5, 75, "cnn")]
    assert tr.busy_s == pytest.approx(85e-6)
    assert tr.kernel_seconds("raster_shade_kernel") == (1, 40e-6)
    assert tr.kernel_seconds("sum_rows") == (1, 30e-6)
    # spans: kernels 1, 2 launched in the first, the copy 3 and the
    # kernel 4 in the second
    n, secs = tr.span_device_seconds("cnn")
    assert n == 2 and secs == pytest.approx((40 + 10 + 10 + 30) * 1e-6)
    assert tr.launches() == 4        # three kernel launches, one graph
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["void raster_shade_kernel<3>(float*)",
                                   pytest.approx(40e-6)]
    assert len(bd["idle_gaps"]) <= 10


def test_trace_reader_refuses_a_trace_without_device_events():
    with pytest.raises(ValueError):
        tracing.Trace([e for e in _events() if e["cat"] not in
                       tracing.DEVICE_CATS])


def test_idle_share_reads_the_untraced_window():
    """device_idle_pct: the busy time a unit in the trace over the
    window's seconds a unit, not the traced stretch's own share."""
    from perfbench import readers
    tr = tracing.Trace(_events())          # 85 us busy in a 150-us stretch
    ctx = {"trace": tr, "trace_units": 1, "units": 1000,
           "window_s": 0.1}                # 100 us a unit, untraced
    assert readers.idle_pct(ctx) == pytest.approx(15.0)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(43.333,
                                                                 abs=1e-3)
    assert readers.idle_pct({"units": 1, "window_s": 1.0}) is None
