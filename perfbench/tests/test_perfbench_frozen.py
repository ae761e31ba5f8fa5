"""The benchmark's frozen copies still equal the port's originals at
seed 0 (a later change to the program that moves them shows here; the
copies stay as they are, and the harness imports no original)."""

import numpy as np
import torch

from perfbench import frozen, tracing, work
from perfbench.tests.test_perfbench_work import _events

SIZES = {"n_id": 80, "n_exp": 64, "n_tex": 80, "n_angles": 3, "n_gamma": 27,
         "n_trans": 3, "n_vertices": 500, "n_faces": 900}


def test_workload_builders_equal_the_ports():
    from facerecon_tpu_torch import bench
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    assert np.array_equal(frozen.headline_images(3, 16),
                          bench.headline_images(3, 16))
    for a, b in zip(frozen.train_inputs(2, 3, 16), bench.train_inputs(2, 3,
                                                                       16)):
        assert np.array_equal(a, b)
    cfg = tiny_config()
    assert np.array_equal(
        frozen.sample_coeffs(np.random.default_rng(0), SIZES, 5),
        sample_coeffs(np.random.default_rng(0), cfg, 5))
    assert frozen.coeff_split(SIZES) == cfg.coeff_split


def test_mesh_maker_equals_the_ports():
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    ref = synthetic_bfm(tiny_config(), 0)
    mine = frozen.synthetic_mesh(SIZES, 0)
    for name, arr in mine.items():
        assert np.array_equal(arr, getattr(ref, name)), name


def test_timeline_equals_the_ports():
    from facerecon_tpu_torch import profile_trace
    evs = [e for e in _events() if e["cat"] != "user_annotation"]
    tr = tracing.Trace(evs)
    spans = [e for e in evs if e.get("ph") == "X"]

    def iv(cats):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]) for e in spans if e["cat"] in cats]
    assert tr.timeline == profile_trace.timeline(
        iv(profile_trace.DEVICE_CATS), iv(profile_trace.HOST_CATS), 10)


def test_needed_tests_equal_chip_smokes():
    """The count from the triangles' screen vertices equals chip_smoke's
    count from the program's setup rows on the same geometry."""
    import chip_smoke
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.ops.geometry import (coeffs_to_geometry,
                                                  device_bfm)
    from facerecon_tpu_torch.ops.binning import ndc_to_screen
    from facerecon_tpu_torch.ops.rasterize import band_windows
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    cfg = tiny_config()
    bfm = device_bfm(synthetic_bfm(cfg, 0), "cpu")
    c = torch.from_numpy(frozen.sample_coeffs(np.random.default_rng(3),
                                              SIZES, 2))
    g = coeffs_to_geometry(split_coeff(c, cfg), bfm, cfg)
    size = cfg.image_size
    win = band_windows(g.verts_ndc, bfm.raster_rows, bfm.raster_row_id,
                       size, size, cfg.tile_h, cfg.raster_cols)
    theirs = chip_smoke._needed_tests(win, size, size)
    mine = work.needed_tests(ndc_to_screen(g.verts_ndc, size, size),
                             bfm.faces, size, size)
    assert mine == theirs and mine[0] > 0
    assert work.TEST_OPS == chip_smoke.TEST_ADDS
    assert work.AXIS_OPS == chip_smoke.AXIS_OPS
