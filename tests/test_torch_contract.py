"""The port's §9.5 contract path (facerecon_tpu_torch/ops/rasterize.py:
rasterize_positions, rasterize_batch on kernel K4's plain version) and
its oracles (facerecon_tpu_torch/oracle.py, utils/native_oracle.py)
against the JAX reference, at tiny_config().

Bars:
- rasterize_positions against the reference's (its Pallas kernel in
  interpret mode, as tests/test_rasterize_pallas.py runs it): tri_id,
  blo and bn exactly equal; setup exactly equal to the reference's
  _band_windows, and within 1e-5 relative to the setup that its jitted
  rasterize_positions returns (XLA fuses the setup arithmetic there
  differently, a few ulps in the w and depth forms); zbuf +inf at the
  same pixels and within 2.5e-7 relative (2 float32 ulps) elsewhere.
  Both run the same
  float32 z-test, but XLA's CPU backend contracts the interpret-mode
  kernel's depth form za*qx + zb*qy + z0 into fused multiply-adds (a few
  pixels a batch differ by one ulp), while the port rounds every multiply
  and add, as its CUDA kernel does (-fmad=false), so that kernel and
  plain version agree bit for bit.
- rasterize_batch against the reference's: tri_id exactly equal, zbuf
  as above, bary within 1e-6 (the port decodes the winner's f32 setup
  row; the reference carries the same fields in exact bf16 parts and
  XLA contracts the decode's multiply-adds). On the asset row order, the
  identity order, a shuffled face order and with cull_backfaces=True.
- both against the port's numpy oracle (for culling, with the culled
  faces made degenerate): tri_id exactly equal, bary within 1e-5 and zbuf
  within 1e-5 relative (the oracle blends the corner depths with edge
  functions, the port evaluates the anchored affine forms; at depths
  near 10 they differ by up to ~1.1e-6 relative, a few ulps).
- the port's oracle.rasterize and oracle.render_coeffs equal the
  reference's bit for bit (a copy of the same numpy code);
- the port's native oracle equals its numpy oracle bit for bit (same
  float32 operation order, -ffp-contract=off); skipped only without g++.
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecon_tpu import oracle as ref_oracle
from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch import oracle
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.ops import rasterize as TR
from facerecon_tpu_torch.utils import native_oracle
from facerecon_tpu_torch.utils.bfm import synthetic_bfm

from conftest import make_coeff

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _verts(cfg, assets, seed, batch):
    """Screen-space vertices from the reference's geometry, as numpy."""
    bfm = G.device_bfm(assets)
    coeff = make_coeff(cfg, np.random.default_rng(seed), batch=batch)
    geom = G.coeffs_to_geometry(split_coeff(jnp.asarray(coeff), cfg), bfm,
                                cfg)
    return np.asarray(geom.verts_ndc)


def _order(cfg, assets, case):
    """(n_cols, row_faces, row_id, cull) for a case, as numpy (None for
    the identity order)."""
    if case == "identity":
        return 1, None, None, False
    if case == "shuffled":
        perm = np.random.default_rng(3).permutation(assets.n_faces)
        return cfg.raster_cols, assets.faces[perm], perm.astype(np.int32), \
            False
    return (cfg.raster_cols, assets.raster_rows, assets.raster_row_id,
            case == "cull")


def _both(fn_ref, fn_port, cfg, assets, vndc, case):
    n_cols, rows, rid, cull = _order(cfg, assets, case)
    h = w = cfg.image_size
    kw = dict(height=h, width=w, tile_h=cfg.tile_h, n_cols=n_cols,
              cull_backfaces=cull)
    ref = fn_ref(jnp.asarray(vndc), jnp.asarray(assets.faces), **kw,
                 row_faces=None if rows is None else jnp.asarray(rows),
                 row_id=None if rid is None else jnp.asarray(rid))
    tkw = {} if rows is None else dict(
        row_faces=torch.from_numpy(rows.astype(np.int64)),
        row_id=torch.from_numpy(rid.astype(np.int64)))
    got = fn_port(torch.from_numpy(vndc),
                  torch.from_numpy(assets.faces.astype(np.int64)), **kw,
                  **tkw)
    return ref, got


def _check_zbuf(got, ref):
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=2.5e-7, atol=0)


def _check_oracle(vndc, faces, cfg, tri_id, bary, zbuf):
    h = w = cfg.image_size
    for b in range(vndc.shape[0]):
        tid_o, bary_o, z_o = oracle.rasterize(vndc[b], faces, h, w)
        assert (tid_o >= 0).mean() > 0.1
        np.testing.assert_array_equal(tri_id[b], tid_o)
        cov = tid_o >= 0
        np.testing.assert_allclose(zbuf[b][cov], z_o[cov], rtol=1e-5,
                                   atol=0)
        assert np.all(np.isinf(zbuf[b][~cov]))
        if bary is not None:
            np.testing.assert_allclose(bary[b], bary_o, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["raster_rows", "identity"])
def test_rasterize_positions_matches_reference(cfg, assets, case):
    vndc = _verts(cfg, assets, 7, batch=2)
    ref, got = _both(RP.rasterize_positions, TR.rasterize_positions, cfg,
                     assets, vndc, case)
    tid, setup, zbuf, (blo, bn) = (t for t in got)
    rtid, rsetup, rzbuf, (rblo, rbn) = ref
    np.testing.assert_array_equal(tid.numpy(), np.asarray(rtid))
    _check_zbuf(zbuf.numpy(), np.asarray(rzbuf))
    np.testing.assert_array_equal(blo.numpy(), np.asarray(rblo))
    np.testing.assert_array_equal(bn.numpy(), np.asarray(rbn))
    n_cols, rows, rid, _ = _order(cfg, assets, case)
    rows, rid = (assets.faces, np.arange(assets.n_faces)) if rows is None \
        else (rows, rid)
    _, _, bsetup = RP._band_windows(
        jnp.asarray(vndc), jnp.asarray(rows), jnp.asarray(rid),
        cfg.image_size, cfg.image_size, cfg.tile_h, n_cols, False)
    np.testing.assert_array_equal(setup.numpy(), np.asarray(bsetup))
    np.testing.assert_allclose(setup.numpy(), np.asarray(rsetup), rtol=1e-5,
                               atol=0)
    _check_oracle(vndc, assets.faces, cfg, tid.numpy(), None, zbuf.numpy())


@pytest.mark.parametrize("case", ["raster_rows", "identity", "shuffled",
                                  "cull"])
def test_rasterize_batch_matches_reference(cfg, assets, case):
    vndc = _verts(cfg, assets, 8, batch=1)
    ref, got = _both(RP.rasterize_batch, TR.rasterize_batch, cfg, assets,
                     vndc, case)
    tid, bary, zbuf = (t.numpy() for t in got)
    rtid, rbary, rzbuf = (np.asarray(a) for a in ref)
    assert (tid >= 0).mean() > 0.05
    np.testing.assert_array_equal(tid, rtid)
    _check_zbuf(zbuf, rzbuf)
    np.testing.assert_allclose(bary, rbary, rtol=0, atol=1e-6)
    assert np.all(bary[tid < 0] == 0)
    faces = assets.faces
    if case == "cull":
        # the oracle does not cull: hand it the faces of positive screen
        # area as degenerate ones, which it skips (same ids, same area
        # formula and float32 order as the binning's)
        scr = oracle.ndc_to_screen(vndc[0], cfg.image_size, cfg.image_size)
        p0, p1, p2 = (scr[faces[:, k]] for k in range(3))
        area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))
        assert 0 < (area > 0).sum() < len(faces)
        faces = np.where((area > 0)[:, None], 0, faces)
    _check_oracle(vndc, faces, cfg, tid, bary, zbuf)


def test_single_mesh_rasterize_and_cfg(cfg, assets):
    """rasterize() is rasterize_batch on one mesh; cfg sets tile_h."""
    vndc = _verts(cfg, assets, 9, batch=1)
    v = torch.from_numpy(vndc)
    f = torch.from_numpy(assets.faces.astype(np.int64))
    h = w = cfg.image_size
    one = TR.rasterize(v[0], f, height=h, width=w, tile_h=cfg.tile_h)
    bat = TR.rasterize_batch(v, f, height=h, width=w, cfg=cfg, tile_h=99)
    for a, b in zip(one, bat):
        assert torch.equal(a, b[0])


def test_oracle_is_the_reference_oracle(cfg, assets):
    vndc = _verts(cfg, assets, 10, batch=1)[0]
    h = w = cfg.image_size
    for a, b in zip(oracle.rasterize(vndc, assets.faces, h, w),
                    ref_oracle.rasterize(vndc, assets.faces, h, w)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    coeff = make_coeff(cfg, np.random.default_rng(10))
    tcfg = tiny_config()
    tassets = synthetic_bfm(tcfg, seed=0)
    got = oracle.render_coeffs(coeff, tassets, tcfg)
    ref = ref_oracle.render_coeffs(coeff, assets, cfg)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_native_oracle_matches_numpy_oracle(cfg, assets):
    if shutil.which("g++") is None:
        pytest.skip("g++ toolchain unavailable")
    src = native_oracle.SRC.resolve()
    assert src.is_relative_to(ROOT / "facerecon_tpu_torch")
    assert native_oracle.library_path().resolve().is_relative_to(
        ROOT / "facerecon_tpu_torch" / "_build")
    native_oracle.require()
    vndc = _verts(cfg, assets, 11, batch=1)[0]
    h = w = cfg.image_size
    for a, b in zip(native_oracle.rasterize(vndc, assets.faces, h, w),
                    oracle.rasterize(vndc, assets.faces, h, w)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(200)
    verts = rng.uniform(-1.0, 1.0, size=(40, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(5.0, 15.0, size=40)
    faces = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    for a, b in zip(native_oracle.rasterize(verts, faces, 48, 48),
                    oracle.rasterize(verts, faces, 48, 48)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile_h", [136, 8])
def test_raster_ints_take_any_band(cfg, assets, monkeypatch, tile_h):
    """The launch path of K1, K2 and K4 (each wrapper up to _build.launch,
    no card needed) takes a band of any size: tile_h 136 and tile_h 8
    (benchmarks/raster_bench.py's default), each with one 224-px column,
    launch as they are, one block a (column, band, image), with the
    windows' column masks unchanged and no ValueError."""
    vndc = torch.from_numpy(np.array(_verts(cfg, assets, 12, batch=1)))
    faces = torch.from_numpy(assets.faces.astype(np.int64))
    win = TR.band_windows(vndc, faces, torch.arange(assets.n_faces), 224,
                          224, tile_h, 1)
    assert win.cmask.any()
    rows = win.setup.shape[2]
    rec = torch.zeros((1, 24, rows))
    launched = {}
    monkeypatch.setattr(TR._build, "on_card", lambda dev: True)
    monkeypatch.setattr(TR._build, "launch",
                        lambda name, dev, ptrs, ints:
                        launched.update({name: (ptrs, ints)}))
    kw = dict(height=224, width=224, tile_h=tile_h, n_cols=1,
              n_faces=assets.n_faces)
    TR.shade_windows(win, rec, **kw)
    TR.select_windows(win, rec, **kw)
    TR.pos_windows(win, **kw)
    n_bands = (224 + tile_h - 1) // tile_h
    for name, at in (("raster_shade", 4), ("raster_select", 4),
                     ("raster_pos", 3)):
        ptrs, ints = launched[name]
        assert ptrs[at] is win.cmask
        assert ints == (1, 224, 224, tile_h, 1, 224, n_bands, rows,
                        assets.n_faces)


def _plain_cover(f, xs, ys):
    """(pixels, rows) coverage of the pixel centers xs x ys (row-major) by
    the setup rows f, with the z-test's float32 ops in its order."""
    py, px = torch.meshgrid(ys.to(torch.float32) + 0.5,
                            xs.to(torch.float32) + 0.5, indexing="ij")
    qx = px.reshape(-1, 1) - f[9]
    qy = py.reshape(-1, 1) - f[10]
    e0 = f[0] * qx + f[1] * qy + f[2]
    e1 = f[3] * qx + f[4] * qy + f[5]
    return (e0 >= 0.0) & (e1 >= 0.0) & (e0 + e1 <= 1.0)


@pytest.mark.parametrize("band", [(2, None), (4, 2), (32, 1)],
                         ids=["tiny_config", "tile_h4", "tall"])
@pytest.mark.parametrize("case", ["raster_rows", "shuffled", "cull"])
def test_group_cull_keeps_every_winner(cfg, assets, case, band):
    """The kernels' per-group cull never drops a triangle that covers a
    pixel of the group. For every pixel group (TR.pixel_group, as the
    kernels form them) of every column tile, TR.cull_keeps (the float32
    twin of cull_live) on the group's rectangle keeps each of its pixels'
    plain winner rows (pos_windows_reference), and every row of the band's
    window that covers one of its pixel centers by the z-test's float ops;
    and it drops some rows that cover pixels of other groups. The
    rectangle is the group's pixels inside the tile and the image, as the
    kernels cull it. Bands: tiny_config's (tile_h 2, 32-px
    columns), tile_h 4 with 32-px columns (the default config's group of
    16 x 2 micro-tiles) and a tall band of tile_h 32 x one 64-px
    column."""
    n_cols, rows, rid, cull = _order(cfg, assets, case)
    tile_h, n_cols = band[0], band[1] or n_cols
    s = cfg.image_size
    vndc = torch.from_numpy(np.array(_verts(cfg, assets, 13, batch=2)))
    win = TR.band_windows(vndc, torch.from_numpy(rows.astype(np.int64)),
                          torch.from_numpy(rid.astype(np.int64)), s, s,
                          tile_h, n_cols, cull)
    _, _, winner = TR.pos_windows_reference(
        win, height=s, width=s, tile_h=tile_h, n_cols=n_cols,
        n_faces=assets.n_faces)
    assert (winner >= 0).float().mean() > 0.1
    col_w = TR.col_width(s, n_cols)
    gw, gh = TR.pixel_group(tile_h, col_w)
    dropped = 0
    for b in range(winner.shape[0]):
        for t in range(win.blo.shape[1]):
            lo, n = int(win.blo[b, t]) * 128, int(win.bn[b, t]) * 128
            f = win.setup[b, :, lo:lo + n]
            in_band = _plain_cover(f, torch.arange(s), torch.arange(
                t * tile_h, min((t + 1) * tile_h, s))).any(0)
            for x0, y0 in ((c * col_w + gx, t * tile_h + gy)
                           for c in range(n_cols)
                           for gx in range(0, col_w, gw)
                           for gy in range(0, tile_h, gh)):
                xs = torch.arange(x0, min(x0 + gw, (x0 // col_w + 1) * col_w,
                                          s))
                ys = torch.arange(y0, min(y0 + gh, (t + 1) * tile_h, s))
                if not (len(xs) and len(ys)):
                    continue
                # the group's rectangle inside the tile and the image
                keep = TR.cull_keeps(f, x0 + 0.5, float(xs[-1]) + 0.5,
                                     y0 + 0.5, float(ys[-1]) + 0.5)
                assert not (_plain_cover(f, xs, ys) & ~keep).any()
                w = winner[b, ys][:, xs].reshape(-1).to(torch.int64)
                assert keep[w[w >= 0] - lo].all()
                dropped += int((in_band & ~keep).sum())
    assert dropped > 0


def _segments_issued(win, s, tile_h, n_cols):
    """(mask tests, list tests, tests the earlier design issued: 128 a
    triangle the group cull keeps) of K1, K2 and K4 on these windows,
    counted segment by segment in a plain loop over the walked chunks of
    each (image, band, column), from TR.cull_keeps and
    TR.microtile_mask."""
    col_w = TR.col_width(s, n_cols)
    gw, gh = TR.pixel_group(tile_h, col_w)
    gc, gr = gw // 2, gh // 2
    mask_tests = list_tests = old = 0
    for b in range(win.setup.shape[0]):
        for t in range(win.blo.shape[1]):
            words = win.cmask[b].view(-1, n_cols, 2)[t]
            for c in range(n_cols):
                walk = [w * 32 + i for w in range(2) for i in range(32)
                        if (int(words[c, w]) >> i) & 1]
                walk += list(range(64, int(win.bn[b, t])))
                x_lim = min((c + 1) * col_w, s)
                y_lim = min((t + 1) * tile_h, s)
                for k in walk:
                    r0 = (int(win.blo[b, t]) + k) * 128
                    f = win.setup[b, :11, r0:r0 + 128]
                    for gy in range(t * tile_h, y_lim, gh):
                        for gx in range(c * col_w, x_lim, gw):
                            live = TR.cull_keeps(
                                f, gx + 0.5, min(gx + gw, x_lim) - 0.5,
                                gy + 0.5, min(gy + gh, y_lim) - 0.5)
                            tested, hits = TR.microtile_mask(
                                f, gx, gy, gc, gr, x_lim, y_lim)
                            rows = torch.tensor(
                                [4 if gy + 2 * i + 1 < y_lim else 2
                                 for i in range(gr)])
                            for seg in range(4):
                                sl = slice(32 * seg, 32 * seg + 32)
                                on = live[sl][:, None, None]
                                mine = ((tested[sl] & on).sum(2)
                                        * rows).sum(1)
                                mask_tests += int(mine.max()) * 32
                                per_tile = (hits[sl] & on).sum(0)
                                px = 2 if y_lim - gy == 1 else 4
                                list_tests += int(per_tile.max()) * 32 * px
                                old += int(live[sl].sum()) * 128
    return mask_tests, list_tests, old


@pytest.mark.parametrize("band", [(1, None), (2, None), (3, None), (4, 2),
                                  (5, 4), (8, 4), (32, 1)],
                         ids=["shallow", "tiny_config", "odd", "tile_h4",
                              "odd_narrow", "narrow", "tall"])
@pytest.mark.parametrize("case", ["raster_rows", "shuffled"])
def test_microtile_mask_keeps_every_winner(cfg, assets, case, band):
    """The kernels' micro-tile masks (csrc/raster_common.cuh, tile_hits;
    TR.microtile_mask is their float32 twin) drop no winner. For every
    pixel group of every column tile and every row of the band's window
    that the group cull keeps: `hits` holds exactly the micro-tiles with
    a pixel center inside the tile and the image that the row covers by
    the z-test's float ops (_plain_cover), `tested` holds every one of
    them, and each pixel's plain winner row (pos_windows_reference) has
    the pixel's micro-tile in its hits. `tested` drops some micro-tiles
    the group cull keeps. The tests the kernels issue
    (TR.tests_issued) equal a plain segment-by-segment recount and are
    fewer than the old design's, which tested 128 pixels for each kept
    triangle. Bands: shallow (tile_h 1: one pixel row of each
    micro-tile is in the tile), tiny_config's tile_h 2, odd heights whose
    groups end in a half micro-row (tile_h 3 x 32-px columns: 2
    micro-rows, the second one pixel row; tile_h 5 x 16-px columns: 3
    micro-rows, the third one pixel row), tile_h 4 (two micro-rows),
    tile_h 8 with 16-px columns (4 micro-rows) and a tall band of
    tile_h 32 x one 64-px column; both face orders."""
    n_cols, rows, rid, cull = _order(cfg, assets, case)
    tile_h, n_cols = band[0], band[1] or n_cols
    s = cfg.image_size
    vndc = torch.from_numpy(np.array(_verts(cfg, assets, 13, batch=2)))
    win = TR.band_windows(vndc, torch.from_numpy(rows.astype(np.int64)),
                          torch.from_numpy(rid.astype(np.int64)), s, s,
                          tile_h, n_cols, cull)
    _, _, winner = TR.pos_windows_reference(
        win, height=s, width=s, tile_h=tile_h, n_cols=n_cols,
        n_faces=assets.n_faces)
    assert (winner >= 0).float().mean() > 0.1
    col_w = TR.col_width(s, n_cols)
    gw, gh = TR.pixel_group(tile_h, col_w)
    gc, gr = gw // 2, gh // 2
    trimmed = 0
    for b in range(winner.shape[0]):
        for t in range(win.blo.shape[1]):
            lo, n = int(win.blo[b, t]) * 128, int(win.bn[b, t]) * 128
            f = win.setup[b, :, lo:lo + n]
            y_lim = min((t + 1) * tile_h, s)
            for c in range(n_cols):
                x_lim = min((c + 1) * col_w, s)
                for gx in range(c * col_w, x_lim, gw):
                    for gy in range(t * tile_h, y_lim, gh):
                        live = TR.cull_keeps(
                            f, gx + 0.5, min(gx + gw, x_lim) - 0.5,
                            gy + 0.5, min(gy + gh, y_lim) - 0.5)
                        tested, hits = TR.microtile_mask(
                            f, gx, gy, gc, gr, x_lim, y_lim)
                        tested = tested & live[:, None, None]
                        hits = hits & live[:, None, None]
                        want = torch.zeros_like(hits)
                        for i in range(gr):
                            for j in range(gc):
                                xs = torch.arange(gx + 2 * j, max(min(
                                    gx + 2 * j + 2, x_lim), gx + 2 * j))
                                ys = torch.arange(gy + 2 * i, max(min(
                                    gy + 2 * i + 2, y_lim), gy + 2 * i))
                                if len(xs) and len(ys):
                                    want[:, i, j] = _plain_cover(
                                        f, xs, ys).any(0)
                        assert torch.equal(hits, want)
                        assert not (want & ~tested).any()
                        trimmed += int((live[:, None, None] & ~tested
                                        ).sum())
                        for y in range(gy, min(gy + gh, y_lim)):
                            for x in range(gx, min(gx + gw, x_lim)):
                                w = int(winner[b, y, x])
                                if w >= 0:
                                    assert hits[w - lo, (y - gy) // 2,
                                                (x - gx) // 2]
    assert trimmed > 0
    mask_tests, list_tests, old = _segments_issued(win, s, tile_h, n_cols)
    assert TR.tests_issued(win, height=s, width=s, tile_h=tile_h,
                           n_cols=n_cols) == (mask_tests, list_tests)
    assert 0 < mask_tests + list_tests < old


def _mask_draws(kind, rng, n, gx, gy, w, h):
    """Setup fields (11, n) of n triangles drawn near the pixel group
    [gx, gx + w) x [gy, gy + h), made as ops/binning.py makes them
    (float32) from screen corners, or drawn as fields directly (raw,
    w_cancel). Kinds: random corners; corners snapped to the half-pixel
    grid (pixel centers on the edges); slivers whose long edge joins two
    pixel centers, the third corner 1e-7..1 px off it (det near 0);
    far corners, 1e3..3e5 px away (large coordinates and forms); a
    horizontal or nearly horizontal first edge (wa0 + wa1 = 0 or
    nearly); raw forms of magnitudes 1e-4..1e6 whose edges pass through
    a pixel center of the group to within an ulp; and wa1 = -wa0 to
    within an ulp, magnitudes up to 1e6."""
    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape or (n,))
    if kind in ("raw", "w_cancel"):
        f = np.zeros((11, n))
        sign = lambda: rng.choice([-1.0, 1.0], n)
        f[9], f[10] = u(gx - 50, gx + w + 50), u(gy - 50, gy + h + 50)
        if kind == "raw":
            for k in (0, 1, 3, 4):
                f[k] = 10.0 ** u(-4, 6) * sign()
            f = f.astype(np.float32)
            qx = (np.floor(u(gx, gx + w)) + 0.5 - f[9]).astype(np.float32)
            qy = (np.floor(u(gy, gy + h)) + 0.5 - f[10]).astype(np.float32)
            f[2] = -(f[0] * qx + f[1] * qy) * rng.choice(
                [1.0, 1 + 1e-7, 1 - 1e-7], n).astype(np.float32)
            f[5] = (1.0 - (f[3] * qx + f[4] * qy)
                    - f[2] * rng.choice([0.0, 1.0], n).astype(np.float32))
        else:
            f[9], f[10] = u(gx, gx + w), u(gy, gy + h)
            f[0] = 10.0 ** u(-2, 6) * sign()
            f[3] = -f[0] * rng.choice([1.0, 1 + 2.0 ** -23, 1 - 2.0 ** -23], n)
            f[1], f[4] = rng.normal(0, 1, n), rng.normal(0, 1, n)
            f[2] = u(-1, 2)
            f[5] = 1.0 - f[2] + u(-0.5, 0.5)
        return torch.from_numpy(f.astype(np.float32))
    if kind == "random":
        x, y = u(gx - 4, gx + w + 4, 3, n), u(gy - 4, gy + h + 4, 3, n)
    elif kind == "snapped":
        x = np.floor(u(gx - 4, gx + w + 4, 3, n) * 2) / 2
        y = np.floor(u(gy - 4, gy + h + 4, 3, n) * 2) / 2
    elif kind == "sliver":
        a = np.floor(u(gx - 8, gx + w + 8, 2, n)) + 0.5
        b = np.floor(u(gy - 8, gy + h + 8, 2, n)) + 0.5
        t, d = u(0, 1), 10.0 ** u(-7, 0) * rng.choice([-1.0, 1.0], n)
        dx, dy = a[1] - a[0], b[1] - b[0]
        ln = np.maximum(np.hypot(dx, dy), 1.0)
        x = np.stack([a[0], a[1], a[0] + t * dx - d * dy / ln])
        y = np.stack([b[0], b[1], b[0] + t * dy + d * dx / ln])
        turn = rng.permuted(np.tile(np.arange(3), (n, 1)), axis=1).T
        x, y = np.take_along_axis(x, turn, 0), np.take_along_axis(y, turn, 0)
    elif kind == "far":
        r, a = 10.0 ** u(3, 5.5, 3, n), u(0, 2 * np.pi, 3, n)
        x, y = gx + w / 2 + r * np.cos(a), gy + h / 2 + r * np.sin(a)
    else:                                           # w_zero
        x, y = u(gx - 4, gx + w + 4, 3, n), u(gy - 4, gy + h + 4, 3, n)
        y[1] = y[0] + rng.choice([0.0, 1e-6, -1e-6, 1e-3], n)
    x, y = x.astype(np.float32), y.astype(np.float32)
    u1, v1, u2, v2 = x[1] - x[0], y[1] - y[0], x[2] - x[0], y[2] - y[0]
    area = u1 * v2 - v1 * u2
    live = np.abs(area) > 1e-12
    inv = np.where(live, np.float32(1.0) / np.where(live, area, 1.0),
                   0.0).astype(np.float32)
    f = np.zeros((11, n), np.float32)
    f[0], f[1] = (v1 - v2) * inv, (u2 - u1) * inv
    f[2] = np.where(live, (u1 * v2 - u2 * v1) * inv, -3e38)
    f[3], f[4] = v2 * inv, -u2 * inv
    f[5] = np.where(live, 0.0, -3e38)
    f[9], f[10] = x[0], y[0]
    return torch.from_numpy(f)


@pytest.mark.parametrize("kind", ["random", "snapped", "sliver", "far",
                                  "w_zero", "raw", "w_cancel"])
def test_microtile_mask_never_drops_a_covered_micro_tile(kind):
    """The micro-tile masks' third-edge bound rests on a float error
    analysis (csrc/raster_common.cuh, edge_slack: a slack of 12 ulps of
    the forms' magnitudes). TR.microtile_mask (the masks' float32 twin)
    on triangles aimed at that bound (_mask_draws: slivers through pixel
    centers, near-zero det, coordinates up to 3e5 px, wa0 + wa1 near 0,
    raw forms through pixel centers to an ulp) and on three pixel groups
    (16 x 2 micro-tiles ending in a half micro-row, one row of 32, 8 x 4
    far from the origin ending in a half micro-row): `tested` holds every
    micro-tile with a pixel center inside the tile that the triangle
    covers by the z-test's float32 ops (_plain_cover), and `hits` is
    exactly those. Some micro-tiles are covered and some dropped, so
    neither side holds vacuously."""
    rng = np.random.default_rng(["random", "snapped", "sliver", "far",
                                 "w_zero", "raw", "w_cancel"].index(kind))
    covered = dropped = 0
    for gx, gy, gc, gr, y_rows in ((40, 20, 16, 2, 3), (1000, 500, 32, 1, 1),
                                   (9000, 7000, 8, 4, 7)):
        x_lim, y_lim = gx + 2 * gc, gy + y_rows
        f = _mask_draws(kind, rng, 6000, gx, gy, 2 * gc, y_rows)
        assert torch.isfinite(f).all()
        tested, hits = TR.microtile_mask(f, gx, gy, gc, gr, x_lim, y_lim)
        cov = _plain_cover(f, torch.arange(gx, x_lim),
                           torch.arange(gy, y_lim))       # (px, n)
        cov = torch.nn.functional.pad(
            cov.T.reshape(-1, y_rows, 2 * gc), (0, 0, 0, 2 * gr - y_rows))
        cov = cov.reshape(-1, gr, 2, gc, 2).any(4).any(2)
        assert not (cov & ~tested).any()
        assert torch.equal(hits, cov)
        covered += int(cov.sum())
        dropped += int((~tested).sum())
    assert covered > 1000 and dropped > 1000


def test_wide_band_on_cpu_matches_reference(cfg, assets):
    """The plain versions take a wide band too (tile_h 8 x one 160-px
    column, 1,280 pixels): rasterize_positions on the CPU equals
    the reference's (interpret mode) with the bars above, and its own
    result on narrow bands exactly (the z-test does not depend on the
    banding)."""
    vndc = _verts(cfg, assets, 12, batch=1)
    kw = dict(height=48, width=160)
    ref = RP.rasterize_positions(jnp.asarray(vndc), jnp.asarray(assets.faces),
                                 **kw, tile_h=8, n_cols=1)
    faces = torch.from_numpy(assets.faces.astype(np.int64))
    tid, _, zbuf, _ = TR.rasterize_positions(torch.from_numpy(vndc), faces,
                                             **kw, tile_h=8, n_cols=1)
    assert (tid.numpy() >= 0).mean() > 0.05
    np.testing.assert_array_equal(tid.numpy(), np.asarray(ref[0]))
    _check_zbuf(zbuf.numpy(), np.asarray(ref[2]))
    ntid, _, nzbuf, _ = TR.rasterize_positions(torch.from_numpy(vndc), faces,
                                               **kw, tile_h=2, n_cols=4)
    assert torch.equal(tid, ntid) and torch.equal(zbuf, nzbuf)
