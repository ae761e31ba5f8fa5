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
    and it drops some rows that cover pixels of other groups. Bands: tiny_config's (tile_h 2, 32-px
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
                keep = TR.cull_keeps(f, x0 + 0.5, x0 + gw - 0.5, y0 + 0.5,
                                     y0 + gh - 0.5)
                xs = torch.arange(x0, min(x0 + gw, (x0 // col_w + 1) * col_w,
                                          s))
                ys = torch.arange(y0, min(y0 + gh, (t + 1) * tile_h, s))
                if not (len(xs) and len(ys)):
                    continue
                assert not (_plain_cover(f, xs, ys) & ~keep).any()
                w = winner[b, ys][:, xs].reshape(-1).to(torch.int64)
                assert keep[w[w >= 0] - lo].all()
                dropped += int((in_band & ~keep).sum())
    assert dropped > 0


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
