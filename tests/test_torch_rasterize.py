"""The port's fused rasterize+shade (facerecon_tpu_torch/ops/rasterize.py)
against the JAX reference and the numpy oracle, at tiny_config().

On the CPU the wrapper runs the kernel's plain version. It must give
EXACTLY the tri_id of the reference's Pallas kernel (run in interpret
mode, as tests/test_rasterize_pallas.py runs it) and of the oracle,
including under a shuffled face order and a 45-degree roll. color and
bary agree with the reference to 1e-4: the reference rounds them to
its >=16-bit hi/lo bf16 output pack, the port writes float32.

The kernel itself runs only on a card; tests/test_torch_cuda.py holds it
against this plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from facerecon_tpu import oracle
from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu.ops import sh as SH
from facerecon_tpu.ops.render import _pack_render_records
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import geometry as TG
from facerecon_tpu_torch.ops import rasterize as TR
from facerecon_tpu_torch.ops import render as TRe
from facerecon_tpu_torch.ops import sh as TSH
from facerecon_tpu_torch.utils.coeffs import split_coeff as t_split_coeff

from conftest import make_coeff

torch.set_num_threads(2)


def _port_geom(cfg, assets, seed, batch=1, roll=None):
    coeff = make_coeff(cfg, np.random.default_rng(seed), batch=batch)
    if roll is not None:
        coeff[:, cfg.coeff_split[2] + 2] = roll
    tbfm = TG.device_bfm(assets, "cpu")
    c = t_split_coeff(torch.from_numpy(coeff), cfg)
    return coeff, tbfm, c, TG.coeffs_to_geometry(c, tbfm, cfg)


def _port_render(cfg, geom, c, faces, rows, rid, reference=False):
    """Records in the given row order, then rasterize_shaded (or its
    plain version) on the device of the inputs."""
    h = w = cfg.image_size
    rad = TSH.illuminate(geom.texture, geom.normals, c.gamma)
    rec = TRe.pack_render_records(geom.verts_ndc, rad, rows, h, w,
                                  TR.padded_rows(rows.shape[0]))
    fn = TR.rasterize_shaded_reference if reference else TR.rasterize_shaded
    return fn(rec, geom.verts_ndc, faces, height=h, width=w,
              tile_h=cfg.tile_h, n_cols=cfg.raster_cols, row_faces=rows,
              row_id=rid)


def _hold_shaded_against_pallas(cfg, assets, coeff, cull_backfaces=False):
    """Same 24-field record (the reference's _pack_render_records) and the
    same ndc vertices into both rasterize_shaded implementations (the
    port's wrapper on the CPU and its plain version, each bit for bit the
    other). Returns the port's outputs and the port's inputs."""
    bfm = G.device_bfm(assets)
    c = split_coeff(jnp.asarray(coeff), cfg)
    geom = G.coeffs_to_geometry(c, bfm, cfg)
    h = w = cfg.image_size
    rad = SH.illuminate(geom.texture, geom.normals, c.gamma)
    rows, rid = bfm.raster_rows, bfm.raster_row_id
    rec = _pack_render_records(geom.verts_ndc, rad, rows, h, w,
                               RP.padded_rows(rows.shape[0]))
    tid, color, bary = RP.rasterize_shaded(
        rec, geom.verts_ndc, bfm.faces, height=h, width=w,
        tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
        cull_backfaces=cull_backfaces, row_faces=rows, row_id=rid)
    tbfm = TG.device_bfm(assets, "cpu")
    args = (torch.from_numpy(np.array(rec)),
            torch.from_numpy(np.array(geom.verts_ndc)), tbfm.faces)
    kw = dict(height=h, width=w, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              row_faces=tbfm.raster_rows, row_id=tbfm.raster_row_id)
    got = TR.rasterize_shaded_reference(*args, cull_backfaces=cull_backfaces,
                                        **kw)
    for a, b in zip(TR.rasterize_shaded(*args, cull_backfaces=cull_backfaces,
                                        **kw), got):
        assert torch.equal(a, b)
    ttid, tcolor, tbary = got
    tid = np.asarray(tid)
    np.testing.assert_array_equal(ttid.numpy(), tid)
    np.testing.assert_allclose(tcolor.numpy(), np.asarray(color), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tbary.numpy(), np.asarray(bary), rtol=0,
                               atol=1e-4)
    cov = tid >= 0
    np.testing.assert_allclose(tbary.numpy().sum(-1)[cov], 1.0, atol=1e-5)
    assert np.all(tbary.numpy()[~cov] == 0) and np.all(
        tcolor.numpy()[~cov] == 0)
    return got, args, kw


def test_plain_version_matches_pallas_shaded(cfg, assets):
    coeff = make_coeff(cfg, np.random.default_rng(7), batch=2)
    (tid, _, _), _, _ = _hold_shaded_against_pallas(cfg, assets, coeff)
    assert (tid.numpy() >= 0).mean() > 0.1


def turned_coeff(cfg, seed):
    """Two images: the first posed as make_coeff poses it, the second
    turned 2.5 rad about the vertical axis, so that the faces it shows
    are mostly back faces."""
    coeff = make_coeff(cfg, np.random.default_rng(seed), batch=2)
    coeff[1, cfg.coeff_split[2] + 1] = 2.5
    return coeff


def test_shaded_culls_backfaces_as_the_reference(cfg, assets):
    """cull_backfaces=True through rasterize_shaded equals the reference's
    Pallas rasterize_shaded with the flag, its tri_id is the contract
    path's (rasterize_batch) with the flag, and the flag culls: tri_id
    differs from the unculled one."""
    (tid, _, _), args, kw = _hold_shaded_against_pallas(
        cfg, assets, turned_coeff(cfg, 12), cull_backfaces=True)
    assert (tid[0] >= 0).float().mean() > 0.1
    assert bool((tid[1] >= 0).any())
    unculled = TR.rasterize_shaded(*args, **kw)[0]
    assert not torch.equal(unculled, tid)
    contract = TR.rasterize_batch(args[1], args[2], cull_backfaces=True,
                                  **kw)[0]
    assert torch.equal(contract, tid)


@pytest.mark.parametrize("case", ["raster_rows", "shuffled", "roll45"])
def test_tri_id_matches_oracle(cfg, assets, case):
    coeff, tbfm, c, geom = _port_geom(
        cfg, assets, 11, roll=np.pi / 4 if case == "roll45" else None)
    if case == "shuffled":
        perm = np.random.default_rng(3).permutation(assets.n_faces)
        rows = torch.from_numpy(assets.faces[perm]).to(torch.int64)
        rid = torch.from_numpy(perm)
    else:
        rows, rid = tbfm.raster_rows, tbfm.raster_row_id
    tid, _, _ = _port_render(cfg, geom, c, tbfm.faces, rows, rid)
    h = w = cfg.image_size
    tid_o, _, _ = oracle.rasterize(geom.verts_ndc[0].numpy(), assets.faces,
                                   h, w)
    assert (tid_o >= 0).mean() > 0.1
    np.testing.assert_array_equal(tid[0].numpy(), tid_o)


def test_wrapper_runs_plain_version_on_cpu(cfg, assets):
    """On CPU tensors the wrapper is the plain version (bit for bit) and
    launches nothing; it rejects inputs the kernel does not take."""
    _, tbfm, c, geom = _port_geom(cfg, assets, 12, batch=2)
    rows, rid = tbfm.raster_rows, tbfm.raster_row_id
    _build.reset_launches()
    got = _port_render(cfg, geom, c, tbfm.faces, rows, rid)
    ref = _port_render(cfg, geom, c, tbfm.faces, rows, rid, reference=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["raster_shade"] == 0
    h = w = cfg.image_size
    win = TR.band_windows(geom.verts_ndc, rows, rid, h, w, cfg.tile_h,
                          cfg.raster_cols)
    rec = torch.zeros((2, 24, win.setup.shape[2]))
    kw = dict(height=h, width=w, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    with pytest.raises(ValueError):
        TR.shade_windows(win, rec.double(), **kw)
    with pytest.raises(ValueError):
        TR.shade_windows(win, rec[:, :17], **kw)
    with pytest.raises(ValueError):
        TR.shade_windows(win._replace(cmask=win.cmask[:, ::2]), rec, **kw)


def test_band_windows_on_cpu_is_the_plain_version(cfg, assets, monkeypatch):
    """On CPU tensors band_windows is band_windows_reference bit for bit
    and builds and launches nothing (any index type, as before)."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU call reached the kernel build")
    monkeypatch.setattr(TR._build, "load", refuse)
    monkeypatch.setattr(TR._build, "build", refuse)
    _, tbfm, _, geom = _port_geom(cfg, assets, 12, batch=2)
    h = w = cfg.image_size
    before = dict(_build.LAUNCHES)
    for rows, rid in ((tbfm.raster_rows, tbfm.raster_row_id),
                      (torch.from_numpy(assets.raster_rows),
                       torch.from_numpy(assets.raster_row_id))):
        got = TR.band_windows(geom.verts_ndc, rows, rid, h, w, cfg.tile_h,
                              cfg.raster_cols)
        ref = TR.band_windows_reference(geom.verts_ndc, rows, rid, h, w,
                                        cfg.tile_h, cfg.raster_cols)
        assert torch.equal(got.setup.view(torch.int32),
                           ref.setup.view(torch.int32))
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a, b)
    assert dict(_build.LAUNCHES) == before


def _bin_launches(monkeypatch):
    """Pretend CPU tensors lie on the card and record band_windows'
    launches (name, tensors, ints) instead of making them."""
    launched = []
    monkeypatch.setattr(TR._build, "on_card", lambda dev: True)
    monkeypatch.setattr(TR._build, "launch",
                        lambda name, dev, ptrs, ints:
                        launched.append((name, ptrs, ints)))
    return launched


@pytest.mark.parametrize("size,tile_h,n_cols,cull", [
    (224, 4, 7, False), (512, 2, 8, False), (224, 8, 1, True),
    (224, 8, 1, False)], ids=["infer224", "render512", "k4_cull", "k4"])
def test_band_windows_launches_the_two_passes(cfg, assets, monkeypatch,
                                              size, tile_h, n_cols, cull):
    """The card path of band_windows (up to _build.launch, no card
    needed) at each path's shape: the setup pass, then the window pass,
    once each, on the inputs as they are and outputs of Windows' layout
    (setup (B, 16, padded_rows(F)), a (B, chunks, 4) box scratch passed
    from the first to the second), with the shape's ints."""
    _, tbfm, _, geom = _port_geom(cfg, assets, 12, batch=2)
    vndc = geom.verts_ndc
    rows, rid = tbfm.raster_rows, tbfm.raster_row_id
    launched = _bin_launches(monkeypatch)
    win = TR.band_windows(vndc, rows, rid, size, size, tile_h, n_cols, cull)
    f = rows.shape[0]
    n_chunks = (f + 127) // 128
    n_bands = (size + tile_h - 1) // tile_h
    assert [name for name, _, _ in launched] == ["bin_setup", "bin_windows"]
    (_, sp, si), (_, wp, wi) = launched
    assert sp[0] is vndc and sp[1] is rows and sp[2] is rid
    assert sp[3] is win.setup and wp[0] is sp[4]
    assert tuple(sp[4].shape) == (2, n_chunks, 4)
    assert wp[1] is win.blo and wp[2] is win.bn and wp[3] is win.cmask
    assert si == (2, vndc.shape[1], f, TR.padded_rows(f), size, size,
                  int(cull))
    assert wi == (2, n_chunks, n_bands, tile_h, n_cols,
                  TR.col_width(size, n_cols))
    TR._check_inputs(win, None, size, size, tile_h, n_cols)
    assert win.setup.shape == (2, 16, TR.padded_rows(f))


@pytest.mark.parametrize("case", ["verts_f64", "faces_i32", "row_id_i32",
                                  "strided_verts", "faces_shape",
                                  "cols_33", "cols_0"])
def test_band_windows_rejects_what_the_kernels_do_not_take(
        cfg, assets, monkeypatch, case):
    """On the card path band_windows raises, launching nothing, on a
    wrong dtype, shape or layout, or on more column tiles than the window
    pass has warps (32)."""
    _, tbfm, _, geom = _port_geom(cfg, assets, 12, batch=1)
    args = dict(verts_ndc=geom.verts_ndc, row_faces=tbfm.raster_rows,
                row_id=tbfm.raster_row_id, n_cols=cfg.raster_cols)
    v = args["verts_ndc"]
    args.update({
        "verts_f64": dict(verts_ndc=v.double()),
        "faces_i32": dict(row_faces=args["row_faces"].int()),
        "row_id_i32": dict(row_id=args["row_id"].int()),
        "strided_verts": dict(verts_ndc=torch.cat([v, v], 2)[..., ::2]),
        "faces_shape": dict(row_faces=args["row_faces"][:, :2]),
        "cols_33": dict(n_cols=33),
        "cols_0": dict(n_cols=0)}[case])
    launched = _bin_launches(monkeypatch)
    s = cfg.image_size
    with pytest.raises(ValueError):
        TR.band_windows(args["verts_ndc"], args["row_faces"], args["row_id"],
                        s, s, cfg.tile_h, args["n_cols"])
    assert launched == []
