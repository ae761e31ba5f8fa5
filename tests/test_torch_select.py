"""The port's raster + select and its adjoint (kernels K2 and K3 of
facerecon_tpu_torch/ops/rasterize.py) against the JAX reference's
rasterize_select (Pallas in interpret mode), at tiny_config().

On the CPU the wrappers run the kernels' plain versions. Bars:
  - tri_id and the winner's raster row EXACTLY equal to the reference's,
    in the asset's row order, a shuffled face order and a 45-degree roll;
  - the affine and anchor fields within 1e-6 (the reference carries them
    as an exact 3-part bf16 split), the radiance fields within 1e-4 (its
    2-part split keeps >= 16 significand bits);
  - the adjoint equal to the np.add.at scatter of the cotangent over the
    winning pixels within 1e-5, and to jax.grad of the reference within
    1e-4 (its matrix-unit adjoint carries the cotangent at 16 bits); for
    a near-camera face, whose rows sum ~100 pixels, within 2^-16 of each
    sum of |cotangent| (the same 16-bit rounding, summed);
  - color, bary and skin rebuilt from the select within 1e-4 of the
    reference's _shade_from_sel and skin_mask_image (the reference rounds
    radiance and skin to its 16-bit split).

The kernels themselves run only on a card; tests/test_torch_cuda.py holds
them against these plain versions there.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu.ops import sh as SH
from facerecon_tpu.ops.losses import skin_mask_image
from facerecon_tpu.ops.render import (RenderOut, _pack_render_records,
                                      _pack_split_records, _render_fields,
                                      _shade_from_sel, _stack24)
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import geometry as TG
from facerecon_tpu_torch.ops import rasterize as TR
from facerecon_tpu_torch.ops import render as TRe

from conftest import make_coeff

torch.set_num_threads(2)


def _ref_planes(sel, height, width, tile_h):
    """The reference's BANDED (B, n_bands, F, band_px) select -> numpy
    (B, F, H, W) image planes."""
    a = np.asarray(sel)
    b, nb, nf, band_px = a.shape
    a = a.transpose(0, 2, 1, 3).reshape(b, nf, nb * tile_h, band_px // tile_h)
    return a[:, :, :height, :width]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _inputs(cfg, assets, batch, case="raster_rows", seed=7):
    """The same geometry and 24-field records (the reference's
    _pack_render_records) for both packages, in the asset's raster row
    order or a shuffled face order."""
    coeff = make_coeff(cfg, np.random.default_rng(seed), batch=batch)
    if case == "roll45":
        coeff[:, cfg.coeff_split[2] + 2] = np.pi / 4
    if case == "near":       # 1.3 from the camera: triangles of ~100s px
        coeff[:, -1] = 8.5
    if case == "empty":      # the last image's face far out of frame
        coeff[-1, -3] = 100.0
    if case == "turned":     # the last image shows mostly back faces
        coeff[-1, cfg.coeff_split[2] + 1] = 2.5
    bfm = G.device_bfm(assets)
    c = split_coeff(jnp.asarray(coeff), cfg)
    geom = G.coeffs_to_geometry(c, bfm, cfg)
    rad = SH.illuminate(geom.texture, geom.normals, c.gamma)
    if case == "shuffled":
        rid = np.random.default_rng(3).permutation(assets.n_faces)
        rows = jnp.asarray(assets.faces[rid])
        rid = jnp.asarray(rid)
    else:
        rows, rid = bfm.raster_rows, bfm.raster_row_id
    h = w = cfg.image_size
    rec = _pack_render_records(geom.verts_ndc, rad, rows, h, w,
                               RP.padded_rows(rows.shape[0]))
    return bfm, geom, rad, rows, rid, rec


def _port_select(cfg, bfm, rec, geom, rows, rid, records=None,
                 cull_backfaces=False):
    h = w = cfg.image_size
    return TR.rasterize_select(
        _t(rec) if records is None else records, _t(geom.verts_ndc),
        _t(bfm.faces, torch.int64), height=h, width=w, tile_h=cfg.tile_h,
        n_cols=cfg.raster_cols, cull_backfaces=cull_backfaces,
        row_faces=_t(rows, torch.int64), row_id=_t(rid, torch.int64))


def _hold_select_against_pallas(cfg, assets, batch, case,
                                cull_backfaces=False):
    """The port's rasterize_select against the reference's Pallas one on
    the same inputs and flag. Returns the port's (tri_id, row, sel) and
    the inputs."""
    inputs = _inputs(cfg, assets, batch, case)
    bfm, geom, _, rows, rid, rec = inputs
    h = w = cfg.image_size
    tid, sel = RP.rasterize_select(rec, geom.verts_ndc, bfm.faces, h, w,
                                   cfg.tile_h, cull_backfaces=cull_backfaces,
                                   n_cols=cfg.raster_cols,
                                   row_faces=rows, row_id=rid)
    ref = _ref_planes(sel, h, w, cfg.tile_h)
    ref_row = (ref[:, 45] + ref[:, 46] * 256 + ref[:, 47] * 65536
               ).astype(np.int64) - 1
    out = _port_select(cfg, bfm, rec, geom, rows, rid,
                       cull_backfaces=cull_backfaces)
    ttid, trow, tsel = out
    tid = np.asarray(tid)
    np.testing.assert_array_equal(ttid.numpy(), tid)
    np.testing.assert_array_equal(trow.numpy(), ref_row)
    got = tsel.numpy()
    assert got.shape == (batch, 20, h, w)
    affine = ref[:, 18:24] + ref[:, 24:30] + ref[:, 30:36]
    anchor = np.stack([ref[:, 36:39].sum(1), ref[:, 39:42].sum(1)], 1)
    np.testing.assert_allclose(got[:, 9:15], affine, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 15:17], anchor, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, :9], ref[:, :9] + ref[:, 9:18],
                               rtol=0, atol=1e-4)
    # background selects nothing; the winner row holds the winner face
    bg = tid < 0
    assert np.all(np.moveaxis(got, 1, -1)[bg] == 0.0)
    assert np.all(trow.numpy()[bg] == -1)
    np.testing.assert_array_equal(np.asarray(rid)[trow.numpy()[~bg]],
                                  tid[~bg])
    return out, inputs


@pytest.mark.parametrize("case", ["raster_rows", "shuffled", "roll45"])
def test_select_matches_pallas_select(cfg, assets, case):
    (tid, _, _), _ = _hold_select_against_pallas(cfg, assets, 1, case)
    assert (tid.numpy() >= 0).mean() > 0.1


def test_select_culls_backfaces_as_the_reference(cfg, assets):
    """cull_backfaces=True through rasterize_select equals the reference's
    Pallas rasterize_select with the flag, its tri_id is the contract
    path's (rasterize_batch) with the flag, and the flag culls: tri_id
    differs from the unculled one."""
    (tid, _, _), (bfm, geom, _, rows, rid, rec) = (
        _hold_select_against_pallas(cfg, assets, 2, "turned",
                                    cull_backfaces=True))
    assert (tid[0] >= 0).float().mean() > 0.1
    assert bool((tid[1] >= 0).any())
    assert not torch.equal(
        _port_select(cfg, bfm, rec, geom, rows, rid)[0], tid)
    h = w = cfg.image_size
    contract = TR.rasterize_batch(
        _t(geom.verts_ndc), _t(bfm.faces, torch.int64), height=h, width=w,
        tile_h=cfg.tile_h, n_cols=cfg.raster_cols, cull_backfaces=True,
        row_faces=_t(rows, torch.int64), row_id=_t(rid, torch.int64))[0]
    assert torch.equal(contract, tid)


def _check_adjoint_case(case, pos, tile_h):
    """The winner rows make the case they are named for."""
    cover = (pos >= 0).mean(axis=(1, 2))
    if case == "empty":
        assert cover[0] > 0.1 and cover[1] == 0
        return
    assert cover.min() > 0.1
    if case == "near":
        r = pos[0]
        counts = np.bincount(r[r >= 0])
        assert counts.max() > 32
        ys = np.nonzero(r == counts.argmax())[0]
        assert ys.max() // tile_h > ys.min() // tile_h


@pytest.mark.parametrize("case", ["raster_rows", "ragged", "near", "empty"])
def test_select_adjoint_matches_scatter_and_jax(cfg, assets, case):
    """The adjoint on the asset order; with tile_h 3, so the height (64)
    is no multiple of it; close to the camera, so a winner row's pixels
    span several bands and some row has more than 32 (a long row of the
    kernel's sum pass); and with an image that nothing covers."""
    bfm, geom, _, rows, rid, rec = _inputs(cfg, assets, 2, case)
    h = w = cfg.image_size
    if case == "ragged":
        cfg = dataclasses.replace(cfg, tile_h=3)
    g17 = np.random.default_rng(5).standard_normal(
        (2, h, w, 17)).astype(np.float32)

    def f(r):
        out = RP.rasterize_select(r, geom.verts_ndc, bfm.faces, h, w,
                                  cfg.tile_h, n_cols=cfg.raster_cols,
                                  row_faces=rows, row_id=rid)[1]
        b, nb, nf, band_px = out.shape
        out = jnp.transpose(out, (0, 1, 3, 2))     # banded, field-minor
        out = out.reshape(b, nb * cfg.tile_h, band_px // cfg.tile_h,
                          nf)[:, :h, :w]
        rad = out[..., 0:9] + out[..., 9:18]
        wcf = out[..., 18:24] + out[..., 24:30] + out[..., 30:36]
        anc = jnp.stack([out[..., 36:39].sum(-1),
                         out[..., 39:42].sum(-1)], -1)
        return jnp.sum(jnp.concatenate([rad, wcf, anc], -1) * g17)

    grad_jax = np.asarray(jax.grad(f)(rec))        # (B, 24, rows)

    records = _t(rec).requires_grad_(True)
    tid, row, sel = _port_select(cfg, bfm, rec, geom, rows, rid,
                                 records=records)
    loss = torch.sum(sel[:, :17] * _t(g17).permute(0, 3, 1, 2))
    (grad,) = torch.autograd.grad(loss, records)
    grad = grad.numpy()

    pos = row.numpy()
    _check_adjoint_case(case, pos, cfg.tile_h)
    expect = np.zeros((2, rec.shape[2], 24), np.float32)
    b_i, i_i, j_i = np.nonzero(pos >= 0)
    gn = np.concatenate([g17, np.zeros((2, h, w, 7), np.float32)], -1)
    np.add.at(expect, (b_i, pos[b_i, i_i, j_i]), gn[b_i, i_i, j_i])
    assert np.abs(expect).max() > 1.0
    np.testing.assert_allclose(grad, expect.transpose(0, 2, 1), rtol=0,
                               atol=1e-5)
    assert np.all(grad[:, 17:] == 0.0)
    if case != "near":
        np.testing.assert_allclose(grad, grad_jax, rtol=0, atol=1e-4)
        return
    # rows of ~100 pixels: the reference's 16-bit cotangent errs by up to
    # 2^-17 of each term, so its sum by up to 2^-17 of the sum of |terms|
    mag = np.zeros_like(expect)
    np.add.at(mag, (b_i, pos[b_i, i_i, j_i]), np.abs(gn[b_i, i_i, j_i]))
    assert np.all(np.abs(grad - grad_jax)
                  <= 2.0 ** -16 * mag.transpose(0, 2, 1) + 1e-6)


def test_shade_from_sel_matches_reference(cfg, assets):
    """The training record (with the static skin corners in rows 17..19)
    through the port's select and _shade_from_sel, against the
    reference's 56-row select record, its _shade_from_sel and the
    per-pixel skin gather skin_mask_image."""
    bfm, geom, rad, rows, rid, _ = _inputs(cfg, assets, 2, seed=9)
    h = w = cfg.image_size
    pad = RP.padded_rows(rows.shape[0])
    fields = _render_fields(geom.verts_ndc, rad, rows, h, w,
                            corner_adj=bfm.raster_corner_adj)
    rec56 = _pack_split_records(fields, rid, pad, skin=bfm.raster_skin)
    tid, sel = RP.rasterize_select(
        _stack24(fields, pad), geom.verts_ndc, bfm.faces, h, w, cfg.tile_h,
        n_cols=cfg.raster_cols, row_faces=rows, row_id=rid, rec48=rec56)
    color, bary, skin = _shade_from_sel(tid, sel, h, w, tile_h=cfg.tile_h)
    mask = (tid >= 0).astype(jnp.float32)
    skin_gather = skin_mask_image(
        RenderOut(image=None, mask=mask, tri_id=tid, bary=bary,
                  radiance=None, geometry=None), bfm)

    tbfm = TG.device_bfm(assets, "cpu")
    tfields = TRe._render_fields(_t(geom.verts_ndc), _t(rad),
                                 tbfm.raster_rows, h, w,
                                 corner_adj=tbfm.raster_corner_adj)
    trec = TRe._stack24(tfields, pad, skin=tbfm.raster_skin)
    ttid, _, tsel = _port_select(cfg, bfm, None, geom, rows, rid,
                                 records=trec)
    tcolor, tbary, tskin = TRe._shade_from_sel(ttid, tsel, h, w)
    np.testing.assert_array_equal(ttid.numpy(), np.asarray(tid))
    for got, ref in ((tcolor, color), (tbary, bary), (tskin, skin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)
    tmask = (ttid >= 0).to(torch.float32)
    np.testing.assert_allclose((tmask * tskin).numpy(),
                               np.asarray(skin_gather), rtol=0, atol=1e-4)
    cov = np.asarray(tid) >= 0
    np.testing.assert_allclose(tbary.numpy().sum(-1)[cov], 1.0, atol=1e-5)


def test_wrappers_on_cpu_take_plain_versions(cfg, assets):
    """On CPU tensors the wrappers are the plain versions (bit for bit)
    and launch nothing; they reject inputs the kernels do not take."""
    bfm, geom, _, rows, rid, rec = _inputs(cfg, assets, 2, seed=12)
    h = w = cfg.image_size
    win = TR.band_windows(_t(geom.verts_ndc), _t(rows, torch.int64),
                          _t(rid, torch.int64), h, w, cfg.tile_h,
                          cfg.raster_cols)
    kw = dict(height=h, width=w, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    records = _t(rec)
    _build.reset_launches()
    got = TR.select_windows(win, records, **kw)
    ref = TR.select_windows_reference(win, records, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    tid, row, _ = got
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 20, h, w)).astype(np.float32))
    grad_kw = dict(rows=records.shape[2], tile_h=cfg.tile_h)
    d = TR.select_grad(row, g, win.blo, win.bn, **grad_kw)
    assert torch.equal(d, TR.select_grad_reference(row, g, win.blo, win.bn,
                                                   **grad_kw))
    assert d.shape == (2, 24, records.shape[2])
    assert _build.LAUNCHES["raster_select"] == 0
    assert _build.LAUNCHES["select_grad"] == 0

    with pytest.raises(ValueError):
        TR.select_windows(win, records.double(), **kw)
    with pytest.raises(ValueError):
        TR.select_windows(win, records[:, :20], **kw)
    with pytest.raises(ValueError):
        TR.select_windows(win, records.transpose(1, 2).contiguous()
                          .transpose(1, 2), **kw)
    with pytest.raises(ValueError):
        TR.select_grad(row.to(torch.int64), g, win.blo, win.bn, **grad_kw)
    with pytest.raises(ValueError):
        TR.select_grad(row, g[:, :17], win.blo, win.bn, **grad_kw)
    with pytest.raises(ValueError):
        TR.select_grad(row, g.transpose(2, 3), win.blo, win.bn, **grad_kw)
    with pytest.raises(ValueError, match="multiple"):
        TR.select_grad(row, g, win.blo, win.bn, rows=records.shape[2] - 8,
                       tile_h=cfg.tile_h)
