"""Port (facerecon_tpu_torch) geometry, SH and binning against the JAX
reference on the same numpy inputs, at tiny_config().

Tolerances: verts and ndc to atol 1e-6, because the synthesis matmuls
sum in a different order in torch and XLA (one ulp of the ~10 camera
depth is 9.5e-7). compute_norm on identical vertices agrees to 1e-6;
the normals at the end of coeffs_to_geometry agree to 1e-5, because
their face normals are cross products of ~0.07-long edges, whose
differences turn those one-ulp vertex differences into ~1e-6 relative
errors before normalisation. The binning windows and masks must be EXACTLY
equal, and the setup fields agree to 1e-6 (they come out identical: the
same float32 ops on the same ndc inputs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from facerecon_tpu.config import tiny_config
from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu.ops import sh as SH
from facerecon_tpu.ops.binning import bin_triangles_static_t
from facerecon_tpu.utils.bfm import synthetic_bfm
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch.ops import binning as TB
from facerecon_tpu_torch.ops import geometry as TG
from facerecon_tpu_torch.ops import rasterize as TR
from facerecon_tpu_torch.ops import sh as TSH
from facerecon_tpu_torch.utils.coeffs import split_coeff as t_split_coeff

from conftest import make_coeff

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both(cfg, assets):
    """The same coefficients through both packages' geometry."""
    coeff = make_coeff(cfg, np.random.default_rng(21), batch=3)
    bfm = G.device_bfm(assets)
    c = split_coeff(jnp.asarray(coeff), cfg)
    tbfm = TG.device_bfm(assets, "cpu")
    tc = t_split_coeff(torch.from_numpy(coeff), cfg)
    return (bfm, c, G.coeffs_to_geometry(c, bfm, cfg),
            tbfm, tc, TG.coeffs_to_geometry(tc, tbfm, cfg))


def test_device_bfm_matches(assets):
    bfm = G.device_bfm(assets)
    tbfm = TG.device_bfm(assets, "cpu")
    for name in G.DeviceBFM._fields:
        np.testing.assert_array_equal(getattr(tbfm, name).numpy(),
                                      np.asarray(getattr(bfm, name)), name)


def test_coeffs_to_geometry_matches(both):
    _, _, geom, _, _, tgeom = both
    for name in ("shape", "verts_world", "verts_ndc", "texture"):
        np.testing.assert_allclose(getattr(tgeom, name).numpy(),
                                   np.asarray(getattr(geom, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tgeom.normals.numpy(),
                               np.asarray(geom.normals), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgeom.landmarks2d.numpy(),
                               np.asarray(geom.landmarks2d), rtol=0,
                               atol=1e-4)


def test_compute_norm_matches(assets):
    bfm = G.device_bfm(assets)
    tbfm = TG.device_bfm(assets, "cpu")
    v = (np.asarray(assets.mean_shape).reshape(1, -1, 3)
         + 0.05 * np.random.default_rng(4).standard_normal(
             (2, assets.n_vertices, 3))).astype(np.float32)
    ref = G.compute_norm(jnp.asarray(v), bfm.faces, assets.n_vertices,
                         adj=bfm.vertex_face_adj,
                         corner_adj=bfm.vertex_corner_adj,
                         corner_adj_cm=bfm.vertex_corner_adj_cm)
    got = TG.compute_norm(torch.from_numpy(v), tbfm.faces,
                          tbfm.vertex_face_adj, tbfm.vertex_corner_adj_cm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_illuminate_matches(both):
    _, c, geom, _, tc, tgeom = both
    # same inputs on both sides: the geometry's own texture/normals
    tex, nrm = (np.array(geom.texture), np.array(geom.normals))
    ref = SH.illuminate(jnp.asarray(tex), jnp.asarray(nrm), c.gamma)
    got = TSH.illuminate(torch.from_numpy(tex), torch.from_numpy(nrm),
                         tc.gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_bin_triangles_static_t_matches(cfg, both):
    bfm, _, geom, tbfm, _, _ = both
    h = w = cfg.image_size
    vndc = np.asarray(geom.verts_ndc)
    ref = bin_triangles_static_t(jnp.asarray(vndc), bfm.raster_rows, h, w,
                                 cfg.tile_h, 128, tile_w=16, mask_words=2)
    got = TB.bin_triangles_static_t(torch.from_numpy(vndc),
                                    tbfm.raster_rows, h, w, cfg.tile_h, 128,
                                    tile_w=16, mask_words=2)
    np.testing.assert_array_equal(got.band_lo.numpy(),
                                  np.asarray(ref.band_lo))
    np.testing.assert_array_equal(got.n_chunks.numpy(),
                                  np.asarray(ref.n_chunks))
    np.testing.assert_array_equal(got.chunk_mask.numpy(),
                                  np.asarray(ref.chunk_mask))
    for k, (a, b) in enumerate(zip(got.coeffs_t, ref.coeffs_t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=f"field {k}")


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
def test_band_windows_matches(cfg, assets, both, order):
    """Exact windows and masks, in the asset's raster row order, and in a
    shuffled face order on a larger mesh (11.6k faces), whose band
    windows overflow the 64-chunk mask."""
    h = w = cfg.image_size
    if order == "raster_rows":
        vndc = np.asarray(both[2].verts_ndc)
        rows, rid = np.asarray(assets.raster_rows), np.asarray(
            assets.raster_row_id)
    else:
        big = tiny_config(n_vertices=6000)
        big_assets = synthetic_bfm(big, 0)
        c = split_coeff(jnp.asarray(make_coeff(
            big, np.random.default_rng(5), batch=2)), big)
        vndc = np.asarray(G.coeffs_to_geometry(
            c, G.device_bfm(big_assets), big).verts_ndc)
        rid = np.random.default_rng(3).permutation(big_assets.n_faces)
        rows = big_assets.faces[rid]
    (blo, bn), cmask, setup = RP._band_windows(
        jnp.asarray(vndc), jnp.asarray(rows), jnp.asarray(rid), h, w,
        cfg.tile_h, cfg.raster_cols, False)
    win = TR.band_windows(torch.from_numpy(vndc), torch.from_numpy(rows),
                          torch.from_numpy(rid), h, w, cfg.tile_h,
                          cfg.raster_cols)
    np.testing.assert_array_equal(win.blo.numpy(), np.asarray(blo))
    np.testing.assert_array_equal(win.bn.numpy(), np.asarray(bn))
    np.testing.assert_array_equal(win.cmask.numpy(), np.asarray(cmask))
    np.testing.assert_allclose(win.setup.numpy(), np.asarray(setup),
                               rtol=0, atol=1e-6)
    f = rows.shape[0]
    assert np.all(win.setup.numpy()[:, 2:6:3, f:] == np.float32(-3e38))
    if order == "shuffled":
        assert int(win.bn.max()) > 64
