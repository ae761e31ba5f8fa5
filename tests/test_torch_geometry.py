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

coeffs_to_geometry takes the forward-only path (the basis products, then
vertex_pass: on the CPU its plain version) wherever autograd records
nothing, so the comparisons above hold that path against the reference.
Its plain version is the port's own eager forward op for op, so on the
same CPU every field, the radiance included, is bit for bit the eager
path's (under no_grad, and with grad enabled but nothing requiring it).
Under grad the eager path is taken, unchanged: outputs and gradients bit
for bit today's composition of the eager ops. Its normals sum each
vertex's faces in slot order with +0.0 for a pad slot, as _gather_sum
does, also on a vertex whose slots are all pad or start with pad.
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


def _eager(tc, tbfm, cfg):
    """coeffs_to_geometry's differentiable path (coefficients that require
    grad), detached."""
    leaf = tuple(t.detach().clone().requires_grad_(True) for t in tc)
    geom = TG.coeffs_to_geometry(type(tc)(*leaf), tbfm, cfg)
    assert geom.radiance is None
    rad = TSH.illuminate(geom.texture, geom.normals, leaf[4])
    return TG.Geometry(*(t.detach() for t in geom._replace(radiance=rad)))


@pytest.mark.parametrize("mode", ["no_grad", "nothing_requires_grad"])
def test_vertex_pass_matches_eager_path(cfg, both, mode):
    """The forward-only path (the plain version on the CPU) against the
    eager path on the same coefficients: every field bit for bit, under
    no_grad and with grad enabled but no input requiring it."""
    _, _, _, tbfm, tc, _ = both
    with torch.set_grad_enabled(mode != "no_grad"):
        got = TG.coeffs_to_geometry(tc, tbfm, cfg)
    ref = _eager(tc, tbfm, cfg)
    assert got.radiance is not None and ref.radiance is not None
    for name in TG.Geometry._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_vertex_pass_matches_jax_geometry(cfg, both):
    """The forward-only path's radiance against the reference's
    illuminate on the reference's own geometry, within the tolerances
    above (normals 1e-5 feed it)."""
    _, c, geom, tbfm, tc, _ = both
    with torch.no_grad():
        got = TG.coeffs_to_geometry(tc, tbfm, cfg)
    ref = SH.illuminate(geom.texture, geom.normals, c.gamma)
    np.testing.assert_allclose(got.radiance.numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_grad_path_is_the_eager_path(cfg, both, monkeypatch):
    """Where autograd records the call, coeffs_to_geometry never reaches
    vertex_pass, and its outputs and gradients are bit for bit the
    composition of the eager ops; with no_grad, or with nothing that
    requires grad, it takes vertex_pass."""
    _, _, _, tbfm, tc, _ = both
    taken = []
    real = TG.vertex_pass

    def spy(*args):
        taken.append(1)
        return real(*args)

    monkeypatch.setattr(TG, "vertex_pass", spy)
    rng = np.random.default_rng(35)
    n = tbfm.skin_mask.shape[0]
    w = {k: torch.from_numpy(rng.standard_normal((3, *s)).astype(np.float32))
         for k, s in (("normals", (n, 3)), ("verts_ndc", (n, 3)),
                      ("texture", (n, 3)), ("verts_world", (n, 3)),
                      ("landmarks2d", (68, 2)))}

    def grads(fn):
        leaf = tuple(t.detach().clone().requires_grad_(True) for t in tc)
        geom = fn(type(tc)(*leaf))
        loss = sum((getattr(geom, k) * w[k]).sum() for k in w)
        return geom, torch.autograd.grad(loss, leaf, allow_unused=True)

    def today(c):
        shape = TG.shape_formation(c.id, c.exp, tbfm)
        rot = TG.compute_rotation(c.angles)
        verts = TG.rigid_transform(shape, rot, c.trans)
        normals = TG.compute_norm(shape, tbfm.faces, tbfm.vertex_face_adj,
                                  tbfm.vertex_corner_adj_cm)
        return TG.Geometry(
            shape=shape, verts_world=verts, verts_ndc=TG.to_ndc(verts, cfg),
            texture=TG.texture_formation(c.tex, tbfm),
            normals=normals @ rot.transpose(-1, -2),
            landmarks2d=TG.project_landmarks(verts, tbfm, cfg))

    geom, g = grads(lambda c: TG.coeffs_to_geometry(c, tbfm, cfg))
    ref, g_ref = grads(today)
    assert not taken and geom.radiance is None
    for name in ref._fields[:6]:
        assert torch.equal(getattr(geom, name), getattr(ref, name)), name
    for a, b in zip(g, g_ref):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    with torch.no_grad():
        assert TG.coeffs_to_geometry(tc, tbfm, cfg).radiance is not None
    assert TG.coeffs_to_geometry(tc, tbfm, cfg).radiance is not None
    assert len(taken) == 2


def test_vertex_pass_sums_pad_slots_as_gather_sum(cfg, assets):
    """Normals on a mesh whose adjacency has pad slots (the tiny mesh's
    264), with vertex 0's slots all pad and vertex 1's pad slots moved to
    the front: at zero angles the forward-only path's normals equal a
    numpy restatement of _gather_sum (slot order, +0.0 for a pad slot)
    then normalised, and compute_norm, bit for bit; vertex 0's is the
    zero vector."""
    tbfm = TG.device_bfm(assets, "cpu")
    f = tbfm.faces.shape[0]
    adj = tbfm.vertex_face_adj.clone()
    pad = adj == f
    assert bool(pad.any())
    row = next(v for v in range(adj.shape[0])
               if 0 < int(pad[v].sum()) < adj.shape[1] and v > 1)
    adj[1] = torch.cat([adj[row][pad[row]], adj[row][~pad[row]]])
    adj[0] = f
    assert int(adj[1, 0]) == f and int(adj[1, -1]) < f
    tbfm = tbfm._replace(vertex_face_adj=adj)
    coeff = make_coeff(cfg, np.random.default_rng(36), batch=2)
    tc = t_split_coeff(torch.from_numpy(coeff), cfg)
    tc = tc._replace(angles=torch.zeros_like(tc.angles))
    with torch.no_grad():
        got = TG.coeffs_to_geometry(tc, tbfm, cfg)
    s = got.shape.numpy()
    faces = tbfm.faces.numpy()
    a = s[:, faces[:, 1]] - s[:, faces[:, 0]]
    b = s[:, faces[:, 2]] - s[:, faces[:, 0]]
    fn = np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                   a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                   a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)
    fn = np.concatenate([fn, np.zeros_like(fn[:, :1])], axis=1)
    adj = adj.numpy()
    total = fn[:, adj[:, 0]]              # slot 0 as it is: no 0 + x
    for k in range(1, adj.shape[1]):
        total = total + fn[:, adj[:, k]]
    assert total.dtype == np.float32
    # normalised with torch's ops, as compute_norm does (torch's float32
    # sqrt on the CPU is not numpy's bit for bit)
    total = torch.from_numpy(total)
    norm = torch.sqrt(total[..., 0] * total[..., 0]
                      + total[..., 1] * total[..., 1]
                      + total[..., 2] * total[..., 2])[..., None]
    want = total / torch.clamp(norm, min=1e-8)
    assert torch.equal(got.normals, want)
    np.testing.assert_array_equal(
        got.normals.numpy(),
        TG.compute_norm(got.shape, tbfm.faces, tbfm.vertex_face_adj,
                        tbfm.vertex_corner_adj_cm).numpy())
    assert not got.normals[:, 0].any()
