"""Gradients of the port's geometry and render fields against the JAX
reference, at tiny_config().

The port's corner gather and normal accumulation are autograd Functions
whose adjoints are fixed gathers (the reference's take_corner_planes and
_accumulate_fn_planes custom VJPs), not the index_put_ scatter autograd
would derive. Bars:
  - the gather adjoints equal autograd's scatter of the same gathers
    within 1e-6 of the gradient's max (another summation order), and the
    forward values are bit-identical;
  - gradients of coeffs_to_geometry's outputs and of the render fields
    within 1e-5 of max |g| of jax.grad of the reference's;
  - the training render's gradient in the depth coordinate is exactly
    zero (twin of tests/test_rasterize.py:156): depth only enters the
    frozen z-test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import render as R
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch.ops import geometry as TG
from facerecon_tpu_torch.ops import render as TRe
from facerecon_tpu_torch.utils.coeffs import split_coeff as t_split_coeff

from conftest import make_coeff

torch.set_num_threads(2)


def _close(got, ref, rel):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(got - ref).max()) <= rel * scale


def test_gather_adjoints_equal_autograd_scatter(assets):
    tbfm = TG.device_bfm(assets, "cpu")
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.standard_normal((2, assets.n_vertices, 3)),
                     dtype=torch.float32, requires_grad=True)
    # the raster rows' bin-padding rows have no corners in the table:
    # their records never win a pixel, so their cotangent is zero
    live = (tbfm.raster_row_id < assets.n_faces).to(torch.float32)
    for faces, adj, keep in ((tbfm.faces, tbfm.vertex_corner_adj_cm, 1.0),
                             (tbfm.raster_rows, tbfm.raster_corner_adj,
                              live.repeat(3))):
        idx = faces.T.reshape(-1)
        planes = tuple(v[..., k] for k in range(3))
        got = TG.take_corner_planes(planes, idx, adj)
        ref = tuple(p[..., idx] for p in planes)
        w = [torch.tensor(rng.standard_normal(r.shape),
                          dtype=torch.float32) * keep for r in ref]
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        (g_got,) = torch.autograd.grad(sum((a * c).sum()
                                           for a, c in zip(got, w)), v)
        (g_ref,) = torch.autograd.grad(sum((a * c).sum()
                                           for a, c in zip(ref, w)), v)
        _close(g_got.numpy(), g_ref.numpy(), 1e-6)

    # the normal accumulation: Function against plain autograd
    f = tbfm.faces.shape[0]
    fn = torch.tensor(rng.standard_normal((2, f)), dtype=torch.float32,
                      requires_grad=True)
    (acc,) = TG._AccumulateFnPlanes.apply(tbfm.vertex_face_adj, tbfm.faces,
                                          fn)
    ref = TG._gather_sum(fn, tbfm.vertex_face_adj)
    assert torch.equal(acc, ref)
    w = torch.tensor(rng.standard_normal(ref.shape), dtype=torch.float32)
    (g_got,) = torch.autograd.grad((acc * w).sum(), fn)
    (g_ref,) = torch.autograd.grad((ref * w).sum(), fn)
    _close(g_got.numpy(), g_ref.numpy(), 1e-6)


def test_geometry_gradients_match_jax(cfg, assets):
    coeff = make_coeff(cfg, np.random.default_rng(31), batch=2)
    rng = np.random.default_rng(32)
    bfm = G.device_bfm(assets)
    tbfm = TG.device_bfm(assets, "cpu")
    n = assets.n_vertices
    w = {k: rng.standard_normal((2, *s)).astype(np.float32)
         for k, s in (("normals", (n, 3)), ("verts_ndc", (n, 3)),
                      ("texture", (n, 3)), ("landmarks2d", (68, 2)))}
    w["landmarks2d"] *= 1e-3          # pixel-scale outputs

    def loss_jax(cv):
        geom = G.coeffs_to_geometry(split_coeff(cv, cfg), bfm, cfg)
        return sum(jnp.sum(getattr(geom, k) * w[k]) for k in w)

    g_ref = np.asarray(jax.grad(loss_jax)(jnp.asarray(coeff)))
    cv = torch.tensor(coeff, requires_grad=True)
    geom = TG.coeffs_to_geometry(t_split_coeff(cv, cfg), tbfm, cfg)
    loss = sum((getattr(geom, k) * torch.tensor(w[k])).sum() for k in w)
    (g,) = torch.autograd.grad(loss, cv)
    _close(g.numpy(), g_ref, 1e-5)

    # the normals' own gradient, on identical vertices
    v = (np.asarray(assets.mean_shape).reshape(1, -1, 3) + 0.05 * rng
         .standard_normal((2, n, 3))).astype(np.float32)

    def norm_jax(vv):
        nrm = G.compute_norm(vv, bfm.faces, n, adj=bfm.vertex_face_adj,
                             corner_adj=bfm.vertex_corner_adj,
                             corner_adj_cm=bfm.vertex_corner_adj_cm)
        return jnp.sum(nrm * w["normals"])

    g_ref = np.asarray(jax.grad(norm_jax)(jnp.asarray(v)))
    vt = torch.tensor(v, requires_grad=True)
    nrm = TG.compute_norm(vt, tbfm.faces, tbfm.vertex_face_adj,
                          tbfm.vertex_corner_adj_cm)
    (g,) = torch.autograd.grad((nrm * torch.tensor(w["normals"])).sum(), vt)
    _close(g.numpy(), g_ref, 1e-5)


def test_render_field_gradients_match_jax(cfg, assets):
    bfm = G.device_bfm(assets)
    tbfm = TG.device_bfm(assets, "cpu")
    rng = np.random.default_rng(33)
    c = split_coeff(jnp.asarray(make_coeff(cfg, rng, batch=2)), cfg)
    geom = G.coeffs_to_geometry(c, bfm, cfg)
    vndc = np.asarray(geom.verts_ndc)
    rad = rng.random(vndc.shape).astype(np.float32)
    h = w = cfg.image_size
    f = assets.raster_rows.shape[0]
    wts = rng.standard_normal((17, 2, f)).astype(np.float32)
    wts[9:15] *= 1e-2                 # affine coefficients are O(1/area)

    def loss_jax(vv, rr):
        flds = R._render_fields(vv, rr, bfm.raster_rows, h, w,
                                corner_adj=bfm.raster_corner_adj)
        return sum(jnp.sum(a * b) for a, b in zip(flds, wts))

    gv_ref, gr_ref = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(vndc),
                                                        jnp.asarray(rad))
    vt = torch.tensor(vndc, requires_grad=True)
    rt = torch.tensor(rad, requires_grad=True)
    flds = TRe._render_fields(vt, rt, tbfm.raster_rows, h, w,
                              corner_adj=tbfm.raster_corner_adj)
    loss = sum((a * torch.tensor(b)).sum() for a, b in zip(flds, wts))
    gv, gr = torch.autograd.grad(loss, (vt, rt))
    _close(gv.numpy(), gv_ref, 1e-5)
    _close(gr.numpy(), gr_ref, 1e-5)


def test_render_depth_gradient_is_zero(cfg, assets):
    tbfm = TG.device_bfm(assets, "cpu")
    coeff = make_coeff(cfg, np.random.default_rng(34), batch=1)
    c = t_split_coeff(torch.tensor(coeff), cfg)
    geom = TG.coeffs_to_geometry(c, tbfm, cfg)
    vndc = geom.verts_ndc.detach().requires_grad_(True)
    tex = geom.texture.detach().requires_grad_(True)
    out = TRe.render_geometry(geom._replace(verts_ndc=vndc, texture=tex),
                              c.gamma, tbfm, cfg)
    assert out.skin is not None and float(out.mask.mean()) > 0.1
    target = torch.rand(out.image.shape,
                        generator=torch.Generator().manual_seed(0))
    loss = ((out.image - target) ** 2).sum() + out.skin.sum()
    gv, gt = torch.autograd.grad(loss, (vndc, tex))
    assert torch.all(gv[..., 2] == 0)
    assert float(gv[..., :2].abs().max()) > 0
    assert float(gt.abs().max()) > 0
    assert bool(torch.isfinite(gv).all())
    # the rendered image is the inference path's, pixel for pixel
    with torch.no_grad():
        ref = TRe.render_geometry(geom, c.gamma, tbfm, cfg, inference=True)
    assert torch.equal(out.tri_id, ref.tri_id)
    assert torch.equal(out.image.detach(), ref.image)
    assert torch.equal(out.bary.detach(), ref.bary)
