"""The render records' contract on the CPU (ops/render.py), which the
record kernel (csrc/records.cu, through pack_records) is held to bit for
bit on the card by tests/test_torch_cuda.py and tests/test_torch_deca.py.

On the CPU both record packs are their plain versions and launch
nothing. The BFM record is [radiance corners 9 | affine forms 6 | anchor
x0, y0] and zero in fields 17..23 and in every field of the rows past
F'; DECA's carries the rows' UVs (flame.raster_uv) in fields 17..22 and
zero in field 23. Dead rows (no area, and the [0, 0, 0] pad rows of the
raster order) carry the eager ops' signed zeros in their forms. Under
grad the packs and the training render keep the eager, differentiable
ops, and the gradient reaches the vertices and the radiance. The file
imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import flame as FL
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops import render as TRe
from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff
from facerecon_tpu_torch.utils.flame import flame_assets
from perfbench import flame_data
from perfbench.kinds import flame_render as FR

torch.set_num_threads(2)

TINY_MESH = {"rings": 17, "cols": 18, "mouth_quads": 3}
TINY_SIZES = {"n_shape": 100, "n_exp": 50, "n_tex": 50, "albedo_size": 64}
SIZE, UV = 64, 32


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def bfm_case():
    """tiny_config's BFM, two sampled faces: the config, the asset pack
    on the CPU, and the geometry with its radiance (vertex_pass's plain
    version under no_grad)."""
    cfg = tiny_config()
    bfm = device_bfm(synthetic_bfm(cfg, 0), "cpu")
    c = split_coeff(torch.as_tensor(sample_coeffs(
        np.random.default_rng(6), cfg, 2)), cfg)
    with torch.no_grad():
        geom = coeffs_to_geometry(c, bfm, cfg)
    return cfg, bfm, c, geom


@pytest.fixture(scope="module")
def deca_case():
    """The tiny seeded FLAME stand-in at 64 px: its pack on the CPU and
    the geometry of three sampled code sets."""
    from facerecon_tpu_torch.config import deca_config
    cfg = deca_config(n_vertices=307, n_faces=588, image_size=SIZE,
                      uv_size=UV, tile_h=2, raster_cols=2)
    arrays = flame_data.flame_arrays(TINY_SIZES, TINY_MESH, 0)
    dfl = FL.device_flame(flame_assets(arrays, SIZE), "cpu", 50, UV)
    codes = torch.from_numpy(FR.sample_codes(np.random.default_rng(4),
                                             TINY_SIZES, 3))
    with torch.no_grad():
        geo = FL.flame_geometry(split_coeff(codes, cfg), dfl, cfg)
    return dfl, geo


def _bfm_pack(bfm, geom, size, fn=TRe.pack_render_records):
    rows = bfm.raster_rows
    return fn(geom.verts_ndc, geom.radiance, rows, size, size,
              R.padded_rows(rows.shape[0]))


def _deca_pack(dfl, geo, fn=TRe.pack_texture_records):
    return fn(geo.verts_ndc, geo.normals, dfl, SIZE, SIZE,
              R.padded_rows(dfl.raster_rows.shape[0]))


@pytest.mark.parametrize("path", ["bfm", "deca"])
def test_packs_on_the_cpu_are_their_plain_versions(bfm_case, deca_case,
                                                   path):
    """Bit for bit the plain version (int32 bits over every field and
    padded row), and no kernel launched."""
    before = dict(_build.LAUNCHES)
    if path == "bfm":
        cfg, bfm, _, geom = bfm_case
        got = _bfm_pack(bfm, geom, cfg.image_size)
        want = _bfm_pack(bfm, geom, cfg.image_size,
                         TRe.pack_render_records_reference)
    else:
        dfl, geo = deca_case
        got = _deca_pack(dfl, geo)
        want = _deca_pack(dfl, geo, TRe.pack_texture_records_reference)
    assert _build.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[1] == 24
    assert torch.equal(_bits(got), _bits(want))


def test_bfm_record_layout(bfm_case):
    """Fields 0..8 the radiance of each row's corners (corner-major),
    15..16 corner 0's screen position, 17..23 and the rows past F' zero
    (+0.0)."""
    cfg, bfm, _, geom = bfm_case
    s = cfg.image_size
    rec = _bfm_pack(bfm, geom, s)
    rows = bfm.raster_rows
    f = rows.shape[0]
    assert rec.shape == (2, 24, R.padded_rows(f)) and rec.shape[2] > f
    for c in range(3):
        for k in range(3):
            assert torch.equal(rec[:, 3 * c + k, :f],
                               geom.radiance[:, rows[:, c], k])
    v0 = geom.verts_ndc[:, rows[:, 0]]
    assert torch.equal(rec[:, 15, :f], (v0[..., 0] + 1.0) * (s / 2.0))
    assert torch.equal(rec[:, 16, :f], (1.0 - v0[..., 1]) * (s / 2.0))
    assert not bool(_bits(rec[:, 17:]).any())
    assert not bool(_bits(rec[:, :, f:]).any())


def test_deca_record_tail_is_the_uv_rows(deca_case):
    """Fields 0..16 as the BFM's pack computes them from the normals,
    17..22 the rows' UVs (flame.raster_uv), 23 and the rows past F' zero
    (+0.0)."""
    dfl, geo = deca_case
    rec = _deca_pack(dfl, geo)
    f = dfl.raster_rows.shape[0]
    head = TRe.pack_render_records(geo.verts_ndc, geo.normals,
                                   dfl.raster_rows, SIZE, SIZE, rec.shape[2])
    assert torch.equal(_bits(rec[:, :17]), _bits(head[:, :17]))
    assert dfl.raster_uv.shape == (6, f)
    assert torch.equal(_bits(rec[:, 17:23, :f]),
                       _bits(dfl.raster_uv.expand(rec.shape[0], 6, f)))
    assert not bool(_bits(rec[:, 23]).any())
    assert not bool(_bits(rec[:, :, f:]).any())


# screen corners (64 px) of dead rows and the signs of their forms
# (wa0, wb0, wc0, wa1, wb1, wc1) that the eager ops give with inv_area 0:
# (v1 - v2) * 0, (u2 - u1) * 0, (u1 v2 - u2 v1) * 0, v2 * 0, -u2 * 0, 0
DEAD = {
    "rising": (((10, 10), (11, 11), (12, 12)), (1, 0, 0, 0, 1, 0)),
    "falling": (((10, 10), (9, 9), (8, 8)), (0, 1, 0, 1, 0, 0)),
    "point": (((20, 30), (20, 30), (20, 30)), (0, 0, 0, 0, 1, 0)),
}


@pytest.mark.parametrize("case", list(DEAD))
def test_dead_rows_carry_the_eager_signed_zeros(case):
    """A row without area (collinear corners, or one point as the
    raster order's [0, 0, 0] pad rows are) gets inv_area 0: its forms
    are the products' signed zeros, in the plain version's op order,
    and a live row beside it keeps finite forms."""
    corners, signs = DEAD[case]
    s = 64
    pts = [*corners, (5, 5), (40, 8), (12, 50)]
    ndc = torch.tensor([[[x / (s / 2.0) - 1.0, 1.0 - y / (s / 2.0), 0.5]
                         for x, y in pts]], dtype=torch.float32)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    rad = torch.rand((1, len(pts), 3), generator=torch.Generator(
        ).manual_seed(1))
    rec = TRe.pack_render_records(ndc, rad, faces, s, s,
                                  R.padded_rows(2))
    forms = rec[0, 9:15, 0]
    assert not bool(forms.ne(0).any())
    assert [int(b) for b in torch.signbit(forms)] == list(signs)
    assert [float(v) for v in rec[0, 15:17, 0]] == list(corners[0])
    live = rec[0, 9:15, 1]
    assert bool(torch.isfinite(live).all()) and bool(live[:2].ne(0).any())


def test_record_kernel_wrapper_refuses_the_cpu(bfm_case):
    """pack_records is the kernel alone: CPU tensors raise."""
    cfg, bfm, _, geom = bfm_case
    with pytest.raises(ValueError):
        _bfm_pack(bfm, geom, cfg.image_size, TRe.pack_records)


def test_record_packs_under_grad_stay_differentiable(bfm_case):
    """Where autograd records, pack_render_records is the eager pack:
    the same values as under no_grad, and a weighted sum's gradient
    reaches both the vertices and the radiance."""
    cfg, bfm, _, geom = bfm_case
    vndc = geom.verts_ndc.clone().requires_grad_(True)
    rad = geom.radiance.clone().requires_grad_(True)
    rec = _bfm_pack(bfm, geom._replace(verts_ndc=vndc, radiance=rad),
                    cfg.image_size)
    assert rec.requires_grad
    assert torch.equal(_bits(rec.detach()),
                       _bits(_bfm_pack(bfm, geom, cfg.image_size)))
    wts = torch.randn(rec.shape, generator=torch.Generator().manual_seed(2))
    gv, gr = torch.autograd.grad((rec * wts).sum(), (vndc, rad))
    assert bool(gv[..., :2].ne(0).any()) and bool(gr.ne(0).any())
    assert not bool(gv[..., 2].ne(0).any())        # depth takes none


def test_training_render_records_are_eager(bfm_case):
    """The training render (inference=False) builds its record with the
    eager ops under grad, launching nothing, and the image's gradient
    reaches the vertices and, through the radiance, the texture."""
    cfg, bfm, c, geom = bfm_case
    vndc = geom.verts_ndc.clone().requires_grad_(True)
    tex = geom.texture.clone().requires_grad_(True)
    before = dict(_build.LAUNCHES)
    out = TRe.render_geometry(geom._replace(verts_ndc=vndc, texture=tex,
                                            radiance=None),
                              c.gamma, bfm, cfg)
    assert _build.LAUNCHES == before
    assert out.radiance.requires_grad
    gv, gt = torch.autograd.grad(out.image.sum(), (vndc, tex))
    assert bool(gv[..., :2].ne(0).any()) and bool(gt.ne(0).any())
