"""DECA's coarse model on FLAME in the port, held against the plain
reference perfbench/reference/deca.py (float32, nothing of the program)
on a tiny seeded FLAME stand-in (perfbench/flame_data.py: 307 vertices,
588 faces, a 64^2 albedo downsampled to 32^2) at 64 px, on the CPU:
FLAME's skinning and landmarks at zero pose and at yaws past the contour
table's clamp on both sides, the albedo decode, the textured raster's
plain version against the reference's per-pixel grid_sample shading,
Pipeline.reconstruct with DECA's two-layer head (BatchNorm and fused),
and the benchmark's cell through perfbench.run.run_cell, judged correct,
while a run without pose correctives, one with a nearest-texel fetch and
the reference one precision below are judged not correct; besides, the
cell's configuration file against the stand-ins it states, and a
pipeline refusing the other face model's assets.

The tests marked `cuda` hold the textured kernel (csrc/raster_texture.cu)
against its plain version at the published sizes, and the record kernel
(csrc/records.cu) with the UV rows as its tail against its plain version
bit for bit at the cell's microbatch, the render's CUDA graph and record
kernel against the eager functions, the graph's lifetime (one a name,
freed with the asset pack), run Pipeline.reconstruct at batch 8 on the
card against the reference, and run the cell at batch 8 on the card;
they skip without a card.
The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deca.py
"""

import copy
import gc
import math
import weakref

import numpy as np
import pytest
import torch

from facerecon_tpu_torch.config import deca_config
from facerecon_tpu_torch.ops import _build, flame as FL
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.utils.coeffs import DECACodes, split_coeff
from facerecon_tpu_torch.utils.flame import flame_assets, load_npz, save_npz
from perfbench import check, control, flame_data, run, spec
from perfbench.kinds import flame_render as FR
from perfbench.reference import deca

CPU = torch.device("cpu")
SEED = 2 ** 31 + 987
TINY_MESH = {"rings": 17, "cols": 18, "mouth_quads": 3}
TINY_SIZES = {"n_shape": 100, "n_exp": 50, "n_tex": 50, "albedo_size": 64}
SIZE, UV = 64, 32


def tiny_cfg(**kw):
    return deca_config(n_vertices=307, n_faces=588, image_size=SIZE,
                       uv_size=UV, tile_h=2, raster_cols=2, **kw)


@pytest.fixture(scope="module")
def arrays():
    return flame_data.flame_arrays(TINY_SIZES, TINY_MESH, 0)


@pytest.fixture(scope="module")
def assets(arrays):
    return flame_assets(arrays, SIZE)


@pytest.fixture(scope="module")
def dflame(assets):
    return FL.device_flame(assets, "cpu", 50, UV)


@pytest.fixture(scope="module")
def ref(arrays):
    return deca.flame_on(arrays, CPU)


def codes_at(yaws_deg, seed=3):
    """DECA codes from the benchmark's sampler with the yaw set."""
    c = FR.sample_codes(np.random.default_rng(seed), TINY_SIZES,
                        len(yaws_deg))
    c[:, 201] = np.asarray(yaws_deg) * math.pi / 180.0
    return torch.from_numpy(c)


@pytest.fixture(autouse=True)
def _restore_texture_windows():
    real = R.texture_windows
    yield
    R.texture_windows = real


def test_published_sizes():
    cfg = deca_config()
    assert cfg.n_coeff == 236 and cfg.coeff_sizes == (100, 50, 50, 6, 3, 27)
    assert (cfg.n_vertices, cfg.n_faces, cfg.image_size, cfg.uv_size,
            cfg.head_hidden) == (5023, 9976, 224, 256, 1024)
    full = flame_data.head_mesh(81, 62, 3)
    assert full[0].shape == (5023, 3) and full[1].shape == (9976, 3)
    assert full[2].shape[0] > 5023
    codes = split_coeff(torch.zeros(2, 236), cfg)
    assert isinstance(codes, DECACodes) and codes.light.shape == (2, 27)


def test_the_configuration_states_its_stand_ins(arrays):
    """The configuration file's stand_ins are what flame_data makes: the
    full mesh's UV vertices, and the bases' RMS a unit (component k of
    shape and expression at first / sqrt(k) mm, the correctives flat),
    read on the tiny mesh (the RMS does not depend on the mesh)."""
    cfgf = spec.cell("deca-render224.b512")["config_file"]
    st, sizes = cfgf["stand_ins"], cfgf["sizes"]
    verts, faces, uv, _ = flame_data.head_mesh(**cfgf["mesh"])
    assert (len(verts), len(faces)) == (sizes["n_vertices"],
                                        sizes["n_faces"])
    assert len(uv) == st["uv_vertices"] > len(verts)
    assert f"{st['uv_vertices']:,}" in " ".join(cfgf["assumed"])
    rms = np.sqrt((arrays["shapedirs"].astype(np.float64) ** 2).mean(
        axis=(0, 1))) * 1e3
    k = np.arange(1, 101)
    np.testing.assert_allclose(rms[:100], st["shape_rms_mm"] / np.sqrt(k),
                               rtol=1e-5)
    np.testing.assert_allclose(rms[100:], st["exp_rms_mm"] / np.sqrt(k[:50]),
                               rtol=1e-5)
    pose = np.sqrt((arrays["posedirs"].astype(np.float64) ** 2).mean(1)) * 1e3
    np.testing.assert_allclose(pose, st["posedirs_rms_mm"], rtol=1e-5)
    assert abs(float(arrays["albedo_basis"].std())
               / st["albedo_basis_std"] - 1.0) < 0.01


@pytest.mark.parametrize("flame_config", [False, True])
def test_a_pipeline_refuses_the_other_models_assets(assets, flame_config):
    """The config names the face model; a pack of the other model is
    refused when the pipeline is made."""
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.pipeline import make_pipeline
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    if flame_config:
        cfg, pack = tiny_cfg(), synthetic_bfm(tiny_config(), 0)
    else:
        cfg, pack = tiny_config(), assets
    with pytest.raises(ValueError, match="config was given"):
        make_pipeline(cfg, pack, device="cpu", dtype=torch.float32, depth=18)


@pytest.mark.parametrize("yaws,bins", [
    ((0.0, 0.0), None),            # zero pose: Rodrigues' 1e-8
    ((55.0, 41.0), (39, 39)),      # past +39: clamped
    ((-55.0, -45.0), (78, 78)),    # past -39: the last row
    ((-20.0, 25.0), None)])
def test_lbs_and_landmarks_match_the_reference(dflame, ref, yaws, bins):
    cfg = tiny_cfg()
    codes = codes_at(yaws)
    if yaws == (0.0, 0.0):
        codes[:, 200:206] = 0.0
    c = split_coeff(codes, cfg)
    geo = FL.flame_geometry(c, dflame, cfg)
    r = deca.render(codes, ref, SIZE, UV)
    assert torch.equal(geo.contour_bin, r.bins)
    if bins is not None:
        assert tuple(geo.contour_bin.tolist()) == bins
    assert float((geo.verts_world - r.verts).abs().max()) < 1e-6
    assert float((geo.landmarks2d - r.landmarks).abs().max()) < 1e-4
    if yaws == (0.0, 0.0):
        rot = FL.rodrigues(torch.zeros(3, 3))
        assert torch.equal(rot, torch.eye(3).expand(3, 3, 3))
        assert torch.equal(geo.contour_bin, torch.zeros(2, dtype=torch.int64))


def test_albedo_decode_matches_deca(dflame, ref):
    tex = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 50)).astype(np.float32))
    got = FL.decode_albedo(tex, dflame)
    want = deca.albedo(tex, ref, UV).permute(0, 2, 3, 1)
    assert got.shape == (3, UV, UV, 3)
    assert float((got - want).abs().max()) < 1e-6
    assert FL.kept_texels(64, 32)[1, 2] == 2 * 64 + 4


def test_textured_twin_matches_the_reference_shading(dflame, ref):
    """The textured raster's plain version (what the kernel computes) on
    the render path against DECA's per-pixel grid_sample shading."""
    cfg = tiny_cfg()
    codes = codes_at((10.0, -30.0, 48.0))
    out = render_coeffs(split_coeff(codes, cfg), dflame, cfg, inference=True)
    r = deca.render(codes, ref, SIZE, UV)
    t = out.tri_id.to(torch.int64)
    cover = (t >= 0) | (r.tri_id >= 0)
    assert float((t >= 0).float().mean()) > 0.3
    assert int(((t != r.tri_id) & cover).sum()) <= 1
    same = (t == r.tri_id) & (t >= 0)
    assert float((out.image - r.image).abs().amax(-1)[same].max()) < 1e-4
    assert float(out.image[t < 0].abs().max()) == 0.0


def _reconstruct_pipe(cfg, assets, fused, device, dtype=torch.float32,
                      depth=18):
    from facerecon_tpu_torch.pipeline import (fuse_for_inference,
                                              make_train_pipeline)
    pipe = make_train_pipeline(cfg, assets, device=device, dtype=dtype,
                               depth=depth)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        head = pipe.model.head
        head.weight.copy_(torch.randn(head.weight.shape, generator=g) * 1e-3)
        mid = FR.sample_codes(np.random.default_rng(4), TINY_SIZES, 1)[0]
        head.bias.copy_(torch.from_numpy(mid))
        for mod in pipe.model.modules():
            if hasattr(mod, "running_var"):
                n = mod.running_var.numel()
                mod.running_mean.copy_(torch.empty(n).uniform_(
                    -0.1, 0.1, generator=g))
                mod.running_var.copy_(torch.empty(n).uniform_(
                    0.5, 1.5, generator=g))
    return fuse_for_inference(pipe) if fused else pipe


@pytest.mark.parametrize("fused", [False, True])
def test_reconstruct_with_the_deca_head(assets, ref, fused):
    cfg = tiny_cfg()
    pipe = _reconstruct_pipe(cfg, assets, fused, "cpu")
    assert pipe.model.head_hidden.out_features == 1024
    images = torch.from_numpy(np.random.default_rng(6).random(
        (2, SIZE, SIZE, 3)).astype(np.float32))
    codes, c, out = pipe.reconstruct(images)
    assert codes.shape == (2, 236) and isinstance(c, DECACodes)
    # the two-layer float32 head on the backbone's pooled features
    bn = _reconstruct_pipe(cfg, assets, False, "cpu").model.eval()
    feats = []
    hook = bn.head_hidden.register_forward_hook(
        lambda m, a, o: feats.append(a[0]))
    with torch.no_grad():
        bn(images)
    hook.remove()
    with torch.no_grad():
        want = (torch.relu(feats[0] @ bn.head_hidden.weight.T
                           + bn.head_hidden.bias) @ bn.head.weight.T
                + bn.head.bias)
    assert float((codes - want).abs().max()) < 1e-4
    prog = {"codes": codes, "verts": out.geometry.verts_world,
            "landmarks": out.geometry.landmarks2d,
            "bins": out.geometry.contour_bin, "image": out.image,
            "tri_id": out.tri_id}
    limits = spec.cell("deca-render224.b512")["traffic"]["limits"]
    ok, compared = check.verdict(FR.judge(prog, ref, SIZE, UV), limits)
    assert ok, compared


def test_training_render_refuses_flame(dflame):
    cfg = tiny_cfg()
    with pytest.raises(ValueError, match="inference only"):
        render_coeffs(split_coeff(codes_at((0.0,)), cfg), dflame, cfg)


def test_asset_pack_round_trips(tmp_path, assets):
    path = tmp_path / "flame.npz"
    save_npz(str(path), assets)
    back = load_npz(str(path), SIZE)
    assert back.n_vertices == 307 and back.albedo_size == 64
    assert np.array_equal(back.raster_rows, assets.raster_rows)
    live = assets.raster_row_id < assets.n_faces
    assert np.array_equal(assets.raster_rows[live],
                          assets.faces[assets.raster_row_id[live]])


def tiny_cell():
    c = copy.deepcopy(spec.cell("deca-render224.b512"))
    f = c["config_file"]
    f["sizes"].update(uv_size=UV, n_vertices=307, n_faces=588)
    f["flame"].update(albedo_size=64)
    f["mesh"].update(TINY_MESH)
    f["camera"].update(image_size=SIZE)
    f["raster"].update(tile_h=2, raster_cols=2)
    c["traffic"].update(batch=4, microbatch=2, trace_units=1)
    return c


def test_the_cell_runs_correct_on_the_cpu():
    r = run.run_cell(tiny_cell(), SEED, 0.05, False, CPU)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"render_faces_s", "setup_s"}
    assert r["attempted"] >= 4


@pytest.mark.parametrize("fault", sorted(FR.FAULTS))
def test_a_fault_is_not_correct(fault):
    r = run.run_cell(tiny_cell(), SEED, 0.05, False, CPU,
                     fault=FR.FAULTS[fault])
    assert not r["correct"], r["compared"]


def test_the_control_is_not_correct():
    c = tiny_cell()
    numbers = control.control_numbers(c, SEED, CPU)
    assert not check.verdict(numbers, c["traffic"]["limits"])[0], numbers


def test_work_counts_on_the_tiny_cell(ref):
    from perfbench import work_flame
    sizes = dict(TINY_SIZES, uv_size=UV)
    flops = work_flame.flops_per_face(sizes, 307)
    assert flops == 2 * (921 * 150 + 921 * 36 + 5 * 307 * 3 + 307 * 80
                         + 307 * 12 + UV * UV * 3 * 50)
    nbytes, ops = work_flame.texture_work(codes_at((0.0, 30.0)), ref, SIZE,
                                          UV)
    assert ops > 0 and nbytes > 2 * (307 * 24 + SIZE * SIZE * 28)
    uv = torch.tensor([[-1.0, -1.0], [0.0, 0.0], [0.0, 0.0]])
    assert work_flame.distinct_texels(uv, torch.tensor([True, True, False]),
                                      UV) == 1 + 4


# --- on the card ---

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def full_arrays(card):
    cfgf = spec.cell("deca-render224.b512")["config_file"]
    return FR.arrays(cfgf)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h,n_cols", [(4, 7), (2, 8)])
def test_texture_kernel_equals_its_plain_version(card, full_arrays, tile_h,
                                                 n_cols):
    """At the published sizes (5,023 vertices, 224 px, 256^2 albedo):
    tri_id equal, color and bary within 1e-6 (-fmad=false keeps the
    plain version's float32 order; floorf and the bounds are exact)."""
    cfg = deca_config(tile_h=tile_h, raster_cols=n_cols)
    dfl = FL.device_flame(flame_assets(full_arrays), card)
    codes = torch.from_numpy(FR.sample_codes(
        np.random.default_rng(7), TINY_SIZES, 6)).to(card)
    c = split_coeff(codes, cfg)
    geo = FL.flame_geometry(c, dfl, cfg)
    albedo = FL.decode_albedo(c.tex, dfl)
    from facerecon_tpu_torch.ops.render import pack_texture_records
    rec = pack_texture_records(geo.verts_ndc, geo.normals, dfl, 224, 224,
                               R.padded_rows(dfl.raster_rows.shape[0]))
    win = R.band_windows(geo.verts_ndc, dfl.raster_rows, dfl.raster_row_id,
                         224, 224, tile_h, n_cols)
    light = c.light.reshape(-1, 9, 3).contiguous()
    kw = dict(height=224, width=224, tile_h=tile_h, n_cols=n_cols,
              n_faces=dfl.faces.shape[0])
    before = _build.LAUNCHES["raster_texture"]
    got = R.texture_windows(win, rec, albedo, light, dfl.sh_factor, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_texture"] == before + 1
    want = R.texture_windows_reference(win, rec, albedo, light,
                                       dfl.sh_factor, **kw)
    assert torch.equal(got[0], want[0])
    assert float((got[0] >= 0).float().mean()) > 0.3
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_graphed_render_equals_the_eager_one(card, full_arrays):
    """render_coeffs on the card replays FLAME's geometry from a CUDA
    graph and packs the records with the record kernel: two calls with
    other codes give what the eager functions (the records' plain
    version among them) give, bit for bit, and the first call's geometry
    survives the second's replay."""
    cfg = deca_config()
    dfl = FL.device_flame(flame_assets(full_arrays), card)
    outs, codes = [], []
    for seed in (11, 12):
        c = torch.from_numpy(FR.sample_codes(
            np.random.default_rng(seed), TINY_SIZES, 16)).to(card)
        codes.append(c)
        with torch.no_grad():
            outs.append(render_coeffs(split_coeff(c, cfg), dfl, cfg,
                                      inference=True))
    from facerecon_tpu_torch.ops.render import pack_texture_records_reference
    for c, out in zip(codes, outs):
        cc = split_coeff(c, cfg)
        with torch.no_grad():
            geo = FL.flame_geometry(cc, dfl, cfg)
            rec = pack_texture_records_reference(
                geo.verts_ndc, geo.normals, dfl, 224, 224,
                R.padded_rows(dfl.raster_rows.shape[0]))
            tri, color, _ = R.rasterize_textured(
                rec, FL.decode_albedo(cc.tex, dfl),
                cc.light.reshape(-1, 9, 3).contiguous(), dfl.sh_factor,
                geo.verts_ndc, dfl.faces, height=224, width=224, tile_h=4,
                n_cols=7, row_faces=dfl.raster_rows,
                row_id=dfl.raster_row_id)
        for a, b in zip(out.geometry, geo):
            assert torch.equal(a, b)
        assert torch.equal(out.tri_id, tri)
        assert torch.equal(out.image, color * (tri >= 0)[..., None])


@pytest.mark.cuda
def test_record_kernel_equals_its_plain_version_at_the_cell(card,
                                                            full_arrays):
    """The record kernel at the cell's microbatch (256 code sets, 224 px,
    FLAME's 9,976 faces in 19,456 padded rows) with the UV rows as its
    tail: one launch, and bit for bit the plain version run on the card
    (int32 bits over all 24 fields and every padded row); fields 17..22
    are the UV rows, 23 and the rows past F' zero."""
    from facerecon_tpu_torch.ops.render import (
        pack_texture_records, pack_texture_records_reference)
    cfg = deca_config()
    dfl = FL.device_flame(flame_assets(full_arrays), card)
    codes = torch.from_numpy(FR.sample_codes(
        np.random.default_rng(9), TINY_SIZES, 256)).to(card)
    with torch.no_grad():
        geo = FL.flame_geometry(split_coeff(codes, cfg), dfl, cfg)
    pad = R.padded_rows(dfl.raster_rows.shape[0])
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = pack_texture_records(geo.verts_ndc, geo.normals, dfl, 224,
                                   224, pad)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k == "records") for k in _build.KERNELS}
    want = pack_texture_records_reference(geo.verts_ndc, geo.normals, dfl,
                                          224, 224, pad)
    assert got.shape == want.shape == (256, 24, pad)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    f = dfl.raster_rows.shape[0]
    assert torch.equal(got[:, 17:23, :f],
                       dfl.raster_uv.expand(256, 6, f))
    assert not bool(got[:, 23].view(torch.int32).any())
    assert not bool(got[:, :, f:].view(torch.int32).any())


@pytest.mark.cuda
def test_cell_at_batch_8_through_the_record_kernel_is_correct(card):
    """A short run of deca-render224.b512 on the card with its traffic's
    batch and microbatch cut to 8, through the record kernel: correct
    against the plain reference under the cell's own limits."""
    cell = copy.deepcopy(spec.cell("deca-render224.b512"))
    cell["traffic"].update(batch=8, microbatch=8)
    before = _build.LAUNCHES["records"]
    r = run.run_cell(cell, 2 ** 31 + 89, 0.5, False, card)
    assert r["correct"], r["compared"]
    assert _build.LAUNCHES["records"] > before


def _render_on(dfl, cfg, card, n, seed):
    c = torch.from_numpy(FR.sample_codes(np.random.default_rng(seed),
                                         TINY_SIZES, n)).to(card)
    with torch.no_grad():
        render_coeffs(split_coeff(c, cfg), dfl, cfg, inference=True)


def _graph_outputs(dfl):
    return [weakref.ref(t) for _, _, _, out in dfl.graphs.values()
            for t in out]


@pytest.mark.cuda
def test_the_graphs_go_with_their_pack(card, full_arrays):
    """The pack keeps one graph a name (the geometry's; the records are
    one kernel launch and take none): a call at a second batch size frees
    the first size's graph, and dropping the pack frees the rest."""
    cfg = deca_config()
    dfl = FL.device_flame(flame_assets(full_arrays), card)
    _render_on(dfl, cfg, card, 16, 1)
    assert sorted(dfl.graphs) == ["geometry224"]
    first = _graph_outputs(dfl)
    _render_on(dfl, cfg, card, 8, 2)
    torch.cuda.synchronize()
    assert sorted(dfl.graphs) == ["geometry224"]
    assert all(key[1][0][0] == 8 for key, *_ in dfl.graphs.values())
    assert first and all(r() is None for r in first)
    second, pack = _graph_outputs(dfl), weakref.ref(dfl)
    del dfl
    gc.collect()
    assert pack() is None and all(r() is None for r in second)


@pytest.mark.cuda
def test_reconstruct_at_batch_8_on_the_card(card, full_arrays):
    """Pipeline.reconstruct on DECA's config (the bf16 fused ResNet-50 and
    its float32 two-layer head) at batch 8, its render judged against
    the reference at the cell's limits; the textured kernel, the record
    kernel and each binning kernel launch once a call, and no other
    kernel of the port."""
    cfg = deca_config()
    pipe = _reconstruct_pipe(cfg, flame_assets(full_arrays), True, card,
                             torch.bfloat16, 50)
    images = torch.rand((8, 224, 224, 3), generator=torch.Generator(
        ).manual_seed(8)).to(card)
    before = dict(_build.LAUNCHES)
    codes, _, out = pipe.reconstruct(images)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == dict.fromkeys(_build.KERNELS, 0) | {
        "raster_texture": 1, "records": 1, "bin_setup": 1,
        "bin_windows": 1}
    prog = {"codes": codes, "verts": out.geometry.verts_world,
            "landmarks": out.geometry.landmarks2d,
            "bins": out.geometry.contour_bin, "image": out.image,
            "tri_id": out.tri_id}
    limits = spec.cell("deca-render224.b512")["traffic"]["limits"]
    fl = deca.flame_on(full_arrays, card)
    ok, compared = check.verdict(FR.judge(prog, fl, 224, 256), limits)
    assert ok, compared
    assert float(out.mask.mean()) > 0.2
