"""DECA's detail model in the port, held against the plain reference
perfbench/reference/deca_detail.py (float32, nothing of the program) on
the tiny seeded FLAME stand-in of tests/test_torch_deca.py (307
vertices, 588 faces) with 32^2 UV maps (the decoder starting at 1^2) at
64 px, on the CPU: the published sizes, the folded decoder against the
unfolded Generator, the static UV texel table against the reference's
per-call world2uv, the UV detail pass's plain version against the
reference's displacement2normal, SH and texture, render_coeffs and
Pipeline.reconstruct (ResNet-18 E_c and E_d, BatchNorm and fused)
against the reference, the coarse path unchanged, the spans of a detail
render in order, and the benchmark's cell through perfbench.run.run_cell,
judged correct, while each of its four faults and the control (the
decoder's convolutions in bfloat16) are judged not correct.

The tests marked `cuda` hold the UV detail kernel (csrc/uv_detail.cu)
and the detailed image's fetch (raster_texfetch_kernel in
csrc/raster_texture.cu) against their plain versions at the published
sizes; the decoder's kernels (csrc/upconv.cu): each upconv layer at its
published shape, its interpolation exact, and the whole decoder at batch
8 and 256 and at ragged sizes, each no further from the float32 decoder
(TF32 off) than twice the eager cuDNN-TF32 decoder's gap or TF32's own;
count a detail render's launches (test_torch_cuda._launches), run
Pipeline.reconstruct at batch 8 on the card against the reference, the
cell at batch 8, and the cell's bn_eps fault through the kernels; they
skip without a card. The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deca_detail.py
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from facerecon_tpu_torch import profile_trace as PT
from facerecon_tpu_torch.config import deca_config
from facerecon_tpu_torch.models import deca_detail as MD
from facerecon_tpu_torch.ops import _build, detail as DT, flame as FL
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.utils.coeffs import (DECACodes, join_coeff,
                                              split_coeff)
from facerecon_tpu_torch.utils.flame import (flame_assets, load_npz,
                                             save_npz)
from perfbench import (check, control, detail_data, flame_data, run, spec,
                       work_decoder, work_detail)
from perfbench.kinds import flame_detail as FD
from perfbench.reference import deca, deca_detail
from test_torch_cuda import _launches

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2026
TINY_MESH = {"rings": 17, "cols": 18, "mouth_quads": 3}
TINY_SIZES = {"n_shape": 100, "n_exp": 50, "n_tex": 50, "albedo_size": 64,
              "n_detail": 128}
SIZE, UV = 64, 32
LATENT = 181


def tiny_cfg(**kw):
    return deca_config(n_vertices=307, n_faces=588, image_size=SIZE,
                       uv_size=UV, tile_h=2, raster_cols=2, n_detail=128,
                       **kw)


@pytest.fixture(scope="module")
def arrays():
    base = flame_data.flame_arrays(TINY_SIZES, TINY_MESH, 0)
    return dict(base, **detail_data.detail_arrays(base, UV, 0))


@pytest.fixture(scope="module")
def assets(arrays):
    return flame_assets(arrays, SIZE)


@pytest.fixture(scope="module")
def ref(arrays):
    return deca.flame_on(arrays, CPU)


@pytest.fixture(scope="module")
def state():
    calib = torch.from_numpy(FD.sample_codes(np.random.default_rng(1),
                                             TINY_SIZES, 16))
    return detail_data.decoder_state(SEED, LATENT, UV,
                                     FD.decoder_inputs(calib), CPU)


@pytest.fixture(scope="module")
def det(arrays, state):
    return deca_detail.detail_on(state, arrays["fixed_uv_dis"],
                                 arrays["uv_face_eye_mask"], LATENT, CPU)


def generator(state, uv=UV):
    gen = MD.DetailGenerator(LATENT, uv)
    gen.load_state_dict(state)
    return gen.eval()


@pytest.fixture(scope="module")
def dflame(assets, state):
    return FL.device_flame(assets, "cpu", 50, UV, decoder=generator(state))


def codes_at(n, seed=3):
    return torch.from_numpy(FD.sample_codes(np.random.default_rng(seed),
                                            TINY_SIZES, n))


def test_published_sizes():
    cfg = deca_config(n_detail=128)
    assert cfg.n_coeff == 364 and cfg.n_coarse == 236
    assert cfg.coeff_sizes == (100, 50, 50, 6, 3, 27, 128)
    c = split_coeff(torch.zeros(2, 364), cfg)
    assert isinstance(c, DECACodes) and c.detail.shape == (2, 128)
    assert MD.latent_size(cfg.n_exp, cfg.n_detail) == 181
    assert MD.start_size(cfg.uv_size) == 8
    cfgf = spec.cell("deca-detail224.b512")["config_file"]
    assert work_detail.decoder_flops(cfgf) == 2 * 879_140_864
    gen = MD.DetailGenerator()
    assert gen.l1[0].out_features == 128 * 64
    assert [m.eps for m in gen.conv_blocks
            if isinstance(m, torch.nn.BatchNorm2d)] == [1e-5] + [0.8] * 5
    dense = deca_detail.generate_triangles(256, 256)
    assert dense.shape == (122_990, 3) == (cfgf["detail"]["dense_faces"], 3)
    # the port's stencil: a cell of faces for each (y, x) in the margins
    assert int(DT.dense_cells(256).sum()) * 2 == 122_990


def test_coarse_codes_are_unchanged():
    """A coarse config splits and joins its 236 codes as before: the
    detail code is None and join_coeff gives the input back bit for
    bit."""
    cfg = deca_config()
    assert cfg.n_detail == 0 and cfg.n_coeff == cfg.n_coarse == 236
    x = torch.randn(3, 236)
    c = split_coeff(x, cfg)
    assert c.detail is None and len(c) == 7
    assert torch.equal(join_coeff(c), x)
    y = torch.randn(2, 364)
    assert torch.equal(join_coeff(split_coeff(y, tiny_cfg())), y)


@pytest.mark.parametrize("form", ["bn", "folded"])
def test_decoder_matches_the_generator(state, det, form):
    """The port's BatchNorm Generator (DECA's names, eval mode) and its
    folded form against the reference's unfolded Generator; the
    calibration leaves the tanh neither flat nor saturated."""
    z = FD.decoder_inputs(codes_at(6))
    gen = generator(state)
    dec = gen if form == "bn" else MD.FusedDetailGenerator.fold(gen)
    with torch.no_grad():
        got = dec(z)
        want = det.generator(z)
    assert got.shape == (6, 1, UV, UV)
    scale = float(want.abs().max())
    assert 1e-3 < scale < 0.01
    assert float((got - want).abs().max()) < 1e-6 * 0.01 + 1e-7


def test_the_uv_table_is_the_references_world2uv(assets, ref):
    """The static texel table gives the faces the reference's per-call
    z-buffer over the UV layout gives, and world2uv through it the
    reference's within float32 rounding."""
    tab = assets.detail
    face, bary = deca_detail.uv_rasterize(ref, UV)
    assert np.array_equal(tab.texel_face, face.numpy())
    assert float((face >= 0).float().mean()) > 0.5
    assert np.abs(tab.texel_bary - bary.numpy()).max() < 1e-5
    verts = torch.randn(2, 307, 3)
    want = deca_detail.world2uv(verts, ref, UV).permute(0, 2, 3, 1)
    vid = torch.from_numpy(assets.faces)[torch.from_numpy(
        tab.texel_face).long().clamp(min=0)]
    w = torch.from_numpy(tab.texel_bary)
    got = (w[None, ..., None] * verts[:, vid]).sum(2) * torch.from_numpy(
        tab.texel_face >= 0)[None, :, None]
    assert float((got.view(2, UV, UV, 3) - want).abs().max()) < 1e-5


def test_uv_detail_matches_the_reference(dflame, ref, det):
    """The UV detail pass's plain version (what the kernel computes):
    displacement map, detail normals and texture against the reference's
    displacement2normal (index_add_ over generate_triangles), SH and
    albedo."""
    cfg = tiny_cfg()
    codes = codes_at(3)
    c = split_coeff(codes, cfg)
    geo = FL.flame_geometry(c, dflame, cfg)
    with torch.no_grad():
        uv_z = dflame.detail.decoder(MD.decoder_input(c)).view(-1, UV, UV)
    albedo = FL.decode_albedo(c.tex, dflame)
    light = c.light.reshape(-1, 9, 3).contiguous()
    tex, nrm, disp = DT.uv_detail(geo.verts_world, geo.normals, uv_z,
                                  dflame.detail, albedo, light,
                                  dflame.sh_factor)
    want_n = deca_detail.displacement2normal(
        uv_z[:, None], geo.verts_world, deca.vertex_normals(
            geo.verts_world, ref.faces), ref, det)[0].permute(0, 2, 3, 1)
    shading = deca.add_sh_light(want_n.permute(0, 3, 1, 2),
                                light).permute(0, 2, 3, 1)
    assert float((nrm - want_n).abs().max()) < 2e-5
    assert float((tex - albedo * shading).abs().max()) < 1e-4
    assert torch.equal(disp, uv_z + dflame.detail.fixed_uv_dis)
    m = det.uv_face_eye_mask > 0
    unit = torch.linalg.vector_norm(nrm[:, m], dim=-1)
    assert float((unit - 1).abs().max()) < 1e-5 and bool(m.any())


def _prog(out, codes, pack):
    g = out.geometry
    return {"codes": codes, "verts": g.verts_world,
            "landmarks": g.landmarks2d, "bins": g.contour_bin,
            "image": out.image, "tri_id": out.tri_id,
            "disp": out.displacement_map, "normals": out.uv_detail_normals,
            "texel_face": pack.detail.texel_face}


def _limits():
    return spec.cell("deca-detail224.b512")["traffic"]["limits"]


def test_render_coeffs_matches_the_reference(dflame, ref, det):
    cfg = tiny_cfg()
    codes = codes_at(3, seed=5)
    codes[:, 201] = torch.tensor([0.0, 0.8, -0.8])
    out = render_coeffs(split_coeff(codes, cfg), dflame, cfg,
                        inference=True)
    assert out.uv_detail_normals.shape == (3, UV, UV, 3)
    assert out.displacement_map.shape == (3, UV, UV)
    assert float(out.mask.mean()) > 0.2
    assert float(out.image[out.tri_id < 0].abs().max()) == 0.0
    ok, compared = check.verdict(FD.judge(_prog(out, codes, dflame), ref,
                                          det, SIZE), _limits())
    assert ok, compared


def test_a_detail_render_needs_its_decoder_and_refuses_training(assets,
                                                                dflame):
    cfg = tiny_cfg()
    c = split_coeff(codes_at(1), cfg)
    with pytest.raises(ValueError, match="inference only"):
        render_coeffs(c, dflame, cfg)
    bare = FL.device_flame(assets, "cpu", 50, UV)
    with pytest.raises(ValueError, match="detail model"):
        render_coeffs(c, bare, cfg, inference=True)
    from facerecon_tpu_torch.pipeline import make_pipeline
    with pytest.raises(ValueError, match="needs its decoder"):
        make_pipeline(cfg, assets, device="cpu", dtype=torch.float32,
                      depth=18)


def test_the_coarse_path_is_unchanged(arrays, assets, dflame, tmp_path):
    """A coarse config renders bit for bit alike from a pack with the
    detail model and from one without, through the textured kernel's
    path; the coarse npz keeps only FLAME's arrays and the detail npz
    round-trips its tables."""
    cfg = deca_config(n_vertices=307, n_faces=588, image_size=SIZE,
                      uv_size=UV, tile_h=2, raster_cols=2)
    coarse_arrays = {k: v for k, v in arrays.items()
                     if k not in ("fixed_uv_dis", "uv_face_eye_mask")}
    plain = FL.device_flame(flame_assets(coarse_arrays, SIZE), "cpu", 50, UV)
    c = split_coeff(codes_at(2)[:, :236], cfg)
    a = render_coeffs(c, plain, cfg, inference=True)
    b = render_coeffs(c, dflame, cfg, inference=True)
    for x, y in zip(a[:4] + tuple(a.geometry), b[:4] + tuple(b.geometry)):
        assert torch.equal(x, y)
    assert a.uv_detail_normals is None and a.displacement_map is None
    save_npz(str(tmp_path / "coarse.npz"), flame_assets(coarse_arrays, SIZE))
    with np.load(tmp_path / "coarse.npz") as z:
        assert "fixed_uv_dis" not in z.files
    save_npz(str(tmp_path / "detail.npz"), assets)
    back = load_npz(str(tmp_path / "detail.npz"), SIZE).detail
    assert np.array_equal(back.texel_face, assets.detail.texel_face)
    assert np.array_equal(back.uv_face_eye_mask,
                          assets.detail.uv_face_eye_mask)


def test_a_detail_render_gives_its_spans_in_order(dflame):
    cfg = tiny_cfg()
    c = split_coeff(codes_at(1), cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_coeffs(c, dflame, cfg, inference=True)
    ann = sorted((float(e["ts"]), e["name"]) for e in PT.trace_events(prof)
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("fr."))
    assert [n for _, n in ann] == [
        "fr.render", "fr.flame", "fr.albedo", "fr.decoder", "fr.uv_detail",
        "fr.records", "fr.binning"]


def _reconstruct_pipe(cfg, assets, state, fused, device,
                      dtype=torch.float32, depth=18):
    from facerecon_tpu_torch.pipeline import (fuse_for_inference,
                                              make_train_pipeline)
    pipe = make_train_pipeline(cfg, assets, device=device, dtype=dtype,
                               depth=depth,
                               decoder=generator(state, cfg.uv_size))
    g = torch.Generator().manual_seed(11)
    mid = torch.from_numpy(FD.sample_codes(np.random.default_rng(4),
                                           TINY_SIZES, 1)[0])
    with torch.no_grad():
        for model, bias in ((pipe.model, mid[:236]),
                            (pipe.detail_model, mid[236:])):
            head = model.head
            head.weight.copy_(torch.randn(head.weight.shape, generator=g)
                              * 1e-3)
            head.bias.copy_(bias)
            for mod in model.modules():
                if hasattr(mod, "running_var"):
                    n = mod.running_var.numel()
                    mod.running_mean.copy_(torch.empty(n).uniform_(
                        -0.1, 0.1, generator=g))
                    mod.running_var.copy_(torch.empty(n).uniform_(
                        0.5, 1.5, generator=g))
    return fuse_for_inference(pipe) if fused else pipe


@pytest.mark.parametrize("fused", [False, True])
def test_reconstruct_with_both_encoders(assets, ref, det, state, fused):
    """Pipeline.reconstruct regresses E_c's 236 codes and E_d's 128 (two
    ResNet-18s with DECA's two-layer heads) and renders the detailed
    image, judged correct against the reference."""
    cfg = tiny_cfg()
    pipe = _reconstruct_pipe(cfg, assets, state, fused, "cpu")
    assert pipe.detail_model.head.out_features == 128
    assert pipe.model.head.out_features == 236
    images = torch.from_numpy(np.random.default_rng(6).random(
        (2, SIZE, SIZE, 3)).astype(np.float32))
    codes, c, out = pipe.reconstruct(images)
    assert codes.shape == (2, 364) and c.detail.shape == (2, 128)
    bn = _reconstruct_pipe(cfg, assets, state, False, "cpu")
    with torch.no_grad():
        want = torch.cat([bn.model.eval()(images),
                          bn.detail_model.eval()(images)], 1)
    assert float((codes - want).abs().max()) < 1e-4
    ok, compared = check.verdict(FD.judge(_prog(out, codes, pipe.bfm), ref,
                                          det, SIZE), _limits())
    assert ok, compared


def test_work_counts():
    assert work_detail.uv_detail_bytes(2, 10, 4) == 2 * (240 + 16 * 44) \
        + 16 * 24
    assert work_detail.PEAK_TF32 == 494.5e12


def test_decoder_least_time():
    """kdec_roofline_pct's count at DECA's widths and 256 faces: ~1.41 ms,
    the first four layers by FLOPs, the fifth and the last convolution by
    bytes; the linear layer left out."""
    cfgf = spec.cell("deca-detail224.b512")["config_file"]
    layers = work_decoder.layers(cfgf, 256)
    assert abs(work_decoder.least_seconds(cfgf, 256) - 1.4076e-3) < 1e-6
    assert sum(f for f, _ in layers) == 256 * (
        work_detail.decoder_flops(cfgf) - 2 * 181 * 128 * 64
        - 2 * 256 ** 2 * 16 * 9)
    by_flops = [f / work_detail.PEAK_TF32 > b / 3.35e12 for f, b in layers]
    assert by_flops == [True] * 4 + [False] * 2
    assert layers[-1][1] == 4 * (256 * 256 ** 2 * 17 + 9 * 16 + 1)


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, symbol):
        return self.seconds.get(symbol, (0, 0.0))


def test_decoder_roofline_reads_only_its_kernels():
    """The metric reads the least time x the microbatches (outconv's
    launches) over both kernels' device time, and nothing from a trace
    without them (the eager decoder's)."""
    import types
    cfgf = spec.cell("deca-detail224.b512")["config_file"]
    kind = types.SimpleNamespace(cfgf=cfgf,
                                 captured=[torch.zeros(256, 364)] * 2)
    ctx = {"kind": kind, "trace": _Trace({})}
    assert work_decoder.roofline_pct(ctx) is None
    ctx["trace"] = _Trace({"upconv_kernel": (10, 0.008),
                           "outconv_kernel": (2, 0.002)})
    want = 100 * work_decoder.least_seconds(cfgf, 256) * 2 / 0.01
    assert abs(work_decoder.roofline_pct(ctx) - want) < 1e-9
    assert work_decoder.roofline_pct({"kind": kind, "trace": None}) is None


def test_the_decoder_layers_compose_the_plain_decoder(state):
    """The folded decoder's NHWC layers (upconv and outconv take their
    plain versions on the CPU) compose its plain forward; the weights by
    tap round-trip; the interpolation's plain version is F.interpolate's
    within float32 rounding; an unknown width is refused."""
    dec = MD.FusedDetailGenerator.fold(generator(state))
    z = FD.decoder_inputs(codes_at(4))
    with torch.no_grad():
        x = dec.l1(z).view(4, 1, 1, 128)
        for w, b in zip(dec.conv_w, dec.conv_b):
            x = MD.upconv(x, w, b)
        got = MD.outconv(x, dec.out_w, dec.out_b)
        want = dec(z)
    assert got.shape == want.shape == (4, 1, UV, UV)
    assert float((got - want).abs().max()) < 1e-6 * 0.01 + 1e-7
    w = torch.randn(64, 32, 3, 3)
    assert torch.equal(MD.oihw(MD.by_tap(w)), w)
    assert torch.equal(MD.by_tap(w)[1 * 3 + 2], w[:, :, 1, 2])
    x = torch.randn(2, 5, 5, 8)
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    assert float((MD.upsample_reference(x) - up.permute(0, 2, 3, 1))
                 .abs().max()) < 1e-6
    with pytest.raises(ValueError, match="no tiling"):
        MD.upconv(x, torch.zeros(9, 8, 8), torch.zeros(8))


def test_the_configuration_states_its_stand_ins(arrays):
    cfgf = spec.cell("deca-detail224.b512")["config_file"]
    st = cfgf["stand_ins"]
    rms = float(np.sqrt((arrays["fixed_uv_dis"].astype(np.float64) ** 2)
                        .mean())) * 1e3
    assert abs(rms - st["fixed_uv_dis_rms_mm"]) < 1e-4
    assert st["decoder_tanh_input_std"] == detail_data.TANH_STD
    m = arrays["uv_face_eye_mask"]
    assert set(np.unique(m)) == {0.0, 1.0} and 0.02 < m.mean() < 0.5
    assert cfgf["detail"]["dense_margins"] == [2, 5]
    assert cfgf["sizes"]["n_detail"] == 128 and cfgf["reduced"] == []


def tiny_cell():
    c = copy.deepcopy(spec.cell("deca-detail224.b512"))
    f = c["config_file"]
    f["sizes"].update(uv_size=UV, n_vertices=307, n_faces=588)
    f["flame"].update(albedo_size=64)
    f["mesh"].update(TINY_MESH)
    f["camera"].update(image_size=SIZE)
    f["raster"].update(tile_h=2, raster_cols=2)
    f["decoder"].update(start_size=1)
    c["traffic"].update(batch=4, microbatch=2, trace_units=1)
    return c


def test_the_cell_runs_correct_on_the_cpu():
    r = run.run_cell(tiny_cell(), SEED, 0.05, False, CPU)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"render_faces_s", "setup_s"}
    assert set(r["compared"]) >= {"disp_gap", "normal_gap", "image_gap"}


@pytest.mark.parametrize("fault", sorted(FD.FAULTS))
def test_a_fault_is_not_correct(fault):
    r = run.run_cell(tiny_cell(), SEED, 0.05, False, CPU,
                     fault=FD.FAULTS[fault])
    assert not r["correct"], r["compared"]


def test_the_control_is_not_correct():
    c = tiny_cell()
    numbers = control.control_numbers(c, SEED, CPU)
    assert not check.verdict(numbers, c["traffic"]["limits"])[0], numbers


# --- on the card ---

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def full(card):
    """The cell's arrays, the reference's FLAME and detail model, and
    the program's pack, at the published sizes."""
    cfgf = spec.cell("deca-detail224.b512")["config_file"]
    arr = FD.arrays(cfgf)
    calib = torch.from_numpy(FD.sample_codes(np.random.default_rng(1),
                                             cfgf["sizes"], 32)).to(card)
    st = detail_data.decoder_state(SEED, LATENT, 256,
                                   FD.decoder_inputs(calib), card)
    pack = FL.device_flame(flame_assets(arr), card, 50, 256,
                           decoder=generator(st, 256).to(card))
    return (arr, st, pack, deca.flame_on(arr, card),
            deca_detail.detail_on(st, arr["fixed_uv_dis"],
                                  arr["uv_face_eye_mask"], LATENT, card))


def _launched(before):
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()}


@pytest.mark.cuda
def test_uv_detail_kernel_equals_its_plain_version(card, full):
    """At the published sizes (5,023 vertices, 256^2 maps, 6 faces): one
    launch; the displacement map bit for bit, the normals and the
    texture within 1e-6 (-fmad=false keeps the plain version's order;
    sqrt and division round alike, the sums may not)."""
    _, _, pack, _, _ = full
    cfg = deca_config(n_detail=128)
    c = split_coeff(torch.from_numpy(FD.sample_codes(
        np.random.default_rng(7), TINY_SIZES, 6)).to(card), cfg)
    with torch.no_grad():
        geo = FL.flame_geometry(c, pack, cfg)
        uv_z = pack.detail.decoder(MD.decoder_input(c)).view(-1, 256, 256)
    albedo = FL.decode_albedo(c.tex, pack)
    light = c.light.reshape(-1, 9, 3).contiguous()
    args = (geo.verts_world, geo.normals, uv_z, pack.detail, albedo, light,
            pack.sh_factor)
    before = dict(_build.LAUNCHES)
    got = DT.uv_detail(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {k: int(k == "uv_detail")
                                 for k in _build.KERNELS}
    want = DT.uv_detail_reference(*args)
    assert torch.equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 1e-6
    assert float(got[1].abs().amax(-1).gt(0.5).float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h,n_cols", [(4, 7), (2, 8)])
def test_texfetch_kernel_equals_its_plain_version(card, full, tile_h,
                                                  n_cols):
    """At 224 px over FLAME's 9,976 faces with a 256^2 texture: one
    launch, tri_id equal, color and bary within 1e-6."""
    _, _, pack, _, _ = full
    cfg = deca_config(n_detail=128, tile_h=tile_h, raster_cols=n_cols)
    c = split_coeff(torch.from_numpy(FD.sample_codes(
        np.random.default_rng(8), TINY_SIZES, 6)).to(card), cfg)
    geo = FL.flame_geometry(c, pack, cfg)
    from facerecon_tpu_torch.ops.render import pack_texture_records
    rec = pack_texture_records(geo.verts_ndc, geo.normals, pack, 224, 224,
                               R.padded_rows(pack.raster_rows.shape[0]))
    win = R.band_windows(geo.verts_ndc, pack.raster_rows, pack.raster_row_id,
                         224, 224, tile_h, n_cols)
    texture = torch.rand((6, 256, 256, 3), device=card,
                         generator=torch.Generator(card).manual_seed(3))
    kw = dict(height=224, width=224, tile_h=tile_h, n_cols=n_cols,
              n_faces=pack.faces.shape[0])
    before = dict(_build.LAUNCHES)
    got = R.texfetch_windows(win, rec, texture, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {k: int(k == "raster_texfetch")
                                 for k in _build.KERNELS}
    want = R.texfetch_windows_reference(win, rec, texture, **kw)
    assert torch.equal(got[0], want[0])
    assert float((got[0] >= 0).float().mean()) > 0.3
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_reconstruct_at_batch_8_on_the_card(card, full):
    """Pipeline.reconstruct on the detail config (bf16 fused ResNet-50s
    for E_c and E_d, the TF32 decoder) at batch 8, judged against the
    reference at the cell's limits; the UV detail kernel, the fetch, the
    record kernel and each binning kernel launch once a call, the
    decoder's kernels 5 + 1 times, nothing else of the port, and TF32 is
    off again after the decoder."""
    arr, st, _, fl, det = full
    cfg = deca_config(n_detail=128)
    pipe = _reconstruct_pipe(cfg, flame_assets(arr), st, True, card,
                             torch.bfloat16, 50)
    images = torch.rand((8, 224, 224, 3), generator=torch.Generator(
        ).manual_seed(8)).to(card)
    before = dict(_build.LAUNCHES)
    codes, _, out = pipe.reconstruct(images)
    torch.cuda.synchronize()
    assert _launched(before) == _launches(uv_detail=1, raster_texfetch=1)
    assert not torch.backends.cudnn.allow_tf32
    ok, compared = check.verdict(FD.judge(_prog(out, codes, pipe.bfm), fl,
                                          det, 224), _limits())
    assert ok, compared
    assert float(out.mask.mean()) > 0.2


@pytest.mark.cuda
def test_cell_at_batch_8_is_correct(card):
    cell = copy.deepcopy(spec.cell("deca-detail224.b512"))
    cell["traffic"].update(batch=8, microbatch=8)
    before = dict(_build.LAUNCHES)
    r = run.run_cell(cell, 2 ** 31 + 91, 0.5, False, card)
    assert r["correct"], r["compared"]
    launched = _launched(before)
    assert launched["uv_detail"] == launched["raster_texfetch"] > 0
    assert launched["raster_texture"] == 0
    assert launched == _launches(uv_detail=launched["uv_detail"],
                                 raster_texfetch=launched["uv_detail"])


@pytest.mark.cuda
def test_a_detail_render_launches(card, full):
    """render_coeffs on the detail pack at 256 faces: the FLAME path's
    record kernel and binning, the decoder's 5 upconv and 1 outconv, the
    UV detail kernel and the fetch, each as test_torch_cuda._launches
    says, and nothing else of the port."""
    _, _, pack, _, _ = full
    cfg = deca_config(n_detail=128)
    c = split_coeff(torch.from_numpy(FD.sample_codes(
        np.random.default_rng(9), TINY_SIZES, 256)).to(card), cfg)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        out = render_coeffs(c, pack, cfg, inference=True)
    torch.cuda.synchronize()
    assert _launched(before) == _launches(uv_detail=1, raster_texfetch=1)
    assert out.displacement_map.shape == (256, 256, 256)


@pytest.mark.cuda
def test_the_bn_eps_fault_goes_through_the_kernels(card):
    """The cell's bn_eps fault (the decoder folded with the wrong eps)
    still decodes through upconv and outconv, and the cell is not
    correct."""
    cell = copy.deepcopy(spec.cell("deca-detail224.b512"))
    cell["traffic"].update(batch=8, microbatch=8)
    before = dict(_build.LAUNCHES)
    r = run.run_cell(cell, 2 ** 31 + 92, 0.5, False, card,
                     fault=FD.FAULTS["bn_eps"])
    assert not r["correct"], r["compared"]
    launched = _launched(before)
    assert launched["outconv"] == launched["uv_detail"] > 0
    assert launched["upconv"] == 5 * launched["outconv"]


# the decoder's kernels: inputs, the float32 and TF32 yardsticks

LAYERS = [(128, 128, 8), (128, 64, 16), (64, 64, 32), (64, 32, 64),
          (32, 16, 128)]


def _tf32(t):
    """t rounded to TF32 as the kernel's cvt.rna does: to nearest, ties
    away from zero, 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _layer_inputs(card, cin, cout, s, batch, seed):
    g = torch.Generator(card).manual_seed(seed)
    x = torch.randn((batch, s, s, cin), device=card, generator=g)
    w = torch.randn((9, cout, cin), device=card, generator=g) / (
        9 * cin) ** 0.5
    b = torch.randn((cout,), device=card, generator=g) * 0.1
    return x, w, b


def _eager_layer(x, w, b, tf32, upsampled=False):
    """The layer by eager ops, NCHW, cuDNN's TF32 on or off; x NHWC (the
    upsampled image if `upsampled`)."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        u = x.permute(0, 3, 1, 2).contiguous()
        if not upsampled:
            u = F.interpolate(u, scale_factor=2, mode="bilinear",
                              align_corners=False)
        y = F.leaky_relu(F.conv2d(u, MD.oihw(w), b, padding=1), MD.SLOPE)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    return y.permute(0, 2, 3, 1)


def _emulated_decoder(dec, z):
    """The decoder with the kernels' roundings and TF32 off: each layer's
    upsampled input and weights rounded to TF32, products and sums in
    float32; the last convolution in float32."""
    s = dec.init_size
    torch.backends.cudnn.allow_tf32 = False
    x = dec.l1(z).view(z.shape[0], s, s, MD.CHANNELS[0])
    for w, b in zip(dec.conv_w, dec.conv_b):
        x = _eager_layer(_tf32(MD.upsample_reference(x)), _tf32(w), b,
                         False, upsampled=True)
    x = F.conv2d(x.permute(0, 3, 1, 2), MD.oihw(dec.out_w[:, None]),
                 dec.out_b, padding=1)
    return torch.tanh(x) * MD.OUT_SCALE


def _gap(a, b):
    return float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,s", LAYERS)
def test_upconv_layer_within_tf32(card, cin, cout, s):
    """Each layer at its published shape (batch 8): one launch; within
    1e-5 x max |y| of the same layer on TF32-rounded operands in float32
    (what the kernel computes, in another order), and no further from the
    float32 layer than twice the eager cuDNN-TF32 layer's gap."""
    x, w, b = _layer_inputs(card, cin, cout, s, 8, cin * 7 + cout)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = MD.upconv(x, w, b)
        torch.cuda.synchronize()
        assert _launched(before) == {k: int(k == "upconv")
                                     for k in _build.KERNELS}
        f32 = _eager_layer(x, w, b, False)
        tf = _eager_layer(x, w, b, True)
        emu = _eager_layer(_tf32(MD.upsample_reference(x)), _tf32(w), b,
                           False, upsampled=True)
    assert got.shape == (8, 2 * s, 2 * s, cout)
    scale = float(f32.abs().max())
    assert _gap(got, emu) <= 1e-5 * scale, (_gap(got, emu), scale)
    assert _gap(got, f32) <= 2 * _gap(tf, f32), (_gap(got, f32),
                                                _gap(tf, f32))
    assert float((got < 0).float().mean()) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,s", LAYERS + [(128, 128, 3),
                                                 (32, 16, 5), (64, 32, 1)])
def test_upconv_interpolation_is_exact(card, cin, cout, s):
    """With one weight of 1 at the centre tap (output channel o reads
    input channel o x cin // cout) and no bias, the kernel gives the
    plain interpolation rounded to TF32, then LeakyReLU, bit for bit: the
    source indices, the clamp at the last row and column and the order
    of the sums are PyTorch's; also at sizes that are no tile multiple."""
    x, _, _ = _layer_inputs(card, cin, cout, s, 2, s)
    pick = torch.arange(cout, device=card) * cin // cout
    w = torch.zeros((9, cout, cin), device=card)
    w[4, torch.arange(cout, device=card), pick] = 1.0
    b = torch.zeros(cout, device=card)
    got = MD.upconv(x, w, b)
    u = _tf32(MD.upsample_reference(x))[..., pick]
    assert torch.equal(got, torch.where(u > 0, u, u * MD.SLOPE))


def _decoder_gaps(dec, z, float32):
    """(kernel's gap, eager cuDNN-TF32 decoder's gap, emulated TF32
    decoder's gap), each to `float32`, the unfolded float32 decoder run
    with TF32 off, and the launches of the kernel's call."""
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = dec(z)
        torch.cuda.synchronize()
        launched = _launched(before)
        tf = dec.forward_reference(z)
        torch.backends.cudnn.allow_tf32 = False
        f32 = torch.cat([float32(part) for part in z.split(64)])
        emu = torch.cat([_emulated_decoder(dec, part)
                         for part in z.split(64)])
    assert got.shape == f32.shape == (z.shape[0], 1) + got.shape[2:]
    assert not torch.backends.cudnn.allow_tf32
    return _gap(got, f32), _gap(tf, f32), _gap(emu, f32), launched


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 256])
def test_decoder_kernels_within_tf32(card, full, batch):
    """The pack's folded decoder at the published sizes: the linear
    layer, 5 upconv and 1 outconv launches and nothing else of the port;
    its largest gap to the reference's float32 decoder at most twice the
    eager cuDNN-TF32 decoder's."""
    _, _, pack, _, det = full
    z = FD.decoder_inputs(codes_at(batch, seed=10).to(card))
    got, tf, emu, launched = _decoder_gaps(pack.detail.decoder, z,
                                           det.generator)
    assert launched == dict.fromkeys(_build.KERNELS, 0) | {"upconv": 5,
                                                           "outconv": 1}
    assert 0 < got <= 2 * tf, (got, tf, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("uv,batch", [(64, 1), (96, 3)])
def test_decoder_kernels_at_ragged_sizes(card, uv, batch):
    """Start sizes 2 and 3 (maps of 64^2 and 96^2: layers of 4 to 32 and
    6 to 96 pixels a side, no tile multiple) at batch 1 and 3: within
    twice the larger of the eager cuDNN-TF32 decoder's gap and the
    emulated TF32 decoder's (cuDNN may keep small shapes in float32)."""
    calib = FD.decoder_inputs(codes_at(16, seed=uv).to(card))
    gen = generator(detail_data.decoder_state(SEED, LATENT, uv, calib,
                                              card), uv).to(card)
    dec = MD.FusedDetailGenerator.fold(gen)
    z = FD.decoder_inputs(codes_at(batch, seed=uv + 1).to(card))
    got, tf, emu, launched = _decoder_gaps(dec, z, gen)
    assert launched["upconv"] == 5 and launched["outconv"] == 1
    assert 0 < got <= 2 * max(tf, emu), (got, tf, emu)
