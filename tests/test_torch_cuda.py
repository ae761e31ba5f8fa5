"""The port's CUDA path on the card, held against its own plain version.

Every test here is marked `cuda` and skips on a host without a CUDA
device. The file imports nothing of JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: tri_id exactly equal to the plain version; for K4 depth and
winner row exactly equal too, and K6 bit for bit (both keep the plain
version's float32 order); for K1 color and bary
within 1e-6 (the kernel keeps the plain version's float32 operation
order and is built with -fmad=false); for K2 the winner row and the
selected fields exactly equal (a copy of record values); for K3 within
1e-5 x max |ref| (the plain version's index_add_ sums with atomics in
another order on the card) and bitwise equal over two launches. The
float32 pipeline and training step on the card agree with the same ones
on the CPU to the CPU test suite's bars, and the contract path on the
card meets the CPU suite's bars against the oracle. A train step inside
a world-size-1 NCCL group equals the step with no group bit for bit,
and the joint track solve's first K2 and K3 calls equal their plain
versions. The benchmark's three modes (bench.py) at small sizes launch
exactly their kernels (headline and render512: K1 once a microbatch of
each pass; train: K2 and K3 once a step), with finite outputs, and
graft_entry.entry() launches K2 once, its call equal to the plain
version. The trace endpoint (profile_trace) at a small batch launches
K2 once a call, and its trace holds one K2 device event a traced call.
The render-chain benchmark's bwd call at 512 px (render_bench: tile_h 1
x 7 columns of 80 px) launches K2 and K3 once each, both held against
their plain versions; K4 at raster_bench's shape with --cull (tile_h 8 x
one 224-px column, the asset's face order) equals its plain version;
the twins' mains launch exactly (1 + 3 reps) x inner K2 (and K3 with
--bwd), and 1 + 3 reps K4 plus one for --check. K1, K2 and K4 equal
their plain versions on bands of 1 to 136 rows in both face orders, on
saturated chunk masks, at 512 px with 1-row bands (and K2's
RP_ABLATE=cull build there, bit for bit), and on a shuffled order with
an image turned to show its back faces, with and without
cull_backfaces. The probes' twins
(facerecon_tpu_torch/benchmarks/): the s2d stem and the native 7x7/s2
stem agree on the card (f32 within 1e-5 x max |ref|, bf16 within 2^-6 x
max |ref|: each output rounded twice to bf16), the two pool forms differ
as on the CPU, and the scatter-min on the card equals the CPU's; none
of them launches a port kernel. The binning kernels (csrc/binning.cu,
through band_windows) give the plain version's Windows bit for bit (the
setup compared as int32 bits over every field and padded row) at every
path's shape: 224 px with tile_h 4 x 7 columns at batch 128 and 1, 512
px with tile_h 2 x 8 at batch 32, both on the raster row order and a
shuffled one, and K4's identity order (tile_h 8 x one 224-px column)
with and without cull_backfaces; also on dead, grid-snapped and
off-screen faces; a call launches each once, and every path launches
them once for each K1, K2 and K4 launch (_launches). The geometry kernel
(csrc/geometry.cu, through ops/geometry.vertex_pass) at the inference
microbatch (224 px, batch 128) and render512's (512 px, batch 32) on the
full mesh: one launch a call; shape and texture bit for bit its plain
version's on the card, the posed fields within 1e-6 (the rotation's
3x3 products sum the same terms in another order), the landmarks within
1e-6 relative; coeffs_to_geometry launches it once under no_grad and
never where the coefficients require grad; and a short run of the
benchmark's infer224.b256 and render512.b256 cells at batch 8 through it
is correct under the cells' own limits. Every path whose forward runs
under no_grad launches it once for each geometry it computes. The record
kernel (csrc/records.cu, through ops/render.pack_render_records) gives
the plain version's record bit for bit (int32 bits over all 24 fields
and every padded row) at 224 px at batch 128 and 1 and at 512 px at
batch 32 on the full mesh, on _kernel_inputs' cases, and on dead,
grid-snapped and off-screen rows; one launch a call, none where autograd
records, one for each K1 launch of a path; its wrapper refuses what it
does not take; and the two cells' runs at batch 8 go through it. The
contract path at 224 px on the full mesh meets tests/test_tpu_parity.py's
bar against the native oracle in both row orders; evaluate on the card
meets the contract; the infer and track drivers launch exactly their
kernels; gather_probe's forms equal the CPU's; dryrun_multichip(1) runs
over NCCL; a checkpoint written from the card restores bit for bit into
a trainer on the CPU and on the card. GaussianAvatars' four kernels
(csrc/gaussians.cu through ops/gavatar) at the cell's sizes (100,000
Gaussians, 802 x 550) on the cell's frames, on frames with Gaussians
behind the near plane, off screen and none in view: the emit, the tile
ranges and the blend bit for bit their plain versions, the preprocess
within 2 ulp of them (its exp, sqrt and division are the card's on
both sides; the kernel keeps the plain version's order); the avatar's
render launches each of the four once and no other kernel of the port;
the wrappers refuse what the kernels do not take; and the cell at batch
8 is correct under its own limits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from facerecon_tpu_torch import oracle
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.models.deca_detail import N_UP
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
from facerecon_tpu_torch.ops.render import pack_render_records
from facerecon_tpu_torch.ops.sh import illuminate
from facerecon_tpu_torch.pipeline import make_pipeline, make_train_pipeline
from facerecon_tpu_torch.train import init_state, make_train_step
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(**counts):
    """A path's launch counts: the named kernels' counts, 0 for the rest,
    one launch of each binning kernel for each K1, K2, K4, textured and
    fetch launch (each rasterizes windows that band_windows binned for
    it), and one of the record kernel for each K1, textured and fetch
    launch (the paths here run those under no_grad; K2's records are the
    eager ops). The UV detail kernel bins nothing; each of its launches (a
    detail render or reconstruct) follows one decode of the displacement
    map: five upconv launches and one outconv launch."""
    want = dict.fromkeys(_build.KERNELS, 0) | counts
    textured = want["raster_texture"] + want["raster_texfetch"]
    n = (want["raster_shade"] + want["raster_select"] + want["raster_pos"]
         + textured)
    return want | {"bin_setup": n, "bin_windows": n,
                   "records": want["raster_shade"] + textured,
                   "upconv": N_UP * want["uv_detail"],
                   "outconv": want["uv_detail"]}


def _kernel_inputs(card, order, batch=3, tile_h=None, n_cols=None,
                   tz=None, away=False, turned=False, cull=False,
                   size=None):
    """Records and windows at tiny_config(n_vertices=6000): 11.7k faces,
    so a shuffled order overflows the 64-chunk column masks. tile_h and
    n_cols override the config's bands, size its image (focal scaled
    with it); tz sets every face's depth
    translation (9.0: 1 from the camera, rows of several hundred px);
    away moves the last image's face out of frame; turned turns it 2.5
    rad about the vertical axis (mostly back faces show); cull bins with
    cull_backfaces."""
    cfg, assets, geom, rad, rows, rid = _kernel_geometry(
        card, order, batch, tile_h, n_cols, tz, away, turned, size)
    s = cfg.image_size
    rec = pack_render_records(geom.verts_ndc, rad, rows, s, s,
                              R.padded_rows(rows.shape[0]))
    win = R.band_windows(geom.verts_ndc, rows, rid, s, s, cfg.tile_h,
                         cfg.raster_cols, cull)
    if order == "shuffled":
        assert int(win.bn.max()) > 64
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    return cfg, win, rec, kw


def _kernel_geometry(card, order, batch=3, tile_h=None, n_cols=None,
                     tz=None, away=False, turned=False, size=None):
    """_kernel_inputs' geometry before its records and windows: (cfg,
    assets, geometry, radiance, raster rows, row ids)."""
    cfg = tiny_config(n_vertices=6000)
    cfg = dataclasses.replace(cfg, tile_h=tile_h or cfg.tile_h,
                              raster_cols=n_cols or cfg.raster_cols)
    if size is not None:
        cfg = dataclasses.replace(cfg, image_size=size,
                                  focal=cfg.focal * size / cfg.image_size)
    assets = synthetic_bfm(cfg, 0)
    bfm = device_bfm(assets, card)
    coeff = sample_coeffs(np.random.default_rng(5), cfg, batch)
    if tz is not None:
        coeff[:, -1] = tz
    if away:
        coeff[-1, -3] = 100.0
    if turned:
        coeff[-1, cfg.coeff_split[2] + 1] = 2.5
    c = split_coeff(torch.as_tensor(coeff, device=card), cfg)
    geom = coeffs_to_geometry(c, bfm, cfg)
    rad = illuminate(geom.texture, geom.normals, c.gamma)
    if order == "raster_rows":
        rows, rid = bfm.raster_rows, bfm.raster_row_id
    else:
        rid = torch.as_tensor(np.random.default_rng(3).permutation(
            assets.n_faces), device=card)
        rows = bfm.faces[rid]
    return cfg, assets, geom, rad, rows, rid


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
def test_kernel_matches_plain_version(card, order):
    _, win, rec, kw = _kernel_inputs(card, order)
    before = _build.LAUNCHES["raster_shade"]
    got = R.shade_windows(win, rec, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_shade"] == before + 1
    ref = R.shade_windows_reference(win, rec, **kw)
    assert float((ref[0] >= 0).float().mean()) > 0.1
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert float((a - b).abs().max()) <= 1e-6


def _hold_shade(win, rec, kw):
    """K1 against its plain version: tri_id exactly equal, color and bary
    within 1e-6."""
    got = R.shade_windows(win, rec, **kw)
    ref = R.shade_windows_reference(win, rec, **kw)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert float((a - b).abs().max()) <= 1e-6
    return ref


def _hold_raster(win, rec, kw):
    """K1, K2 and K4 on these windows against their plain versions (K2's
    and K4's outputs exactly equal)."""
    ref = _hold_shade(win, rec, kw)
    for got, ref_k in ((R.select_windows(win, rec, **kw),
                      R.select_windows_reference(win, rec, **kw)),
                     (R.pos_windows(win, **kw),
                      R.pos_windows_reference(win, **kw))):
        for a, b in zip(got, ref_k):
            assert torch.equal(a, b)
    return ref


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg = tiny_config()
    s = cfg.image_size
    vndc = torch.zeros((1, 4, 3), device=card)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], device=card)
    rid = torch.arange(2, device=card)
    win = R.band_windows(vndc, faces, rid, s, s, cfg.tile_h,
                         cfg.raster_cols)
    rec = torch.zeros((1, 24, win.setup.shape[2]), device=card)
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=2)
    with pytest.raises(ValueError):
        R.shade_windows(win, rec.cpu(), **kw)
    with pytest.raises(ValueError):
        R.shade_windows(win, rec.to(torch.bfloat16), **kw)
    # bands of any size launch as they are, one block of 128 threads a
    # (column, band, image) for K1, K2 and K4 alike: a 64 x 64 px band
    # (32 pixel groups of 64 x 2 px) and a band taller than the image
    # (tile_h 136), each equal to its plain version
    _, tall, trec, tkw = _kernel_inputs(card, "raster_rows", batch=2,
                                        tile_h=64, n_cols=1)
    ref = _hold_raster(tall, trec, tkw)
    assert float((ref[0] >= 0).float().mean()) > 0.1
    _, taller, trec, tkw = _kernel_inputs(card, "raster_rows", batch=1,
                                          tile_h=136, n_cols=1)
    _hold_raster(taller, trec, tkw)


def test_kernels_cull_backfaces_as_their_plain_versions(card):
    """K1, K2 and K4 on windows binned with cull_backfaces (the shade and
    select paths' flag), with an image turned to show mostly back faces:
    each equal to its plain version, and the cull changes tri_id."""
    _, win, rec, kw = _kernel_inputs(card, "raster_rows", turned=True,
                                     cull=True)
    ref = _hold_raster(win, rec, kw)
    assert float((ref[0][0] >= 0).float().mean()) > 0.1
    _, unculled, _, _ = _kernel_inputs(card, "raster_rows", turned=True)
    assert not torch.equal(R.pos_windows(unculled, **kw)[0], ref[0])


def test_reconstruct_on_card_matches_cpu(card):
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    images = torch.rand((2, cfg.image_size, cfg.image_size, 3),
                        generator=torch.Generator().manual_seed(0))
    outs = []
    for dev in (card, "cpu"):
        pipe = make_pipeline(cfg, assets, device=dev, dtype=torch.float32)
        cv, _, out = pipe.reconstruct(images)
        outs.append((cv.cpu(), out.tri_id.cpu(), out.image.cpu(),
                     out.geometry.verts_world.cpu()))
    (cg, tg, ig, vg), (cc, tc, ic, vc) = outs
    assert float((cg - cc).abs().max()) < 1e-4 * float(cc.abs().max())
    assert float((vg - vc).abs().mean()) < 1e-5
    same = tg == tc
    assert float(same.float().mean()) >= 0.999
    assert float((tc >= 0).float().mean()) > 0.1
    assert float((ig - ic).abs()[same].max()) < 1e-3


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
def test_select_kernel_matches_plain_version(card, order):
    _, win, rec, kw = _kernel_inputs(card, order)
    before = _build.LAUNCHES["raster_select"]
    got = R.select_windows(win, rec, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_select"] == before + 1
    ref = R.select_windows_reference(win, rec, **kw)
    assert float((ref[0] >= 0).float().mean()) > 0.1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_select_grad_kernel_matches_plain_and_is_deterministic(card):
    cfg, win, rec, kw = _kernel_inputs(card, "raster_rows")
    _, row, _ = R.select_windows(win, rec, **kw)
    g = torch.randn((row.shape[0], 20, *row.shape[1:]), device=card,
                    generator=torch.Generator(card).manual_seed(0))
    gkw = dict(rows=rec.shape[2], tile_h=cfg.tile_h)
    before = _build.LAUNCHES["select_grad"]
    got = R.select_grad(row, g, win.blo, win.bn, **gkw)
    again = R.select_grad(row, g, win.blo, win.bn, **gkw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["select_grad"] == before + 2
    assert torch.equal(got, again)
    ref = R.select_grad_reference(row, g, win.blo, win.bn, **gkw)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert not got[:, 17:].any()


@pytest.mark.parametrize("case", ["ragged", "near", "empty", "shuffled"])
def test_select_grad_kernel_on_general_shapes(card, case):
    """K3 where its counting sort meets the general cases: tile_h 3 (the
    height 64 is no multiple of it), a face 1 from the camera (a winner
    row spans several bands and has more than 128 pixels, the sum pass's
    long-row path), an image nothing covers, a shuffled face order. Each
    within 1e-5 x max |ref| of the plain version and bitwise equal over
    two launches."""
    kwargs = dict(ragged=dict(tile_h=3), near=dict(tz=9.0),
                  empty=dict(away=True), shuffled={})[case]
    order = "shuffled" if case == "shuffled" else "raster_rows"
    cfg, win, rec, kw = _kernel_inputs(card, order, **kwargs)
    _, row, _ = R.select_windows(win, rec, **kw)
    cover = (row >= 0).float().mean(dim=(1, 2))
    if case == "empty":
        assert float(cover[0]) > 0.1 and float(cover[-1]) == 0.0
    if case == "near":
        r = row[0][row[0] >= 0].to(torch.int64)
        top = int(torch.bincount(r).argmax())
        ys = torch.nonzero(row[0] == top)[:, 0]
        assert int((row[0] == top).sum()) > 128
        assert int(ys.max()) // cfg.tile_h > int(ys.min()) // cfg.tile_h
    g = torch.randn((row.shape[0], 20, *row.shape[1:]), device=card,
                    generator=torch.Generator(card).manual_seed(1))
    gkw = dict(rows=rec.shape[2], tile_h=cfg.tile_h)
    got = R.select_grad(row, g, win.blo, win.bn, **gkw)
    again = R.select_grad(row, g, win.blo, win.bn, **gkw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = R.select_grad_reference(row, g, win.blo, win.bn, **gkw)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert not got[:, 17:].any()


def test_select_wrappers_reject_what_the_kernels_do_not_take(card):
    cfg, win, rec, kw = _kernel_inputs(card, "raster_rows", batch=1)
    for bad in (rec.cpu(), rec.to(torch.bfloat16),
                rec.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            R.select_windows(win, bad, **kw)
    _, row, sel = R.select_windows(win, rec, **kw)
    g = torch.zeros_like(sel)
    gkw = dict(rows=rec.shape[2], tile_h=cfg.tile_h)
    for bad in (g.cpu(), g.to(torch.bfloat16), g.transpose(2, 3)):
        with pytest.raises(ValueError):
            R.select_grad(row, bad, win.blo, win.bn, **gkw)
    with pytest.raises(ValueError):
        R.select_grad(row.cpu(), g, win.blo, win.bn, **gkw)


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
def test_pos_kernel_matches_plain_version(card, order):
    _, win, _, kw = _kernel_inputs(card, order)
    before = _build.LAUNCHES["raster_pos"]
    got = R.pos_windows(win, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_pos"] == before + 1
    ref = R.pos_windows_reference(win, **kw)
    assert float((ref[0] >= 0).float().mean()) > 0.1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # K4's winners are K2's
    tri_id, row, _ = R.select_windows_reference(
        win, torch.zeros((win.setup.shape[0], 24, win.setup.shape[2]),
                         device=card), **kw)
    assert torch.equal(got[0], tri_id) and torch.equal(got[2], row)


def test_contract_path_on_card_matches_oracle(card):
    """rasterize_batch on the card at 64 px (one K4 launch) against the
    port's oracle: tri_id exactly equal, bary within 1e-5 and zbuf within
    1e-5 relative (the CPU suite's bars)."""
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    bfm = device_bfm(assets, card)
    c = split_coeff(torch.as_tensor(
        sample_coeffs(np.random.default_rng(7), cfg, 2), device=card), cfg)
    vndc = coeffs_to_geometry(c, bfm, cfg).verts_ndc
    s = cfg.image_size
    before = _build.LAUNCHES["raster_pos"]
    tri_id, bary, zbuf = R.rasterize_batch(
        vndc, bfm.faces, height=s, width=s, cfg=cfg, n_cols=cfg.raster_cols,
        row_faces=bfm.raster_rows, row_id=bfm.raster_row_id)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_pos"] == before + 1
    for b in range(2):
        tid_o, bary_o, z_o = oracle.rasterize(vndc[b].cpu().numpy(),
                                              assets.faces, s, s)
        cov = tid_o >= 0
        assert cov.mean() > 0.1
        np.testing.assert_array_equal(tri_id[b].cpu().numpy(), tid_o)
        np.testing.assert_allclose(bary[b].cpu().numpy(), bary_o, rtol=0,
                                   atol=1e-5)
        z = zbuf[b].cpu().numpy()
        np.testing.assert_allclose(z[cov], z_o[cov], rtol=1e-5, atol=0)
        assert np.all(np.isinf(z[~cov]))


def test_evaluate_meets_the_contract_on_card(card):
    """evaluate.run on the card (the training render under no_grad,
    against the oracle): vertex MAE under 1e-3 and the contract met."""
    from facerecon_tpu_torch import evaluate
    report = evaluate.run(2, tiny=True, device=card)
    assert report["backend"].startswith("cuda")
    assert report["vertex_mae"] < 1e-3 and report["meets_contract"]


def _walk_words(rng, n, live):
    """n mask words of `live` set bits each, at random places."""
    bits = np.zeros(n, np.int64)
    for r in range(n):
        bits[r] = int(np.sum(1 << rng.choice(32, size=live, replace=False)
                             .astype(np.int64)))
    return bits.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", ["live4", "live8", "live16", "live32",
                                  "edge_words", "n_prog_2047",
                                  "signed_zeros"])
def test_ctz_walk_kernel_matches_plain_version(card, case):
    """K6 bit for bit equal to its plain version in one launch: 2,048
    programs of 4, 8, 16 or 32 live bits (the probe's shape); the edge
    words (empty, bit 31 alone, every bit) among random ones; 2,047
    programs of any bit count, a multiple of no block or wave size; and
    triangles whose e0 and e1 are -0.0 at pixel 0 (s0, s2 < 0 and s1 = s3
    = -0.0): covered there, and the nearest."""
    from facerecon_tpu_torch.ops import probes
    rng = np.random.default_rng(0)
    st = rng.standard_normal(probes.SETUP_SHAPE)
    if case == "signed_zeros":
        cols = np.arange(5, 32 * probes.CHUNK, 37)
        for f in (0, 2):
            st[f, cols] = -np.abs(st[f, cols])
            st[f + 1, cols] = -0.0
        st[5, cols] = -100.0 - np.arange(cols.size)
    setup = torch.as_tensor(st, dtype=torch.float32, device=card)
    edge = np.array([0, 1 << 31, 0xFFFFFFFF, 1, 0x0F0F0F0F],
                    np.uint32).view(np.int32)
    if case.startswith("live"):
        words = _walk_words(rng, 2048, int(case[4:]))
    else:
        n = 64 if case == "edge_words" else 2047
        words = np.concatenate([edge, rng.integers(
            0, 2 ** 32, n - 2 * edge.size, dtype=np.uint64).astype(
            np.uint32).view(np.int32), edge])
    mask = torch.as_tensor(words, device=card)
    before = _build.LAUNCHES["ctz_walk"]
    got = probes.ctz_walk(mask, setup)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ctz_walk"] == before + 1
    ref = probes.ctz_walk_reference(mask, setup)
    assert got.shape == (words.size, probes.COL_PX)
    assert bool(torch.isfinite(ref).any())
    if case == "signed_zeros":
        assert bool((ref[:, 0] <= -100.0).any())
    assert torch.equal(got, ref)


def test_train_step_on_card_matches_cpu(card):
    """One float32 training step (depth 18) on the card and on the CPU
    from the same weights: the reference's initialisation with a head
    that is not zero, so the gradient reaches the backbone."""
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((2, cfg.image_size, cfg.image_size,
                                         3)), dtype=torch.float32)
    lmk = torch.as_tensor(rng.random((2, 68, 2)) * cfg.image_size,
                          dtype=torch.float32)
    head_w = torch.as_tensor(rng.standard_normal((cfg.n_coeff, 2048))
                             * 2e-3, dtype=torch.float32)
    head_b = torch.as_tensor(sample_coeffs(rng, cfg, 1)[0])
    runs = []
    for dev in (card, "cpu"):
        pipe = make_train_pipeline(cfg, assets, device=dev,
                                   dtype=torch.float32, depth=18)
        state = init_state(pipe, total_steps=50, seed=0)
        with torch.no_grad():
            pipe.model.head.weight.copy_(head_w)
            pipe.model.head.bias.copy_(head_b)
        before = dict(_build.LAUNCHES)
        parts = make_train_step(pipe)(state, images.to(dev), lmk.to(dev))
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        runs.append(({k: float(v) for k, v in parts.items()},
                     {n: p.grad.cpu() for n, p in
                      pipe.model.named_parameters()}, launched))
    (p_card, g_card, l_card), (p_cpu, g_cpu, l_cpu) = runs
    assert l_card == _launches(raster_select=1, select_grad=1)
    assert not any(l_cpu.values())
    assert p_cpu["photo"] > 0.01
    for k, v in p_cpu.items():
        assert abs(p_card[k] - v) <= 1e-4 * abs(v) + 1e-9, k
    for name, g in g_cpu.items():
        scale = float(g.abs().max())
        assert float((g_card[name] - g).abs().max()) <= 1e-3 * scale, name


def test_fit_step_on_card_matches_cpu(card):
    """One fit step (fit.make_fit_fn, landmarks on) on the card and on
    the CPU from the same start and targets: the loss within 1e-4
    relative, the coefficients' gradient within 1e-3 of its max; K2 and
    K3 launch once each on the card (and K2 and the geometry kernel once
    more for the final loss, under no_grad), never on the CPU."""
    from facerecon_tpu_torch.data.synthetic import render_batch
    from facerecon_tpu_torch.fit import make_fit_fn
    from facerecon_tpu_torch.ops.losses import total_loss
    from facerecon_tpu_torch.ops.render import render_coeffs
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    rng = np.random.default_rng(2)
    target, lmk = (t.cpu() for t in render_batch(
        sample_coeffs(rng, cfg, 2), device_bfm(assets, "cpu"), cfg))
    start = torch.as_tensor(sample_coeffs(rng, cfg, 2))
    runs = []
    for dev in (card, "cpu"):
        bfm = device_bfm(assets, dev)
        before = dict(_build.LAUNCHES)
        res = make_fit_fn(cfg, 1, lr=5e-3)(start, bfm, target, lmk)
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        coeff = start.to(dev).requires_grad_(True)
        c = split_coeff(coeff, cfg)
        out = render_coeffs(c, bfm, cfg, background=target.to(dev))
        loss, _ = total_loss(out, c, target.to(dev), lmk.to(dev), bfm, cfg)
        (grad,) = torch.autograd.grad(loss, coeff)
        runs.append((float(res.losses[0]), grad.cpu(), launched))
    (l_card, g_card, n_card), (l_cpu, g_cpu, n_cpu) = runs
    assert n_card == _launches(raster_select=2, select_grad=1, geometry=1)
    assert not any(n_cpu.values())
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    scale = float(g_cpu.abs().max())
    assert scale > 0
    assert float((g_card - g_cpu).abs().max()) <= 1e-3 * scale


def test_fold_on_card_matches_cpu_fold(card):
    """fold_bn_model of a BatchNorm model on the card equals the fold of
    the same model on the CPU bit for bit, and the fused model on the
    card computes the BN model's eval forward (float32) within 1e-4 x
    max |y|."""
    from facerecon_tpu_torch.models.fused import (FusedResNetRegressor,
                                                  fold_bn_model)
    from facerecon_tpu_torch.models.resnet import BatchNorm, build_model
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(3)
    model = build_model(cfg, dtype=torch.float32).reset_parameters_(gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.numel()
                mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(
                    (1 + 0.1 * torch.randn(n, generator=gen)).abs() + 0.01)
        model.head.weight.copy_(0.01 * torch.randn(
            model.head.weight.shape, generator=gen))
    want = fold_bn_model(model)
    model = model.to(card, memory_format=torch.channels_last).eval()
    got = fold_bn_model(model)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    fused = FusedResNetRegressor(cfg.n_coeff, model.stage_sizes,
                                 model.width, torch.float32)
    fused.load_state_dict(got)
    fused = fused.to(card, memory_format=torch.channels_last).eval()
    x = torch.rand((2, cfg.image_size, cfg.image_size, 3), generator=gen)
    with torch.no_grad():
        y_bn, y = model(x.to(card)), fused(x.to(card))
    scale = float(y_bn.abs().max())
    assert float((y - y_bn).abs().max()) <= 1e-4 * scale


def test_checkpoint_saved_on_card_restores_on_cpu(card, tmp_path):
    """A training checkpoint written from the card (model, Adam and the
    schedule after one step) restores into a CPU trainer bit for bit, and
    into a fresh trainer on the card too."""
    from facerecon_tpu_torch.checkpoint import CheckpointManager
    from facerecon_tpu_torch.train import restore_state, save_state
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((2, cfg.image_size, cfg.image_size,
                                         3)), dtype=torch.float32)
    lmk = torch.as_tensor(rng.random((2, 68, 2)) * cfg.image_size,
                          dtype=torch.float32)
    pipe = make_train_pipeline(cfg, assets, device=card, depth=18)
    state = init_state(pipe, total_steps=20, seed=0)
    make_train_step(pipe)(state, images.to(card), lmk.to(card))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    save_state(mgr, pipe, state)
    for dev in ("cpu", card):
        other = make_train_pipeline(cfg, assets, device=dev, depth=18, seed=5)
        other_state = init_state(other, total_steps=20, seed=5)
        restore_state(mgr, other, other_state)
        assert other_state.step == 1
        for name, t in pipe.model.state_dict().items():
            got = other.model.state_dict()[name]
            assert got.device.type == torch.device(dev).type, name
            assert torch.equal(got.cpu(), t.cpu()), name
        for (_, a), (_, b) in zip(
                sorted(state.optimizer.state_dict()["state"].items()),
                sorted(other_state.optimizer.state_dict()["state"].items())):
            for k in a:
                assert torch.equal(a[k].cpu(), b[k].cpu()), k
        assert (other_state.scheduler.state_dict()
                == state.scheduler.state_dict())
        assert (other_state.optimizer.param_groups[0]["lr"]
                == state.optimizer.param_groups[0]["lr"])


def test_nccl_world1_train_step_equals_plain_step(card, tmp_path,
                                                  monkeypatch):
    """Two training steps (bf16, depth 18) inside a world-size-1 NCCL
    group equal the same steps with no group, from the same weights and
    batch, bit for bit (cuDNN held to its deterministic algorithms): the
    all-reduce of the gradients and of the loss parts over one rank is
    the identity (and the division by one exact), and BatchNorm at world
    size 1 takes its single-device path."""
    import torch.distributed as dist
    from facerecon_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = tiny_config()
    assets = synthetic_bfm(cfg, 0)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((4, cfg.image_size, cfg.image_size,
                                         3)), dtype=torch.float32).to(card)
    lmk = torch.as_tensor(rng.random((4, 68, 2)) * cfg.image_size,
                          dtype=torch.float32).to(card)
    runs = []
    for grouped in (False, True):
        if grouped:
            mesh.init("cuda", world_size=1, rank=0,
                      init_method=f"file://{tmp_path / 'rendezvous'}")
        try:
            assert mesh.grouped() == grouped
            pipe = make_train_pipeline(cfg, assets, device=card, depth=18)
            state = init_state(pipe, total_steps=2, seed=0)
            with torch.no_grad():
                pipe.model.head.weight.normal_(
                    0.0, 2e-3, generator=torch.Generator(card).manual_seed(1))
            step = make_train_step(pipe)
            parts = [step(state, images, lmk) for _ in range(2)][-1]
            torch.cuda.synchronize()
            runs.append(({k: v.cpu() for k, v in parts.items()},
                         {k: v.cpu() for k, v in
                          pipe.model.state_dict().items()}))
        finally:
            mesh.close()
    assert not dist.is_initialized()
    (p0, s0), (p1, s1) = runs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_dryrun_multichip_over_nccl_at_world_size_1(card):
    """graft_entry.dryrun_multichip(1): one sharded train step in a
    spawned rank over NCCL (file:// rendezvous) gives a finite loss."""
    from facerecon_tpu_torch.graft_entry import dryrun_multichip
    assert np.isfinite(dryrun_multichip(1, "cuda"))


def test_joint_solve_first_kernel_calls_equal_plain(card, monkeypatch):
    """The joint track solve at batch 4 frames launches K2 and K3 once
    a step; its first K2 and K3 calls, recorded, equal their plain
    versions (K2 exactly, K3 within 1e-5 x max |ref|)."""
    from facerecon_tpu_torch import track
    from facerecon_tpu_torch.data.synthetic import render_batch
    cfg = tiny_config()
    bfm = device_bfm(synthetic_bfm(cfg, 0), card)
    seq = np.tile(sample_coeffs(np.random.default_rng(2), cfg, 1), (4, 1))
    seq[:, cfg.coeff_split[2]] += np.linspace(-0.1, 0.1, 4).astype(
        np.float32)
    frames, lmk = render_batch(seq, bfm, cfg)
    seen = {}
    for name in ("select_windows", "select_grad"):
        def call(*args, _fn=getattr(R, name), _name=name, **kw):
            seen.setdefault(_name, (tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), dict(kw)))
            return _fn(*args, **kw)
        monkeypatch.setattr(R, name, call)
    tp0 = track._decompose(torch.as_tensor(seq * 0.5, device=card), cfg)
    before = dict(_build.LAUNCHES)
    _, losses = track.make_refine_fn(cfg, 3, 5e-3)(tp0, bfm, frames, lmk)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(raster_select=3, select_grad=3)
    assert bool(torch.isfinite(losses).all())
    monkeypatch.undo()
    args, kw = seen["select_windows"]
    assert args[1].shape[0] == 4
    for a, b in zip(R.select_windows(*args, **kw),
                    R.select_windows_reference(*args, **kw)):
        assert torch.equal(a, b)
    args, kw = seen["select_grad"]
    got = R.select_grad(*args, **kw)
    ref = R.select_grad_reference(*args, **kw)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["headline", "train", "render512"])
def test_bench_modes_launch_their_kernels(card, mode):
    """Each mode at small sizes: one warm-up pass and `reps` timed ones,
    so (1 + reps) passes of launches and nothing else; the payload has
    the reference's keys, a positive rate and vs_baseline null."""
    from facerecon_tpu_torch import bench
    before = dict(_build.LAUNCHES)
    if mode == "headline":
        payload, (cv, out) = bench.headline(batch=8, micro=4, reps=2,
                                            inner_reps=2, device=card)
        want = {"raster_shade": (1 + 2 * 2) * 2, "geometry": (1 + 2 * 2) * 2}
        assert not cv.any()                    # the reference's zero head
    elif mode == "train":
        payload, parts = bench.train(batch=4, reps=2, chunk=2, device=card)
        want = {"raster_select": (1 + 2) * 2, "select_grad": (1 + 2) * 2}
        out = torch.stack(list(parts.values()))
    else:
        payload, out = bench.render512(batch=8, micro=4, reps=2,
                                       device=card)
        want = {"raster_shade": (1 + 2) * 2, "geometry": (1 + 2) * 2}
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(**want)
    assert bool(torch.isfinite(out).all())
    assert list(payload) == ["metric", "value", "unit", "vs_baseline"]
    assert payload["value"] > 0 and payload["vs_baseline"] is None


@pytest.mark.parametrize("driver", ["infer", "infer_fused", "track",
                                    "track_sequential"])
def test_drivers_launch_their_kernels(card, tmp_path, driver):
    """Each driver at tiny_config() through its run(), counted: infer
    (--synthetic 2 --overlay --depth, BN and --fused) one K1 launch (the
    synthetic render), one K2 (its reconstruct) and two geometry
    launches; track, joint (4 frames x 3 refine steps) and --sequential
    (2 frames x 2 steps a frame), K1 twice (the sequence's render and the
    tracked one), K2 a step and once for the report, K3 a step, and four
    geometry launches (the no_grad renders and the sequence's ground
    truth); nothing else, and finite reports."""
    from facerecon_tpu_torch import infer, track
    before = dict(_build.LAUNCHES)
    if driver.startswith("infer"):
        rep = infer.run(infer.parse_args(
            ["--tiny", "--synthetic", "2", "--out", str(tmp_path),
             "--overlay", "--depth"]
            + (["--fused"] if driver == "infer_fused" else [])))
        want = _launches(raster_shade=1, raster_select=1, geometry=2)
        assert np.isfinite(rep["landmark_rmse_px"])
    else:
        seq = driver == "track_sequential"
        frames, steps = (2, 2) if seq else (4, 3)
        rep = track.run(track.parse_args(
            ["--tiny", "--frames", str(frames), "--refine-steps", str(steps)]
            + (["--sequential"] if seq else [])))
        n = frames * steps if seq else steps
        want = _launches(raster_shade=2, raster_select=n + 1, select_grad=n,
                         geometry=4)
        assert np.isfinite([rep["loss_first"], rep["loss_last"]]).all()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == want


def test_entry_launches_select_once(card, monkeypatch):
    """fn(*args) of graft_entry.entry() on the card: the reference
    test's shapes, finite outputs, one K2 launch and nothing else; its K2
    call, recorded, equals the plain version."""
    from facerecon_tpu_torch.graft_entry import entry
    fn, args = entry(device=card)
    seen = {}

    def call(*a, _fn=R.select_windows, **kw):
        seen["k2"] = (tuple(x.clone() if isinstance(x, torch.Tensor) else x
                            for x in a), dict(kw))
        return _fn(*a, **kw)
    monkeypatch.setattr(R, "select_windows", call)
    before = dict(_build.LAUNCHES)
    coeffs, image, lmk = fn(*args)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    monkeypatch.undo()
    assert launched == _launches(raster_select=1)
    assert coeffs.shape == (8, 257)
    assert image.shape == (8, 224, 224, 3) and lmk.shape == (8, 68, 2)
    for t in (coeffs, image, lmk):
        assert bool(torch.isfinite(t).all())
    a, kw = seen["k2"]
    for x, y in zip(R.select_windows(*a, **kw),
                    R.select_windows_reference(*a, **kw)):
        assert torch.equal(x, y)


def test_trace_twin_holds_its_select_events(card, tmp_path):
    """profile_trace.trace at tiny_config(), batch 2, 2 traced calls:
    K2 and the geometry kernel (the forward is under no_grad) launched
    1 + 2 times and nothing else; the trace holds exactly 2 device events
    of each (the profiler records the ctypes-launched kernels) and no
    other kernel of the port."""
    from facerecon_tpu_torch import profile_trace
    before = dict(_build.LAUNCHES)
    path, _ = profile_trace.trace(str(tmp_path), batch=2, steps=2,
                                  device=card, cfg=tiny_config())
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(raster_select=3, geometry=3)
    s = profile_trace.summarize(profile_trace.load_events(path))
    assert s["kernels"] == _launches(raster_select=2, geometry=2)
    assert 0 < s["busy_share"] <= 1


def _recorded(monkeypatch, *names):
    """Wraps ops.rasterize's named wrappers to keep a copy of the
    arguments of their first call; returns name -> (args, kwargs)."""
    seen = {}

    def wrap(name, fn):
        def call(*a, **kw):
            if name not in seen:
                seen[name] = (tuple(
                    x.detach().clone() if isinstance(x, torch.Tensor)
                    else type(x)(*(t.clone() for t in x))
                    if isinstance(x, R.Windows) else x for x in a), dict(kw))
            return fn(*a, **kw)
        return call
    for n in names:
        monkeypatch.setattr(R, n, wrap(n, getattr(R, n)))
    return seen


def test_render_bench_select_at_512px_matches_plain(card, monkeypatch):
    """render_bench's bwd call at 512 px (default_config's asset, focal
    scaled, tile_h 1 x 7 columns of 80 px), batch 2: one K2 and one K3
    launch; K2's call exactly equal to its plain version, K3's within
    1e-5 x max |ref| and bitwise equal over two launches; finite."""
    from facerecon_tpu_torch import render_bench
    cfg, bfm, coeffs, target = render_bench.setup(512, 2, device=card)
    assert (cfg.tile_h, cfg.raster_cols) == (1, 7)
    seen = _recorded(monkeypatch, "select_windows", "select_grad")
    before = dict(_build.LAUNCHES)
    s = render_bench.make_one(cfg, bfm, target, bwd=True)(coeffs)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    monkeypatch.undo()
    assert launched == _launches(raster_select=1, select_grad=1)
    assert bool(torch.isfinite(s))
    a, kw = seen["select_windows"]
    assert kw["tile_h"] == 1 and kw["n_cols"] == 7 and kw["height"] == 512
    got = R.select_windows(*a, **kw)
    ref = R.select_windows_reference(*a, **kw)
    assert float((ref[0] >= 0).float().mean()) > 0.05
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    a, kw = seen["select_grad"]
    got, again = R.select_grad(*a, **kw), R.select_grad(*a, **kw)
    assert torch.equal(got, again)
    ref = R.select_grad_reference(*a, **kw)
    scale = float(ref.abs().max())
    assert scale > 0 and float((got - ref).abs().max()) <= 1e-5 * scale


def test_raster_bench_pos_culled_wide_band_matches_plain(card):
    """K4 as raster_bench runs it with --cull: default_config's asset at
    224 px, tile_h 8 x one 224-px column, the asset's own face order,
    back faces culled, batch 2: exactly equal to its plain version, and
    pos_fn's tri_id is that of K4."""
    from facerecon_tpu_torch import raster_bench
    vndc, faces = raster_bench.geometry(2, card)
    win = R.band_windows(vndc, faces, torch.arange(faces.shape[0],
                                                   device=card),
                         224, 224, 8, 1, cull_backfaces=True)
    kw = dict(height=224, width=224, tile_h=8, n_cols=1,
              n_faces=faces.shape[0])
    got = R.pos_windows(win, **kw)
    ref = R.pos_windows_reference(win, **kw)
    assert float((ref[0] >= 0).float().mean()) > 0.05
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    tid, chk = raster_bench.make_pos_fn(224, 8, cull=True)(vndc, faces)
    assert torch.equal(tid, got[0]) and int(chk) == int(got[0].sum())


@pytest.mark.parametrize("twin", ["render", "render_bwd", "raster"])
def test_bench_twins_launch_their_kernels(card, monkeypatch, twin):
    """The twins' mains at tiny_config() (default_config swapped for it):
    render_bench (1 + 3 reps) x inner K2 launches, as many K3 with
    --bwd, or as many geometry launches without (the forward is under
    no_grad); raster_bench 1 + 3 reps K4 launches and one more for
    --check, whose mismatch is 0, and one geometry launch (its inputs);
    nothing else."""
    from facerecon_tpu_torch import raster_bench, render_bench
    mod = raster_bench if twin == "raster" else render_bench
    monkeypatch.setattr(mod, "default_config",
                        lambda **over: tiny_config(**over))
    before = dict(_build.LAUNCHES)
    if twin == "raster":
        res = raster_bench.main(["--batch", "2", "--reps", "1", "--size",
                                 "64", "--check"])
        want = {"raster_pos": 1 + 3 + 1, "geometry": 1}
        assert res["mismatch"] == 0
    else:
        bwd = twin == "render_bwd"
        res = render_bench.main(["--batch", "2", "--reps", "1", "--inner",
                                 "2", "--size", "64", "--tileh", "2"]
                                + (["--bwd"] if bwd else []))
        n = (1 + 3) * 2
        want = {"raster_select": n, "select_grad": n if bwd else 0,
                "geometry": 0 if bwd else n}
        assert np.isfinite(res["sum"])
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(**want)


def test_probe_stems_agree_on_card(card):
    """cnn_micro_probe's stems at batch 2 on the card: conv4 on s2d input
    against conv7/s2, in f32 (TF32 off) and in bf16; pool_rw and
    pool_slices differ at the same outputs as on the CPU."""
    from facerecon_tpu_torch.benchmarks import cnn_micro_probe as MIC
    before = dict(_build.LAUNCHES)
    d = MIC.make_inputs(2, card)
    img, b0 = d["img"], d["b0"]
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        a = MIC.conv4(img, d["w4"].to(dt), b0)
        b = MIC.conv7(img, d["w7"].to(dt), b0)
        assert a.dtype == dt and a.shape == (2, 112, 112, 64)
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
    y = MIC.conv7(img, d["w7"].float(), b0)
    differ = MIC.pool_rw(y) != MIC.pool_slices(y)
    yc = y.cpu()
    assert torch.equal(differ.cpu(), MIC.pool_rw(yc) != MIC.pool_slices(yc))
    assert float(differ.float().mean()) > 0.5
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before


def test_probe_scatter_min_on_card_equals_cpu(card):
    """scatter_probe's pass 1 and two-pass form at batch 2, 4,096
    candidates, 224 px, on the card against the same calls on a CPU copy
    (exact), and pass 1 of image 0 against numpy's minimum.at."""
    from facerecon_tpu_torch.benchmarks import scatter_probe as SCA
    idx, zb, ids = SCA.make_inputs(2, 4096, 224, card)
    hw, n = 224 * 224, 2 * 224 * 224
    gi = SCA.flat_index(idx, hw, torch.zeros((), device=card))
    got = SCA.two_pass(gi, zb.reshape(-1), ids.reshape(-1), n)
    want = SCA.two_pass(gi.cpu(), zb.reshape(-1).cpu(),
                        ids.reshape(-1).cpu(), n)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    ref = np.full(hw, SCA.INT32_MAX, np.int64)
    np.minimum.at(ref, idx[0].cpu().numpy(), zb[0].cpu().numpy())
    np.testing.assert_array_equal(got[0][:hw].cpu().numpy(), ref)


def test_probe_gathers_on_card_equal_cpu(card):
    """gather_probe's forms at batch 2 on the card against the same calls
    on a CPU copy, on the first image: within 1e-6 x max |ref| (exact but
    for the adjacency's sums)."""
    from facerecon_tpu_torch.benchmarks import gather_probe as GAT
    d = GAT.make_inputs(2, card)
    with torch.no_grad():
        for tag, form, x, i in GAT.CASES:
            ix = d[i] if i != "bidx" else d[i][:1]
            got = form(d[x][:1], ix)
            want = form(d[x][:1].cpu(), ix.cpu())
            for g, w in zip(got, want):
                scale = float(w.abs().max())
                assert float((g.cpu() - w).abs().max()) <= 1e-6 * scale, tag


# --- the variant builds: K6's per-bit walk and K5's ablation switches ---

@pytest.mark.parametrize("live", [4, 8, 16, 32])
def test_ctz_unrolled_build_matches_plain_version(card, live):
    """The CTZ_UNROLLED build (the probe's looped=0 walk, through the twin
    benchmarks/ctzloop_probe) bit for bit equal to K6's plain version at
    the probe's shape, as the __ffs walk is; its launch counts under
    ctz_walk."""
    from facerecon_tpu_torch.benchmarks import ctzloop_probe as CTZ
    from facerecon_tpu_torch.ops import probes
    setup, masks = CTZ.inputs(card)
    mask = masks[live]
    before = dict(_build.LAUNCHES)
    got = CTZ.walk(mask, setup, looped=False)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(ctz_walk=1)
    assert torch.equal(got, probes.ctz_walk_reference(mask, setup))


def _floor_case(card, mode, setting, fill=-12345):
    """An ablated build (benchmarks/floor_probe, RP_ABLATE `setting`) of
    the mode's kernel and the full one on tiny_config(n_vertices=6000)'s
    windows, each launched by the twin: (ablated outputs, filled with
    `fill` first, full outputs, launches the ablated call made)."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    _, win, rec, kw = _kernel_inputs(card, "raster_rows")
    fkw = dict(size=kw["height"], tile_h=kw["tile_h"], n_cols=kw["n_cols"],
               n_faces=kw["n_faces"])
    full = FP.call(mode, win, rec, **fkw)
    outs = FP.outputs(mode, win.setup.shape[0], kw["height"], card, fill)
    before = dict(_build.LAUNCHES)
    FP.launch(mode, win, rec, outs, defines=FP.ablation(setting, mode),
              **fkw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert float((full[0] >= 0).float().mean()) > 0.1
    return outs, full, launched


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("mode", ["shade", "select", "pos"])
def test_cull_stripped_equals_full_kernel(card, mode):
    """With the cull stripped every fetched triangle is tested; the cull
    is exact, so K1, K2 and K4 give the full kernel's outputs bit for
    bit. The variant's one launch counts under its kernel's name, and no
    key is added."""
    outs, full, launched = _floor_case(card, mode, "cull")
    for a, b in zip(outs, full):
        assert torch.equal(_bits(a), _bits(b))
    name = {"shade": "raster_shade", "select": "raster_select",
            "pos": "raster_pos"}[mode]
    assert set(launched) == set(_build.KERNELS)
    assert launched == {k: int(k == name) for k in _build.KERNELS}


@pytest.mark.parametrize("mode", ["shade", "select", "pos"])
def test_eval_stripped_gives_background(card, mode):
    """With the z-tests stripped no pixel is covered: tri_id -1 and every
    other output what the kernel writes on background (K1 zeros; K2 row
    -1 and zeros; K4 +inf depth and row -1)."""
    outs, _, _ = _floor_case(card, mode, "eval")
    background = {"shade": (-1, 0.0, 0.0), "select": (-1, -1, 0.0),
                  "pos": (-1, float("inf"), -1)}[mode]
    for t, v in zip(outs, background):
        assert bool((t == v).all())


@pytest.mark.parametrize("mode", ["shade", "select", "pos"])
def test_pack_stripped_leaves_outputs_untouched(card, mode):
    """With the epilogue's arithmetic and stores stripped, outputs filled
    with a sentinel keep it."""
    outs, _, _ = _floor_case(card, mode, "pack")
    for t in outs:
        assert bool((t == -12345).all())


@pytest.mark.parametrize("tile_h", [1, 2, 3, 4, 5, 8, 64, 136])
def test_raster_kernels_at_every_band_height(card, tile_h):
    """K1, K2 and K4 equal their plain versions on bands of 1, 2, 3, 4, 5,
    8, 64 and 136 rows (a 1-row band: each micro-tile's second row lies
    past the tile; 3 rows x 32-px columns and 5 rows x 16-px columns:
    each pixel group of 2 and 3 micro-rows ends in a micro-row whose
    second pixel row lies past the tile; 136: past the image), in both
    face orders (the shuffled one walks chunks beyond the 64-chunk
    masks)."""
    n_cols = {5: 4}.get(tile_h, 2 if tile_h <= 4 else 1)
    for order in ("raster_rows", "shuffled"):
        _, win, rec, kw = _kernel_inputs(card, order, batch=2,
                                         tile_h=tile_h, n_cols=n_cols)
        ref = _hold_raster(win, rec, kw)
        assert float((ref[0] >= 0).float().mean()) > 0.1


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
def test_raster_kernels_on_saturated_masks(card, order):
    """With every chunk-mask bit set (floor_probe's FLOOR_MASK=ones: each
    tile walks every chunk of its window's first 64), K1, K2 and K4
    still equal their plain versions: the extra chunks hold rows that
    cover none of the tile's pixels, and the micro-tile masks drop
    them."""
    _, win, rec, kw = _kernel_inputs(card, order, batch=2)
    ones = win._replace(cmask=torch.full_like(win.cmask, -1))
    ref = _hold_raster(ones, rec, kw)
    assert torch.equal(ref[0], R.pos_windows(win, **kw)[0])


def test_raster_kernels_at_512px_one_row_bands(card):
    """At 512 px with tile_h 1 and 7 columns of 80 px (render_bench's 512
    px shape): two pixel groups a column tile, the second 16 px wide,
    and the last column tile reaching past the image; K1, K2 and K4 equal
    their plain versions, and so does the RP_ABLATE=cull build of K2
    (every lane tests all 32 rows of a segment) bit for bit."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    _, win, rec, kw = _kernel_inputs(card, "raster_rows", batch=2,
                                     tile_h=1, n_cols=7, size=512)
    assert R.col_width(512, 7) == 80
    ref = _hold_raster(win, rec, kw)
    assert float((ref[0] >= 0).float().mean()) > 0.05
    fkw = dict(size=512, tile_h=1, n_cols=7, n_faces=kw["n_faces"])
    outs = FP.outputs("select", 2, 512, card, -12345)
    FP.launch("select", win, rec, outs, defines=FP.ablation("cull",
                                                           "select"), **fkw)
    full = R.select_windows(win, rec, **kw)
    for a, b in zip(outs, full):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("cull", [False, True], ids=["all", "cull"])
def test_raster_kernels_on_shuffled_turned_faces(card, cull):
    """A shuffled face order with an image turned 2.5 rad (mostly back
    faces, which overlap the front ones: long per-lane lists), without
    and with cull_backfaces: K1, K2 and K4 equal their plain versions."""
    _, win, rec, kw = _kernel_inputs(card, "shuffled", batch=2,
                                     turned=True, cull=cull)
    ref = _hold_raster(win, rec, kw)
    assert float((ref[0][0] >= 0).float().mean()) > 0.1


# --- the binning kernels (csrc/binning.cu) against their plain version ---

@pytest.fixture(scope="module")
def full_mesh():
    """default_config()'s synthetic mesh (70,688 faces) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from facerecon_tpu_torch.config import default_config
    cfg = default_config()
    assets = synthetic_bfm(cfg, 0)
    return cfg, device_bfm(assets, "cuda")


def _full_verts(full_mesh, size, batch, seed=0):
    """verts_ndc of sample_coeffs faces on the full mesh at `size` px
    (focal scaled with it)."""
    cfg, bfm = full_mesh
    cfg = dataclasses.replace(cfg, image_size=size,
                              focal=cfg.focal * size / cfg.image_size)
    coeff = sample_coeffs(np.random.default_rng(seed), cfg, batch)
    c = split_coeff(torch.as_tensor(coeff, device=bfm.faces.device), cfg)
    return coeffs_to_geometry(c, bfm, cfg).verts_ndc


def _hold_windows(vndc, rows, rid, size, tile_h, n_cols, cull=False):
    """band_windows on the card: one launch of each binning kernel and
    nothing else, and Windows bit for bit the plain version's (the setup
    as int32 bits over all 16 fields and every padded row)."""
    before = dict(_build.LAUNCHES)
    got = R.band_windows(vndc, rows, rid, size, size, tile_h, n_cols, cull)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k in ("bin_setup", "bin_windows"))
                        for k in _build.KERNELS}
    ref = R.band_windows_reference(vndc, rows, rid, size, size, tile_h,
                                   n_cols, cull)
    assert got.setup.shape == ref.setup.shape
    assert torch.equal(got.setup.view(torch.int32),
                       ref.setup.view(torch.int32))
    for name in ("blo", "bn", "cmask"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    return got


def _order(bfm, order):
    if order == "raster_rows":
        return bfm.raster_rows, bfm.raster_row_id
    rid = torch.as_tensor(np.random.default_rng(3).permutation(
        bfm.faces.shape[0]), device=bfm.faces.device)
    return bfm.faces[rid], rid


# path -> (size, tile_h, n_cols, batch): the inference and training
# microbatch, render512's, and a single frame
_BIN_SHAPES = {"infer224": (224, 4, 7, 128), "render512": (512, 2, 8, 32),
               "frame224": (224, 4, 7, 1)}


@pytest.mark.parametrize("order", ["raster_rows", "shuffled"])
@pytest.mark.parametrize("path", list(_BIN_SHAPES))
def test_binning_kernels_equal_plain_at_path_shapes(card, full_mesh, path,
                                                    order):
    """The binning kernels at each main path's shape, on the asset's
    raster row order and on a shuffled order (windows past the 64-chunk
    masks): Windows bit for bit the plain version's."""
    size, tile_h, n_cols, batch = _BIN_SHAPES[path]
    rows, rid = _order(full_mesh[1], order)
    win = _hold_windows(_full_verts(full_mesh, size, batch), rows, rid,
                        size, tile_h, n_cols)
    assert bool((win.bn > 0).any()) and bool(win.cmask.any())
    if order == "shuffled":
        assert int(win.bn.max()) > 64


@pytest.mark.parametrize("cull", [False, True], ids=["all", "cull"])
def test_binning_kernels_equal_plain_in_identity_order(card, full_mesh,
                                                       cull):
    """K4's contract and raster_bench shape: the asset's face order as the
    row order (row id = face id), tile_h 8 x one 224-px column, batch 64,
    with and without cull_backfaces."""
    faces = full_mesh[1].faces
    rid = torch.arange(faces.shape[0], device=faces.device)
    win = _hold_windows(_full_verts(full_mesh, 224, 64, seed=1), faces, rid,
                        224, 8, 1, cull)
    assert bool((win.bn > 0).any())


@pytest.mark.parametrize("cull", [False, True], ids=["all", "cull"])
def test_binning_kernels_on_degenerate_and_off_screen_faces(card, full_mesh,
                                                            cull):
    """Image 0 with 5,000 faces collapsed to a point or an edge (dead
    rows), image 1 snapped to a 1/16 NDC grid (integer pixel corners on
    band and column edges, and more dead rows), image 2 moved half off
    the right edge, image 3 wholly off screen (nothing hits: every
    window and mask 0): Windows bit for bit the plain version's."""
    bfm = full_mesh[1]
    vndc = _full_verts(full_mesh, 224, 4, seed=2).clone()
    f = bfm.raster_rows[:5000]
    vndc[0, f[:, 1]] = vndc[0, f[:, 0]]
    vndc[1, :, :2] = torch.round(vndc[1, :, :2] * 16.0) / 16.0
    vndc[2, :, 0] += 1.0
    vndc[3, :, 0] += 10.0
    win = _hold_windows(vndc, bfm.raster_rows, bfm.raster_row_id, 224, 4, 7,
                        cull)
    assert not bool(win.bn[3].any() or win.blo[3].any()
                    or win.cmask[3].any())
    assert bool((win.bn[:3] > 0).any(dim=1).all())
    dead = win.setup[0, 2, :bfm.raster_rows.shape[0]] == np.float32(-3e38)
    assert int(dead.sum()) > 1000


@pytest.mark.parametrize("case", ["verts_f64", "faces_i32", "faces_cpu",
                                  "strided_verts", "cols_33"])
def test_binning_wrapper_rejects_what_the_kernels_do_not_take(card, case):
    """band_windows on the card raises, launching nothing, on a wrong
    dtype or device, a non-contiguous input, or more column tiles than
    the window pass has warps (32)."""
    cfg = tiny_config()
    s = cfg.image_size
    vndc = torch.zeros((1, 4, 3), device=card)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], device=card)
    rid = torch.arange(2, device=card)
    n_cols = cfg.raster_cols
    if case == "verts_f64":
        vndc = vndc.double()
    elif case == "faces_i32":
        faces = faces.int()
    elif case == "faces_cpu":
        faces = faces.cpu()
    elif case == "strided_verts":
        vndc = torch.zeros((1, 4, 6), device=card)[..., ::2]
    else:
        n_cols = 33
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        R.band_windows(vndc, faces, rid, s, s, cfg.tile_h, n_cols)
    assert dict(_build.LAUNCHES) == before


# --- the geometry kernel (csrc/geometry.cu) against its plain version ---

# path -> (size, batch): the inference microbatch and render512's
_GEO_SHAPES = {"infer224": (224, 128), "render512": (512, 32)}


def _geo_inputs(full_mesh, size, batch, seed=4):
    """(cfg at `size` px, focal scaled, bfm, Coeffs of sample_coeffs
    faces, their basis products) on the card."""
    from facerecon_tpu_torch.ops.geometry import basis_products
    cfg, bfm = full_mesh
    cfg = dataclasses.replace(cfg, image_size=size,
                              focal=cfg.focal * size / cfg.image_size)
    c = split_coeff(torch.as_tensor(sample_coeffs(
        np.random.default_rng(seed), cfg, batch), device=bfm.faces.device),
        cfg)
    return cfg, bfm, c, basis_products(c, bfm)


@pytest.mark.parametrize("path", list(_GEO_SHAPES))
def test_geometry_kernel_equals_plain_at_path_shapes(card, full_mesh, path):
    """The geometry kernel at each path's shape on the full mesh: one
    launch and nothing else; the plain version run on the card gives
    shape and texture bit for bit (the same float32 ops), every other
    field within 1e-6 (the rotation's sums are the same terms in the same
    order; sin and cos are the library's), the landmarks within 1e-6
    relative."""
    from facerecon_tpu_torch.ops.geometry import (vertex_pass,
                                                  vertex_pass_reference)
    size, batch = _GEO_SHAPES[path]
    cfg, bfm, c, parts = _geo_inputs(full_mesh, size, batch)
    before = dict(_build.LAUNCHES)
    got = vertex_pass(parts, c, bfm, cfg)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(geometry=1)
    ref = vertex_pass_reference(parts, c, bfm, cfg)
    for name in ("shape", "texture"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("verts_world", "verts_ndc", "normals", "radiance"):
        err = float((getattr(got, name) - getattr(ref, name)).abs().max())
        assert err <= 1e-6, (name, err)
    assert bool(((got.landmarks2d - ref.landmarks2d).abs()
                 <= 1e-6 * ref.landmarks2d.abs()).all())
    assert float(got.normals.norm(dim=-1).min()) > 0.99


def test_geometry_kernel_only_where_autograd_records_nothing(card,
                                                             full_mesh):
    """coeffs_to_geometry launches the geometry kernel once a call under
    no_grad (the Geometry carries the radiance) and never where the
    coefficients require grad (the eager path, radiance None, gradients
    finite)."""
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
    cfg, bfm, c, _ = _geo_inputs(full_mesh, 224, 4)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        geom = coeffs_to_geometry(c, bfm, cfg)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == _launches(geometry=1)
    assert geom.radiance is not None
    leaf = tuple(t.detach().clone().requires_grad_(True) for t in c)
    before = dict(_build.LAUNCHES)
    geom = coeffs_to_geometry(type(c)(*leaf), bfm, cfg)
    grads = torch.autograd.grad(geom.verts_ndc.sum() + geom.normals.sum(),
                                leaf, allow_unused=True)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before
    assert geom.radiance is None
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("name", ["infer224.b256", "render512.b256"])
def test_geometry_kernel_path_is_correct_end_to_end(card, name):
    """A short run of the benchmark's cell at batch 8 (the cell's
    configuration, its traffic's batch and microbatch cut to 8), through
    the geometry kernel and the record kernel: correct against the plain
    reference under the cell's own limits."""
    import copy
    from perfbench import run, spec
    cell = copy.deepcopy(spec.cell(name))
    cell["traffic"].update(batch=8, microbatch=8)
    before = dict(_build.LAUNCHES)
    r = run.run_cell(cell, 2 ** 31 + 79, 0.5, False, card)
    assert r["correct"], r["compared"]
    for kernel in ("geometry", "records"):
        assert _build.LAUNCHES[kernel] > before[kernel], kernel


@pytest.mark.parametrize("case", ["parts_f64", "parts_strided", "gamma_cols",
                                  "faces_i32", "mean_cpu"])
def test_geometry_wrapper_rejects_what_the_kernel_does_not_take(card,
                                                               full_mesh,
                                                               case):
    """vertex_pass on the card raises, launching nothing, on a wrong
    dtype or device, a non-contiguous product, or coefficient rows whose
    last axis is not contiguous."""
    from facerecon_tpu_torch.ops.geometry import vertex_pass
    cfg, bfm, c, parts = _geo_inputs(full_mesh, 224, 2)
    if case == "parts_f64":
        parts = (parts[0].double(), *parts[1:])
    elif case == "parts_strided":
        parts = (torch.cat([parts[0], parts[0]], dim=1)[:, ::2], *parts[1:])
    elif case == "gamma_cols":
        c = c._replace(gamma=c.gamma.t().contiguous().t())
    elif case == "faces_i32":
        bfm = bfm._replace(faces=bfm.faces.int())
    else:
        bfm = bfm._replace(mean_shape=bfm.mean_shape.cpu())
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        vertex_pass(parts, c, bfm, cfg)
    assert dict(_build.LAUNCHES) == before


# --- the record kernel (csrc/records.cu) against its plain version ---

# path -> (size, batch): the inference microbatch, a single frame, and
# render512's microbatch
_REC_SHAPES = {"infer224": (224, 128), "frame224": (224, 1),
               "render512": (512, 32)}


def _hold_records(vndc, attr, rows, size):
    """pack_render_records on the card, under no_grad: one launch of the
    record kernel and nothing else, and the record bit for bit the plain
    version's, run on the card (int32 bits over all 24 fields and every
    padded row, signed zeros included)."""
    from facerecon_tpu_torch.ops.render import pack_render_records_reference
    pad = R.padded_rows(rows.shape[0])
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = pack_render_records(vndc, attr, rows, size, size, pad)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k == "records") for k in _build.KERNELS}
    ref = pack_render_records_reference(vndc, attr, rows, size, size, pad)
    assert got.shape == ref.shape == (vndc.shape[0], 24, pad)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return got


@pytest.mark.parametrize("path", list(_REC_SHAPES))
def test_record_kernel_equals_plain_at_path_shapes(card, full_mesh, path):
    """The record kernel at each path's shape on the full mesh (70,688
    faces in 83,968 padded rows), on the geometry kernel's vertices and
    radiance: bit for bit the plain version."""
    size, batch = _REC_SHAPES[path]
    cfg, bfm, c, parts = _geo_inputs(full_mesh, size, batch)
    with torch.no_grad():
        geom = coeffs_to_geometry(c, bfm, cfg)
    rec = _hold_records(geom.verts_ndc, geom.radiance, bfm.raster_rows, size)
    f = bfm.raster_rows.shape[0]
    assert bool(rec[:, 9, :f].ne(0).any()) and not bool(rec[:, :, f:].any())


@pytest.mark.parametrize("case", ["raster_rows", "shuffled", "near", "away",
                                  "turned"])
def test_record_kernel_on_kernel_inputs_cases(card, case):
    """On _kernel_inputs' cases (the raster row order with its [0, 0, 0]
    pad rows, a shuffled order, faces 1 from the camera, a face out of
    frame, one turned to show its back): bit for bit the plain
    version."""
    kw = {"near": dict(tz=9.0), "away": dict(away=True),
          "turned": dict(turned=True)}.get(case, {})
    order = "shuffled" if case == "shuffled" else "raster_rows"
    cfg, _, geom, rad, rows, _ = _kernel_geometry(card, order, **kw)
    _hold_records(geom.verts_ndc, rad, rows, cfg.image_size)


def test_record_kernel_on_dead_snapped_and_off_screen_rows(card,
                                                           full_mesh):
    """The binning test's images (5,000 faces collapsed to a point or an
    edge, a 1/16 NDC grid, half off the right edge, wholly off screen) on
    the raster row order: bit for bit the plain version, the dead rows'
    forms the eager ops' signed zeros (both signs occur)."""
    bfm = full_mesh[1]
    vndc = _full_verts(full_mesh, 224, 4, seed=2).clone()
    f = bfm.raster_rows[:5000]
    vndc[0, f[:, 1]] = vndc[0, f[:, 0]]
    vndc[1, :, :2] = torch.round(vndc[1, :, :2] * 16.0) / 16.0
    vndc[2, :, 0] += 1.0
    vndc[3, :, 0] += 10.0
    rad = torch.rand(vndc.shape, generator=torch.Generator().manual_seed(3)
                     ).to(card)
    rec = _hold_records(vndc, rad, bfm.raster_rows, 224)
    forms = rec[0, 9:15, :bfm.raster_rows.shape[0]]
    dead = (forms == 0).all(dim=0)
    assert int(dead.sum()) > 1000
    assert bool(torch.signbit(forms[:, dead]).any())
    assert not bool(torch.signbit(forms[:, dead]).all())


def test_record_kernel_only_where_autograd_records_nothing(card, full_mesh):
    """pack_render_records launches the kernel on the card under no_grad
    and never where its inputs require grad: there it is the eager pack,
    the same record bit for bit, and its gradient reaches the vertices
    and the radiance; a train step launches no record kernel."""
    cfg, bfm, c, _ = _geo_inputs(full_mesh, 224, 2)
    with torch.no_grad():
        geom = coeffs_to_geometry(c, bfm, cfg)
    rows, pad = bfm.raster_rows, R.padded_rows(bfm.raster_rows.shape[0])
    want = _hold_records(geom.verts_ndc, geom.radiance, rows, 224)
    vndc = geom.verts_ndc.clone().requires_grad_(True)
    rad = geom.radiance.clone().requires_grad_(True)
    before = dict(_build.LAUNCHES)
    rec = pack_render_records(vndc, rad, rows, 224, 224, pad)
    gv, gr = torch.autograd.grad(rec[:, :17].sum(), (vndc, rad))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before
    assert torch.equal(rec.detach().view(torch.int32), want.view(torch.int32))
    assert bool(gv.ne(0).any()) and bool(gr.ne(0).any())


@pytest.mark.parametrize("case", ["cpu", "verts_f64", "attr_strided",
                                  "rows_i32", "rows_cpu", "tail_8", "tail_f",
                                  "pad_short"])
def test_record_wrapper_rejects_what_the_kernel_does_not_take(card, case):
    """pack_records on the card raises, launching nothing, on a wrong
    dtype or device, a non-contiguous input, a tail of more than 7 rows
    or of another width than F', or fewer padded rows than F'."""
    from facerecon_tpu_torch.ops.render import pack_records
    vndc = torch.rand((2, 4, 3), device=card)
    attr = torch.rand((2, 4, 3), device=card)
    rows = torch.tensor([[0, 1, 2], [0, 2, 3]], device=card)
    tail, pad = None, 128
    if case == "cpu":
        vndc, attr, rows = vndc.cpu(), attr.cpu(), rows.cpu()
    elif case == "verts_f64":
        vndc = vndc.double()
    elif case == "attr_strided":
        attr = torch.rand((2, 4, 6), device=card)[..., ::2]
    elif case == "rows_i32":
        rows = rows.int()
    elif case == "rows_cpu":
        rows = rows.cpu()
    elif case == "tail_8":
        tail = torch.zeros((8, 2), device=card)
    elif case == "tail_f":
        tail = torch.zeros((6, 3), device=card)
    else:
        pad = 1
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        pack_records(vndc, attr, rows, 64, 64, pad, tail)
    assert dict(_build.LAUNCHES) == before


# --- the contract path at full width against the native oracle ---

def _depth_f64(vndc, faces, ids, px, py, size: int):
    """The exact planar depth of face ids[k] at pixel center (px[k],
    py[k]), in float64 from the float32 vertices: the oracle's screen
    corners, edge functions and blend of the corner depths, unrounded."""
    v = vndc.astype(np.float64)
    x = (v[:, 0] + 1.0) * (size / 2.0)
    y = (1.0 - v[:, 1]) * (size / 2.0)
    f = faces[ids]
    (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = (
        [a[f[:, k]] for k in range(3)] for a in (x, y, v[:, 2]))
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    return (e0 * z0 + e1 * z1 + e2 * z2) / area


@pytest.mark.parametrize("order", ["raster_rows", "identity"])
def test_contract_path_at_224px_meets_the_native_oracle(card, full_mesh,
                                                        order):
    """rasterize_batch (K4, one launch a call) at 224 px on the full mesh,
    seeds 7 and 8 (batch 4, sample_coeffs scale 0.3), in the asset's
    raster row order (7 column tiles) and in the identity order (one
    224-px column), against the native oracle with
    tests/test_tpu_parity.py's bar: tri_id mismatches at most 5e-5 of
    the covered pixels, each a depth tie (|dz| < 1e-3) on a pixel both
    cover; where tri_id agrees, bary within 5e-5 and zbuf within 1e-4
    relative of the oracle's, and within 2e-6 relative of the exact
    float64 depth (224-px readings 8.8e-6, 1.5e-5 and 4.5e-7)."""
    from facerecon_tpu_torch.utils import native_oracle
    native_oracle.require()
    cfg, bfm = full_mesh
    s = cfg.image_size
    faces = bfm.faces.cpu().numpy()
    okw = dict(n_cols=1)
    if order == "raster_rows":
        okw = dict(n_cols=cfg.raster_cols, row_faces=bfm.raster_rows,
                   row_id=bfm.raster_row_id)
    jj, ii = np.meshgrid(np.arange(s) + 0.5, np.arange(s) + 0.5)
    mism = cov = bad_depth = 0
    bary_err = z_rel = z_exact = 0.0
    for seed in (7, 8):
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(seed), cfg, 4, scale=0.3), device=card),
            cfg)
        vndc = coeffs_to_geometry(c, bfm, cfg).verts_ndc
        before = _build.LAUNCHES["raster_pos"]
        tid_t, bary_t, z_t = (t.cpu().numpy() for t in R.rasterize_batch(
            vndc, bfm.faces, height=s, width=s, cfg=cfg, **okw))
        assert _build.LAUNCHES["raster_pos"] == before + 1
        vndc = vndc.cpu().numpy()
        for b in range(4):
            tid_o, bary_o, z_o = native_oracle.rasterize(vndc[b], faces, s, s)
            covered = (tid_o >= 0) | (tid_t[b] >= 0)
            cov += int(covered.sum())
            d = covered & (tid_t[b] != tid_o)
            mism += int(d.sum())
            both = (tid_o >= 0) & (tid_t[b] >= 0)
            tie = both & (np.abs(np.where(both, z_o, 0.0)
                                 - np.where(both, z_t[b], 0.0)) < 1e-3)
            bad_depth += int((d & ~tie).sum())
            same = both & ~d
            bary_err = max(bary_err, float(np.abs(
                bary_t[b][same] - bary_o[same]).max()))
            zt, zo = z_t[b][same], z_o[same]
            z_rel = max(z_rel, float((np.abs(zt - zo) / zo).max()))
            exact = _depth_f64(vndc[b], faces, tid_o[same], jj[same],
                               ii[same], s)
            z_exact = max(z_exact, float((np.abs(zt - exact) / exact).max()))
    assert cov > 0 and mism <= 5e-5 * cov and bad_depth == 0
    assert bary_err <= 5e-5 and z_rel <= 1e-4 and z_exact <= 2e-6


# --- GaussianAvatars' splatting kernels (csrc/gaussians.cu) ---

_GAUSS = ("gauss_prep", "gauss_emit", "gauss_ranges", "gauss_blend")


@pytest.fixture(scope="module")
def gavatar_kind():
    """The cell's kind set up on the card: its program config, asset pack
    and 256 frames' codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from perfbench import spec
    from perfbench.kinds import gavatar_render as GR
    kind = GR.Kind(spec.cell("gavatar802.b256"), 2 ** 31 + 41,
                   torch.device("cuda"))
    kind.setup()
    return kind


def _close_ulp(got, ref, ulps=2):
    """Equal, or within `ulps` float32 ulps of the larger magnitude."""
    if got.dtype != torch.float32:
        return torch.equal(got, ref)
    tol = ulps * torch.finfo(torch.float32).eps * torch.maximum(
        got.abs(), ref.abs())
    return bool(((got - ref).abs() <= tol).all())


def _hold_splat(kind, codes):
    """The four kernels on `codes` against their plain versions run on the
    card, each launched once: the preprocess within 2 ulp (each field),
    the rest bit for bit. Returns the pair count."""
    from facerecon_tpu_torch.ops import gavatar as G
    cfg, av = kind.cfg, kind.avatar
    h, w = cfg.render_hw
    c = split_coeff(codes, cfg)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        verts = G.posed_vertices(c.shape, c.exp, c.pose, c.trans, av)
        cams = G.cameras(c.view, c.focal)
        sp = G.preprocess(verts, cams, av, h, w)
        ref = G.preprocess_reference(verts, cams, av, h, w)
        for name in sp._fields:
            assert _close_ulp(getattr(sp, name), getattr(ref, name)), name
        off = torch.cumsum(sp.count.reshape(-1), 0)
        n = int(off[-1])
        keys, ids = G.emit_pairs(sp, off, n, h, w)
        rk, ri = G.emit_pairs_reference(sp, off, n, h, w)
        assert torch.equal(keys, rk) and torch.equal(ids, ri)
        skeys, order = G.sort_pairs(keys)
        tx, ty = G.tile_grid(h, w)
        n_t = codes.shape[0] * tx * ty
        ranges, sids = G.tile_ranges(skeys, order, ids, n_t)
        rr, rs = G.tile_ranges_reference(skeys, order, ids, n_t)
        assert torch.equal(ranges, rr) and torch.equal(sids, rs)
        image, alpha = G.blend(ranges, sids, sp.rec, h, w, kind.background)
        ri, ra = G.blend_reference(ranges, sids, sp.rec, h, w,
                                   kind.background)
        assert torch.equal(image, ri) and torch.equal(alpha, ra)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k in _GAUSS and (n > 0 or k == "gauss_prep"
                                                or k == "gauss_blend"))
                        for k in _build.KERNELS}
    return n


def test_gaussian_kernels_equal_plain_at_the_cell_size(card, gavatar_kind):
    """The cell's first 4 frames: the kernels against their plain
    versions (_hold_splat), with pairs to blend."""
    n = _hold_splat(gavatar_kind, gavatar_kind.codes[:4])
    assert n > 4 * 100_000


def test_gaussian_kernels_on_culled_and_empty_frames(card, gavatar_kind):
    """Frame 0's camera 0.25 m from the head (Gaussians behind the near
    plane and off screen), frame 1's 1 m in front of it looking away
    (every Gaussian behind the camera), frame 2 as drawn: the kernels still equal their plain
    versions."""
    codes = gavatar_kind.codes[:3].clone()
    view = codes[:, 418:430].view(3, 3, 4)
    view[0, 2, 3] = 0.25
    view[1] = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -1]],
                           device=codes.device)
    _hold_splat(gavatar_kind, codes)


def test_avatar_render_launches_each_kernel_once(card, gavatar_kind):
    """render_coeffs on 8 frames: each of the four kernels once, no other
    kernel of the port, finite image and alpha in [0, 1]."""
    from facerecon_tpu_torch.ops.render import render_coeffs
    kind = gavatar_kind
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        out = render_coeffs(split_coeff(kind.codes[:8], kind.cfg),
                            kind.avatar, kind.cfg, background=kind.background,
                            inference=True)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k in _GAUSS) for k in _build.KERNELS}
    assert bool(torch.isfinite(out.image).all())
    assert 0.0 <= float(out.mask.min()) and float(out.mask.max()) <= 1.0


@pytest.mark.parametrize("case", ["cams_f64", "verts_cpu", "rec_strided",
                                  "ranges_i64"])
def test_gaussian_wrappers_reject_what_the_kernels_do_not_take(
        card, gavatar_kind, case):
    from facerecon_tpu_torch.ops import gavatar as G
    kind = gavatar_kind
    h, w = kind.cfg.render_hw
    c = split_coeff(kind.codes[:2], kind.cfg)
    with torch.no_grad():
        verts = G.posed_vertices(c.shape, c.exp, c.pose, c.trans,
                                 kind.avatar)
        cams = G.cameras(c.view, c.focal)
        with pytest.raises(ValueError):
            if case == "cams_f64":
                G.preprocess(verts, cams.double(), kind.avatar, h, w)
            elif case == "verts_cpu":
                G.preprocess(verts.cpu(), cams, kind.avatar, h, w)
            else:
                sp = G.preprocess(verts, cams, kind.avatar, h, w)
                tx, ty = G.tile_grid(h, w)
                ranges = torch.zeros((2 * tx * ty, 2), dtype=torch.int32,
                                     device=card)
                sids = torch.zeros(0, dtype=torch.int32, device=card)
                if case == "rec_strided":
                    rec = torch.zeros((2, sp.rec.shape[1], 18),
                                      device=card)[..., ::2]
                    G.blend(ranges, sids, rec, h, w, kind.background)
                else:
                    G.blend(ranges.long(), sids, sp.rec, h, w,
                            kind.background)


def test_the_avatar_cell_is_correct_at_batch_8(card):
    """A short run of gavatar802.b256 at batch 8 in microbatches of 4
    through the four kernels: correct under the cell's own limits."""
    import copy
    from perfbench import run, spec
    cell = copy.deepcopy(spec.cell("gavatar802.b256"))
    cell["traffic"].update(batch=8, microbatch=4)
    before = dict(_build.LAUNCHES)
    r = run.run_cell(cell, 2 ** 31 + 83, 0.5, False, card)
    assert r["correct"], r["compared"]
    for kernel in _GAUSS:
        assert _build.LAUNCHES[kernel] > before[kernel], kernel
