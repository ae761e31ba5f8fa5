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
--bwd), and 1 + 3 reps K4 plus one for --check. The probes' twins
(facerecon_tpu_torch/benchmarks/): the s2d stem and the native 7x7/s2
stem agree on the card (f32 within 1e-5 x max |ref|, bf16 within 2^-6 x
max |ref|: each output rounded twice to bf16), the two pool forms differ
as on the CPU, and the scatter-min on the card equals the CPU's; none
of them launches a port kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from facerecon_tpu_torch import oracle
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
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


def _kernel_inputs(card, order, batch=3, tile_h=None, n_cols=None,
                   tz=None, away=False, turned=False, cull=False):
    """Records and windows at tiny_config(n_vertices=6000): 11.7k faces,
    so a shuffled order overflows the 64-chunk column masks. tile_h and
    n_cols override the config's bands; tz sets every face's depth
    translation (9.0: 1 from the camera, rows of several hundred px);
    away moves the last image's face out of frame; turned turns it 2.5
    rad about the vertical axis (mostly back faces show); cull bins with
    cull_backfaces."""
    cfg = tiny_config(n_vertices=6000)
    cfg = dataclasses.replace(cfg, tile_h=tile_h or cfg.tile_h,
                              raster_cols=n_cols or cfg.raster_cols)
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
    assert l_card == {"raster_shade": 0, "raster_select": 1,
                      "select_grad": 1, "raster_pos": 0, "ctz_walk": 0}
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
    K3 launch once each on the card (and K2 once more for the final
    loss), never on the CPU."""
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
    assert n_card == {"raster_shade": 0, "raster_select": 2,
                      "select_grad": 1, "raster_pos": 0, "ctz_walk": 0}
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
    schedule after one step) restores into a CPU trainer bit for bit."""
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
    cpu = make_train_pipeline(cfg, assets, device="cpu", depth=18, seed=5)
    cpu_state = init_state(cpu, total_steps=20, seed=5)
    restore_state(mgr, cpu, cpu_state)
    assert cpu_state.step == 1
    for name, t in pipe.model.state_dict().items():
        got = cpu.model.state_dict()[name]
        assert got.device.type == "cpu" and torch.equal(got, t.cpu()), name
    for (_, a), (_, b) in zip(
            sorted(state.optimizer.state_dict()["state"].items()),
            sorted(cpu_state.optimizer.state_dict()["state"].items())):
        for k in a:
            assert torch.equal(a[k].cpu(), b[k].cpu()), k
    assert (cpu_state.scheduler.state_dict()
            == state.scheduler.state_dict())
    assert (cpu_state.optimizer.param_groups[0]["lr"]
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
    assert launched == {"raster_shade": 0, "raster_select": 3,
                        "select_grad": 3, "raster_pos": 0, "ctz_walk": 0}
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
        want = {"raster_shade": (1 + 2 * 2) * 2}
        assert not cv.any()                    # the reference's zero head
    elif mode == "train":
        payload, parts = bench.train(batch=4, reps=2, chunk=2, device=card)
        want = {"raster_select": (1 + 2) * 2, "select_grad": (1 + 2) * 2}
        out = torch.stack(list(parts.values()))
    else:
        payload, out = bench.render512(batch=8, micro=4, reps=2,
                                       device=card)
        want = {"raster_shade": (1 + 2) * 2}
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: want.get(k, 0) for k in launched}
    assert bool(torch.isfinite(out).all())
    assert list(payload) == ["metric", "value", "unit", "vs_baseline"]
    assert payload["value"] > 0 and payload["vs_baseline"] is None


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
    assert launched == {"raster_shade": 0, "raster_select": 1,
                        "select_grad": 0, "raster_pos": 0, "ctz_walk": 0}
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
    K2 launched 1 + 2 times and nothing else; the trace holds exactly 2
    K2 device events (the profiler records the ctypes-launched kernels)
    and no other kernel of the port."""
    from facerecon_tpu_torch import profile_trace
    before = dict(_build.LAUNCHES)
    path, _ = profile_trace.trace(str(tmp_path), batch=2, steps=2,
                                  device=card, cfg=tiny_config())
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {"raster_shade": 0, "raster_select": 3,
                        "select_grad": 0, "raster_pos": 0, "ctz_walk": 0}
    s = profile_trace.summarize(profile_trace.load_events(path))
    assert s["kernels"] == {"raster_shade": 0, "raster_select": 2,
                            "select_grad": 0, "raster_pos": 0,
                            "ctz_walk": 0}
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
    assert launched == {"raster_shade": 0, "raster_select": 1,
                        "select_grad": 1, "raster_pos": 0, "ctz_walk": 0}
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
    --bwd; raster_bench 1 + 3 reps K4 launches and one more for --check,
    whose mismatch is 0; nothing else."""
    from facerecon_tpu_torch import raster_bench, render_bench
    mod = raster_bench if twin == "raster" else render_bench
    monkeypatch.setattr(mod, "default_config",
                        lambda **over: tiny_config(**over))
    before = dict(_build.LAUNCHES)
    if twin == "raster":
        res = raster_bench.main(["--batch", "2", "--reps", "1", "--size",
                                 "64", "--check"])
        want = {"raster_pos": 1 + 3 + 1}
        assert res["mismatch"] == 0
    else:
        bwd = twin == "render_bwd"
        res = render_bench.main(["--batch", "2", "--reps", "1", "--inner",
                                 "2", "--size", "64", "--tileh", "2"]
                                + (["--bwd"] if bwd else []))
        n = (1 + 3) * 2
        want = {"raster_select": n, "select_grad": n if bwd else 0}
        assert np.isfinite(res["sum"])
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: want.get(k, 0) for k in launched}


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
    assert launched == {"raster_shade": 0, "raster_select": 0,
                        "select_grad": 0, "raster_pos": 0, "ctz_walk": 1}
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
