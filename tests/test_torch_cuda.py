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
card meets the CPU suite's bars against the oracle.
"""

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


def _kernel_inputs(card, order, batch=3):
    """Records and windows at tiny_config(n_vertices=6000): 11.7k faces,
    so a shuffled order overflows the 64-chunk column masks."""
    cfg = tiny_config(n_vertices=6000)
    assets = synthetic_bfm(cfg, 0)
    bfm = device_bfm(assets, card)
    c = split_coeff(torch.as_tensor(
        sample_coeffs(np.random.default_rng(5), cfg, batch), device=card),
        cfg)
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
                         cfg.raster_cols)
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
    # one block holds tile_h * col_width pixels: at most 1024 threads; the
    # plain version on the CPU takes the same band
    tall = R.band_windows(vndc, faces, rid, s, s, 64, 1)
    tkw = dict(height=s, width=s, tile_h=64, n_cols=1, n_faces=2)
    with pytest.raises(ValueError, match="1024"):
        R.shade_windows(tall, rec, **tkw)
    with pytest.raises(ValueError, match="1024"):
        R.pos_windows(tall, **tkw)
    tid, _, _ = R.pos_windows(R.Windows(*(t.cpu() for t in tall)), **tkw)
    assert tid.shape == (1, s, s) and not bool((tid >= 0).any())


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


def test_ctz_walk_kernel_matches_plain_version(card):
    from facerecon_tpu_torch.ops import probes
    rng = np.random.default_rng(0)
    setup = torch.as_tensor(rng.standard_normal(probes.SETUP_SHAPE),
                            dtype=torch.float32, device=card)
    words = np.array([0, 1 << 31, 0xFFFFFFFF, 1, 0x0F0F0F0F],
                     np.uint32).view(np.int32)
    mask = torch.as_tensor(np.concatenate(
        [words, rng.integers(0, 2 ** 32, 59, dtype=np.uint64).astype(
            np.uint32).view(np.int32)]), device=card)
    before = _build.LAUNCHES["ctz_walk"]
    got = probes.ctz_walk(mask, setup)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ctz_walk"] == before + 1
    ref = probes.ctz_walk_reference(mask, setup)
    assert bool(torch.isfinite(ref).any())
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
