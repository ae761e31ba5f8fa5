"""The port's render-chain and rasterizer benchmarks
(facerecon_tpu_torch/render_bench.py and raster_bench.py) on the CPU,
against the reference's benchmarks/render_bench.py and raster_bench.py,
at tiny_config():

  - render_bench's calls on the reference's coefficients
    (sample_coeffs(default_rng(0))) against the reference's own
    computation: fwd_one's image mean, bwd_one's loss + mean gradient
    (total_loss with no landmarks, jax.value_and_grad) within 1e-4
    relative, and the gradient to the coefficients within 1e-3 of its
    max (tests/test_torch_train_step.py's bars: on the CPU the reference
    renders through rasterize_tiled, the port through the plain versions
    of its kernels);
  - a chain feeds each call the previous call's scalar as the
    reference's scan does, and sums the calls' scalars;
  - raster_bench's geometry is the reference's (1e-6), and its pos_fn's
    tri_id equals the reference's rasterize_positions (Pallas in
    interpret mode) exactly, with and without culling;
  - both mains at the smallest sizes with --device cpu print the
    reference's lines (with --check: a mismatch of 0), their flags and
    defaults are the reference's (read from its source) plus --device,
    default cuda, which raises on a host with no card;
  - the kernels' wrappers are called (1 + 3 reps) x inner times for a
    render_bench run (K2, and K3 with --bwd) and 1 + 3 reps times for a
    raster_bench run (K4), plus twice for --check (the device's call,
    which launches K4 on a card, and the CPU copy's). On the CPU the
    wrappers take their plain versions, which count no launch in
    _build.LAUNCHES, so the calls are counted here and the launches by
    tests/test_torch_cuda.py.
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu.ops.geometry import coeffs_to_geometry as ref_geometry
from facerecon_tpu.ops.geometry import device_bfm as ref_device_bfm
from facerecon_tpu.ops.losses import total_loss as ref_total_loss
from facerecon_tpu.ops.render import render_coeffs as ref_render_coeffs
from facerecon_tpu.utils.coeffs import split_coeff as ref_split_coeff

from facerecon_tpu_torch import raster_bench as RB
from facerecon_tpu_torch import render_bench as RDB
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import rasterize as R

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
BATCH = 2


def _reference_defaults(name):
    """--flag -> default of each add_argument call in the reference's
    benchmarks/<name>: its `default`, else False for a store_true flag."""
    tree = ast.parse((ROOT / "benchmarks" / name).read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            out[node.args[0].value] = kw.get(
                "default", False if kw.get("action") == "store_true"
                else None)
    return out


@pytest.mark.parametrize("mod,name", [(RDB, "render_bench.py"),
                                      (RB, "raster_bench.py")])
def test_flags_default_to_the_reference(mod, name):
    want = _reference_defaults(name)
    args = vars(mod.parse_args([]))
    assert {f"--{k}": v for k, v in args.items() if k != "device"} == want
    assert args["device"] == "cuda"


def test_render_defaults_are_the_reference_geometry():
    """tile_h 2 up to 256 px, then 1; the focal scales with the size and
    the default config keeps its 7 columns."""
    assert [RDB.default_tile_h(s) for s in (224, 256, 257, 512)] == \
        [2, 2, 1, 1]
    cfg = RDB.setup(112, 1, device="cpu", cfg=tiny_config())[0]
    assert (cfg.image_size, cfg.tile_h) == (112, 2)
    assert cfg.focal == pytest.approx(1015.0 * 112 / 224)


@pytest.fixture(scope="module")
def render_case(cfg, assets):
    """The port's setup at tiny_config()'s size and tiling, and the
    reference's fwd_one and value_and_grad of its loss on the same
    coefficients: (port (cfg, bfm, coeffs, target), reference (mean,
    loss, gradient))."""
    port = RDB.setup(cfg.image_size, BATCH, cfg.tile_h, "cpu",
                     cfg=tiny_config(), assets=assets)
    tcfg, _, coeffs, target = port
    assert (tcfg.image_size, tcfg.focal, tcfg.tile_h) == (
        cfg.image_size, cfg.focal, cfg.tile_h)
    bfm = ref_device_bfm(assets)
    cv = jnp.asarray(coeffs.numpy())
    tgt = jnp.asarray(target.numpy())

    def loss_fn(c):
        out = ref_render_coeffs(ref_split_coeff(c, cfg), bfm, cfg,
                                background=tgt)
        return ref_total_loss(out, ref_split_coeff(c, cfg), tgt, None, bfm,
                              cfg)[0]
    mean = jnp.mean(ref_render_coeffs(ref_split_coeff(cv, cfg), bfm,
                                      cfg).image)
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(cv)
    return port, (float(mean), float(loss), np.asarray(grad))


def test_render_fwd_call_matches_reference(render_case):
    (tcfg, bfm, coeffs, target), (mean, _, _) = render_case
    got = RDB.make_one(tcfg, bfm, target, bwd=False)(coeffs)
    assert got.shape == () and not got.requires_grad
    assert abs(float(got) - mean) <= 1e-4 * abs(mean)


def test_render_bwd_call_matches_reference(render_case):
    (tcfg, bfm, coeffs, target), (_, loss, grad) = render_case
    got_loss, got_grad = RDB.value_and_grad(tcfg, bfm, target, coeffs)
    assert abs(float(got_loss) - loss) <= 1e-4 * abs(loss)
    assert got_grad.shape == coeffs.shape
    assert np.abs(got_grad.numpy() - grad).max() <= 1e-3 * np.abs(grad).max()
    scalar = RDB.make_one(tcfg, bfm, target, bwd=True)(coeffs)
    want = loss + float(grad.mean())
    assert abs(float(scalar) - want) <= 1e-4 * abs(want)
    assert not scalar.requires_grad


def test_chain_feeds_each_call_the_previous_scalar():
    """The reference's scan: call k sees cv * (1 + carry * 1e-30), carry
    the previous call's scalar * 1e-30 (0 first); the sum of the
    scalars."""
    seen = []

    def one(cv):
        seen.append(cv)
        return cv.sum() * 1e31
    cv = torch.tensor([[1.5, -2.0]])
    total = RDB.chain(one, cv, inner=3)
    assert torch.equal(seen[0], cv)
    for k in (1, 2):
        carry = seen[k - 1].sum() * 1e31 * 1e-30
        assert torch.equal(seen[k], cv * (1.0 + carry * 1e-30))
    assert float(total) == pytest.approx(float(sum(
        s.sum() * 1e31 for s in seen)), rel=1e-6)


def _count_calls(monkeypatch, *names):
    """Counts the calls of ops.rasterize's named wrappers, which the
    paths reach by module lookup, passing each call on."""
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    for n in names:
        monkeypatch.setattr(R, n, wrap(n, getattr(R, n)))
    return calls


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_render_main_prints_the_reference_lines(monkeypatch, capsys, cfg,
                                                bwd):
    """main on the CPU with default_config() swapped for tiny_config() at
    its own size and tiling: the reference's lines, finite sums, and K2's
    wrapper (and K3's with --bwd) called (1 + 3 reps) x inner times."""
    monkeypatch.setattr(RDB, "default_config",
                        lambda **over: tiny_config(**over))
    calls = _count_calls(monkeypatch, "select_windows", "select_grad",
                         "shade_windows", "pos_windows")
    before = dict(_build.LAUNCHES)
    reps, inner = 1, 2
    res = RDB.main(["--batch", "1", "--reps", str(reps), "--inner",
                    str(inner), "--size", str(cfg.image_size), "--tileh",
                    str(cfg.tile_h), "--device", "cpu"]
                   + (["--bwd"] if bwd else []))
    n = (1 + 3 * reps) * inner
    assert calls == {"select_windows": n, "select_grad": n if bwd else 0,
                     "shade_windows": 0, "pos_windows": 0}
    assert dict(_build.LAUNCHES) == before       # the plain versions
    assert np.isfinite(res["first_sum"]) and np.isfinite(res["sum"])
    # every chain sees the same coefficients: the sums agree
    assert res["sum"] == pytest.approx(res["first_sum"], rel=1e-6)
    assert [r[0] for r in res["runs"]] == [reps, 2 * reps]
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"compile\+first: \d+\.\ds", lines[0])
    tag = "fwd\\+bwd" if bwd else "fwd"
    for line, r in zip(lines[1:], (reps, 2 * reps)):
        assert re.fullmatch(rf"{tag} chain reps={r}: \d+\.\d ms/1 -> \d+ "
                            rf"faces/s", line), line
    assert len(lines) == 3


@pytest.fixture(scope="module")
def raster_geometry(cfg, assets):
    """raster_bench's vertices at tiny_config() and the faces."""
    return RB.geometry(BATCH, "cpu", tiny_config(), assets)


def test_raster_geometry_is_the_reference(cfg, assets, raster_geometry):
    vndc, faces = raster_geometry
    from facerecon_tpu.data.synthetic import sample_coeffs
    want = ref_geometry(ref_split_coeff(jnp.asarray(sample_coeffs(
        np.random.default_rng(0), cfg, BATCH)), cfg), ref_device_bfm(assets),
        cfg).verts_ndc
    np.testing.assert_allclose(vndc.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(faces.numpy(), assets.faces)


@pytest.mark.parametrize("cull", [False, True], ids=["no_cull", "cull"])
def test_pos_fn_matches_reference(cfg, assets, raster_geometry, cull):
    """pos_fn at tile_h 8, one column, the asset's face order, against the
    reference's pos_fn (rasterize_positions, Pallas in interpret mode):
    tri_id exactly equal, and the sum of it."""
    vndc, faces = raster_geometry
    s = cfg.image_size
    tid, chk = RB.make_pos_fn(s, 8, cull)(vndc, faces)
    want = RP.rasterize_positions(
        jnp.asarray(vndc.numpy()), jnp.asarray(assets.faces), height=s,
        width=s, tile_h=8, cull_backfaces=cull)[0]
    np.testing.assert_array_equal(tid.numpy(), np.asarray(want))
    assert int(chk) == int(np.asarray(want, np.int64).sum())
    assert (tid >= 0).float().mean() > 0.05                # a face is drawn


def test_culling_drops_faces(cfg, raster_geometry):
    """--cull changes what is drawn on the reference's coefficients: some
    pixel's winner is a back face without it."""
    vndc, faces = raster_geometry
    s = cfg.image_size
    a = RB.make_pos_fn(s, 8, False)(vndc, faces)[0]
    b = RB.make_pos_fn(s, 8, True)(vndc, faces)[0]
    assert (a != b).any() and ((b >= 0) <= (a >= 0)).all()


def test_raster_check_reports_no_mismatch(cfg, raster_geometry):
    vndc, faces = raster_geometry
    assert RB.check(vndc, faces, cfg.image_size) == 0


def test_raster_main_prints_the_reference_lines(monkeypatch, capsys):
    """main at the smallest sizes on the CPU (default_config's asset, its
    224-px vertices rasterized at 32 px), with --check and --cull: the
    reference's lines, a mismatch of 0, and the wrappers called 1 + 3
    reps times, and twice for --check (the device's call and the CPU
    copy's; on the card only the first launches)."""
    calls = _count_calls(monkeypatch, "pos_windows", "select_windows",
                         "shade_windows")
    res = RB.main(["--batch", "1", "--reps", "1", "--size", "32", "--check",
                   "--cull", "--device", "cpu"])
    assert res["mismatch"] == 0
    assert calls == {"pos_windows": 1 + 3 + 2, "select_windows": 0,
                     "shade_windows": 0}
    assert res["out"].shape == (1, 32, 32)
    assert res["chk"] == int(res["out"].sum())
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"geom ready \(\d+\.\ds\)", lines[0])
    assert lines[1] == "mismatch vs plain: 0 / 1024"
    assert re.fullmatch(rf"kernel compile\+1st \(\d+\.\ds\) chk={res['chk']}",
                        lines[2])
    for line, r in zip(lines[3:], (1, 2)):
        assert re.fullmatch(rf"raster reps={r}: \d+\.\d ms/1 -> \d+ faces/s",
                            line), line
    assert len(lines) == 5


@pytest.mark.parametrize("mod", [RDB, RB], ids=["render", "raster"])
def test_main_needs_a_card_unless_asked_for_the_cpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
