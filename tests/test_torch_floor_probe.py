"""The K5 and K6 probes' twins (facerecon_tpu_torch/benchmarks/floor_probe.py
and ctzloop_probe.py) and the variant builds they ask for, on the CPU:

  - floor_probe's windows and masks at 64 px, batch 2, TILEH 2, NCOLS 2
    equal the reference's RP._band_windows on the same numpy inputs
    (exactly; the setup within 1e-6, as tests/test_torch_geometry.py
    holds it), and FLOOR_MASK=ones makes every word -1 in both;
  - its real-mask call for each FLOOR_KMODE (the plain versions on the
    CPU) equals the port's *_windows_reference path exactly;
  - ops/_build.library_path differs by `defines`, ignores their order and
    repeats, and without them is the hash of the source, the headers and
    the flags alone, as before variants existed;
  - every ablation macro and CTZ_UNROLLED is a compile-time switch
    (#ifdef / #ifndef) in csrc/, and none is among the default flags;
  - an unknown RP_ABLATE name raises, `sel` in pos mode raises, and
    RP_ABLATE with --device cpu raises (the plain versions have no
    phases): RP_ABLATE never silently does nothing;
  - each twin's main prints the reference's lines (floor_probe: `inputs
    ready`, `compile Ns`, the timed line; ctzloop_probe: the eight
    `live=.. looped=..` lines in order) with --device cpu, and without
    --device raises on a host with no card;
  - ctzloop_probe's masks are the reference's draws from default_rng(0),
    and both walks give the plain version's values on the CPU.
"""

import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecon_tpu.ops import rasterize_pallas as RP
from facerecon_tpu_torch.benchmarks import ctzloop_probe as CTZ
from facerecon_tpu_torch.benchmarks import floor_probe as FP
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import probes
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.utils.bfm import synthetic_bfm

torch.set_num_threads(2)
SIZE, BATCH, TILE_H, N_COLS = 64, 2, 2, 2
MACROS = sorted(FP.ABLATE.values()) + list(CTZ.UNROLLED)


@pytest.fixture(scope="module")
def assets():
    """default_config's mesh at 64 px, as the twin builds it."""
    return synthetic_bfm(default_config(image_size=SIZE,
                                        focal=1015.0 * SIZE / 224.0,
                                        tile_h=TILE_H), seed=0)


@pytest.fixture(scope="module")
def floor(assets):
    """The twin's geometry and produce at the tests' size: (verts_ndc,
    raster rows, their ids, Windows, records, n_faces)."""
    vndc, rad, rows, rid, n_faces = FP.geometry(SIZE, BATCH, TILE_H, "cpu",
                                                assets=assets)
    win, rec = FP.produce(vndc, rad, rows, rid, SIZE, TILE_H, N_COLS)
    return vndc, rows, rid, win, rec, n_faces


def test_windows_and_masks_match_reference(floor):
    vndc, rows, rid, win, _, _ = floor
    (blo, bn), cmask, setup = RP._band_windows(
        jnp.asarray(vndc.numpy()), jnp.asarray(rows.numpy()),
        jnp.asarray(rid.numpy()), SIZE, SIZE, TILE_H, N_COLS, False)
    np.testing.assert_array_equal(win.blo.numpy(), np.asarray(blo))
    np.testing.assert_array_equal(win.bn.numpy(), np.asarray(bn))
    np.testing.assert_array_equal(win.cmask.numpy(), np.asarray(cmask))
    np.testing.assert_allclose(win.setup.numpy(), np.asarray(setup),
                               rtol=0, atol=1e-6)
    assert int(win.bn.max()) > 0 and bool((win.cmask != 0).any())
    ones = FP.saturate(win).cmask.numpy()
    ref_ones = np.asarray(jnp.full_like(cmask, -1))
    assert ones.shape == ref_ones.shape and (ones == -1).all()
    np.testing.assert_array_equal(ones, ref_ones)


@pytest.mark.parametrize("mode", ["select", "shade", "pos"])
def test_real_mask_call_equals_plain_path(floor, mode):
    _, _, _, win, rec, n_faces = floor
    got = FP.call(mode, win, rec, size=SIZE, tile_h=TILE_H, n_cols=N_COLS,
                  n_faces=n_faces)
    kw = dict(height=SIZE, width=SIZE, tile_h=TILE_H, n_cols=N_COLS,
              n_faces=n_faces)
    ref = {"select": lambda: R.select_windows_reference(win, rec, **kw),
           "shade": lambda: R.shade_windows_reference(win, rec, **kw),
           "pos": lambda: R.pos_windows_reference(win, **kw)}[mode]()
    assert float((ref[0] >= 0).float().mean()) > 0.1
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_by_defines(name):
    base = _build.library_path(name)
    digest = hashlib.sha256((_build.CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_build.NVCC_FLAGS).encode())
    assert base.name == f"lib{name}-{digest.hexdigest()[:16]}.so"
    assert _build.library_path(name, ()) == base
    ab = _build.library_path(name, ("RP_ABLATE_EVAL", "RP_ABLATE_DMA"))
    assert ab == _build.library_path(name, ("RP_ABLATE_DMA",
                                            "RP_ABLATE_EVAL",
                                            "RP_ABLATE_DMA"))
    one = _build.library_path(name, ("RP_ABLATE_DMA",))
    assert len({base, ab, one}) == 3 and ab.parent == base.parent
    with pytest.raises(ValueError):
        _build.library_path(name, ("-DRP_ABLATE_DMA",))


@pytest.mark.parametrize("macro", MACROS)
def test_macro_is_a_switch_in_csrc_not_a_default_flag(macro):
    text = "\n".join(p.read_text() for p in sorted(
        _build.CSRC.glob("*.cu*")))
    assert re.search(rf"^#if(n?def| !?defined\()\s*{macro}\b", text, re.M)
    assert not any(macro in flag for flag in _build.NVCC_FLAGS)


def test_ablation_names():
    assert FP.ablation("", "select") == ()
    assert FP.ablation("sel,eval,dma,pack", "shade") == (
        "RP_ABLATE_DMA", "RP_ABLATE_EVAL", "RP_ABLATE_PACK", "RP_ABLATE_SEL")
    assert FP.ablation(" cull , merge ", "pos") == ("RP_ABLATE_CULL",
                                                     "RP_ABLATE_MERGE")
    with pytest.raises(ValueError, match="unknown"):
        FP.ablation("eval,dmaa", "select")
    with pytest.raises(ValueError, match="no select"):
        FP.ablation("sel,eval", "pos")
    with pytest.raises(ValueError):
        FP.kernel("posit")


@pytest.mark.parametrize("setting,match", [("bogus", "unknown"),
                                           ("eval", "needs --device cuda"),
                                           ("sel,eval,dma,pack",
                                            "needs --device cuda")])
def test_rp_ablate_never_silently_does_nothing(monkeypatch, setting, match):
    monkeypatch.setenv("RP_ABLATE", setting)
    with pytest.raises(ValueError, match=match):
        FP.main(["--device", "cpu"])


def test_plain_call_refuses_a_variant(floor):
    _, _, _, win, rec, n_faces = floor
    with pytest.raises(ValueError, match="needs the card"):
        FP.call("select", win, rec, size=SIZE, tile_h=TILE_H, n_cols=N_COLS,
                n_faces=n_faces, defines=("RP_ABLATE_EVAL",))
    outs = FP.outputs("pos", BATCH, SIZE, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FP.launch("pos", win, rec, outs, size=SIZE, tile_h=TILE_H,
                  n_cols=N_COLS, n_faces=n_faces)


def test_floor_main_prints_the_reference_lines(monkeypatch, capsys, assets):
    for k, v in dict(SIZE=SIZE, BATCH=BATCH, TILEH=TILE_H, NCOLS=N_COLS,
                     FLOOR_KMODE="shade", RP_ABLATE="").items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(FP, "synthetic_bfm", lambda cfg, seed: assets)
    monkeypatch.setattr(FP, "INNER", 1)
    monkeypatch.setattr(FP, "REPS", 1)
    case = FP.main(["--device", "cpu"])
    assert case.tag == "raster_shade_kernel"
    assert np.isfinite([case.seconds, case.first, case.last]).all()
    out = capsys.readouterr().out.splitlines()
    rows = R.padded_rows(assets.raster_rows.shape[0])
    assert out[0] == f"inputs ready ({BATCH}, 16, {rows}) ({BATCH}, 24, {rows})"
    assert re.fullmatch(r"compile \d+s", out[1])
    assert re.fullmatch(r"raster_shade_kernel alone \(RP_ABLATE=\): +\d+\.\d "
                        rf"ms/{BATCH}", out[2])


def test_ctzloop_inputs_are_the_reference_draws():
    setup, masks = CTZ.inputs("cpu", n_prog=64)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        setup.numpy(),
        rng.standard_normal(probes.SETUP_SHAPE).astype(np.float32))
    assert list(masks) == list(CTZ.LIVE) == [4, 8, 16, 32]
    for live, mask in masks.items():
        bits = np.zeros((1, 64), np.int64)
        for r in range(64):
            idx = rng.choice(32, size=live, replace=False)
            bits[0, r] = int(np.sum(1 << idx.astype(np.int64)))
        np.testing.assert_array_equal(
            mask.numpy(), bits.astype(np.uint32).view(np.int32)[0])
        ref = probes.ctz_walk_reference(mask, setup)
        for looped in (False, True):
            assert torch.equal(CTZ.walk(mask, setup, looped), ref)


def test_ctzloop_main_prints_the_reference_lines(monkeypatch, capsys):
    monkeypatch.setattr(CTZ, "REPS", 1)
    rows = CTZ.main(["--device", "cpu"])
    assert [(live, looped) for live, looped, _, _ in rows] == [
        (live, looped) for live in (4, 8, 16, 32) for looped in (0, 1)]
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 8
    for line, (live, looped, _, _) in zip(out, rows):
        assert re.fullmatch(
            rf"live={live:2d} looped={looped} compile +\d+\.\ds run +\d+\.\d{{3}}"
            r" ms  +\d+\.\d ns/prog +\d+\.\d ns/chunk", line), line


@pytest.mark.parametrize("twin", [FP, CTZ], ids=["floor_probe",
                                                  "ctzloop_probe"])
def test_main_needs_a_card_unless_asked_for_the_cpu(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
