"""The port's benchmark entry points (facerecon_tpu_torch/bench.py) on
the CPU, against the reference's bench.py workloads.

  - the headline's per-microbatch computation (the BatchNorm model folded
    by fuse_for_inference, then reconstruct through the inference
    render) against the reference's fuse_for_inference +
    make_reconstruct_fn(inference=True), tiny_config() in float32, the
    reference's init_params variables carried over (jax_params) with the
    head perturbed from a seed so the coefficients are not all zero:
    coefficients within 1e-4 x max|c|, image means within 1e-4;
  - with the reference's own initialisation every coefficient is exactly
    0 (zero head: every image regresses the frontal mean face) in both
    packages, and the image means agree within 1e-4;
  - render512's per-microbatch render against the reference's at
    tiny_config(): image means within 1e-4;
  - each mode through `python -m facerecon_tpu_torch.bench --device cpu`
    at small knob values: one JSON line with the reference's keys and
    metric string, vs_baseline null, appended to BENCH_RECORD too;
  - without --device cpu, main raises on a host with no card.
On the CPU the reference renders through rasterize_tiled (Pallas does not
run there) and the port through the plain versions of its kernels.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecon_tpu.models import fused as ref_fused
from facerecon_tpu.ops.geometry import device_bfm as ref_device_bfm
from facerecon_tpu.ops.render import render_coeffs as ref_render_coeffs
from facerecon_tpu.pipeline import Pipeline as RefPipeline
from facerecon_tpu.pipeline import init_params, make_pipeline
from facerecon_tpu.pipeline import make_reconstruct_fn
from facerecon_tpu.utils.coeffs import split_coeff as ref_split_coeff

from facerecon_tpu_torch import bench, jax_params
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.pipeline import (fuse_for_inference,
                                          make_train_pipeline)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
BATCH, MICRO = 4, 2


@pytest.fixture(scope="module")
def ref_headline(cfg, assets):
    """The reference's headline computation in float32 at tiny_config():
    (init_params variables, micro-batch fn(variables) -> (coefficients,
    image means)), jitted once."""
    pipe = make_pipeline(cfg, assets, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, init_params(pipe, jax.random.PRNGKey(0)))
    fused = RefPipeline(cfg=cfg, bfm=pipe.bfm,
                        model=ref_fused.build_fused_model(
                            cfg, dtype=jnp.float32))
    inner = make_reconstruct_fn(fused, inference=True)

    def run(bn_variables, images):
        fvars = ref_fused.fuse_variables(bn_variables, cfg)
        coeffs, means = [], []
        for im in np.split(images, BATCH // MICRO):
            cv, _, out = inner(fvars, fused.bfm, jnp.asarray(im))
            coeffs.append(np.asarray(cv))
            means.append(np.asarray(jnp.mean(out.image, axis=(1, 2, 3))))
        return np.concatenate(coeffs), np.concatenate(means)

    return variables, run


def _port_headline(cfg, assets, variables, images):
    pipe = make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32)
    pipe.model.load_state_dict(jax_params.train_state_dict(variables))
    cv, means = bench.headline_pass(fuse_for_inference(pipe),
                                    torch.from_numpy(images), MICRO)
    return cv.numpy(), means.numpy()


def test_headline_pass_matches_reference(cfg, assets, ref_headline):
    variables, ref_run = ref_headline
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(np.copy, variables)
    head = variables["params"]["Dense_0"]
    head["kernel"] = (rng.standard_normal(head["kernel"].shape)
                      * 2e-3).astype(np.float32)
    head["bias"] = sample_coeffs(rng, cfg, 1)[0]
    images = bench.headline_images(BATCH, cfg.image_size)
    want_c, want_m = ref_run(variables, images)
    got_c, got_m = _port_headline(cfg, assets, variables, images)
    assert got_c.shape == (BATCH, cfg.n_coeff) and got_m.shape == (BATCH,)
    # the head is not zero: each image has coefficients of its own
    assert np.abs(want_c[0] - want_c[1]).max() > 1e-3
    scale = np.abs(want_c).max()
    assert np.abs(got_c - want_c).max() <= 1e-4 * scale
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-4)


def test_reference_init_regresses_the_mean_face(cfg, assets, ref_headline):
    """The headline's own weights: every coefficient exactly 0 in both
    packages, as the reference's zero head gives."""
    variables, ref_run = ref_headline
    images = bench.headline_images(BATCH, cfg.image_size)
    want_c, want_m = ref_run(variables, images)
    assert not want_c.any()
    for dtype in (torch.float32, torch.bfloat16):
        pipe = bench.headline_pipeline(cfg, assets, device="cpu",
                                       dtype=dtype)
        assert not pipe.model.training
        cv, means = bench.headline_pass(pipe, torch.from_numpy(images),
                                        MICRO)
        assert cv.shape == (BATCH, cfg.n_coeff)
        assert not cv.any(), dtype
        np.testing.assert_allclose(means.numpy(), want_m, rtol=0, atol=1e-4)


def test_render512_pass_matches_reference(cfg, assets):
    """render512's per-call computation (the inference render of each
    microbatch of coefficients, image means) against the reference's
    (bench.py:69-77) at tiny_config(): means within 1e-4."""
    coeffs = sample_coeffs(np.random.default_rng(0), cfg, BATCH)
    bfm = ref_device_bfm(assets)
    want = np.concatenate([np.asarray(jnp.mean(ref_render_coeffs(
        ref_split_coeff(jnp.asarray(c), cfg), bfm, cfg,
        inference=True).image, axis=(1, 2, 3)))
        for c in np.split(coeffs, BATCH // MICRO)])
    got = bench.render512_pass(cfg, device_bfm(assets, "cpu"),
                               torch.from_numpy(coeffs), MICRO)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_train_inputs_are_drawn_as_the_reference_draws_them():
    rng = np.random.default_rng(0)
    want_im = rng.random((2, 3, 16, 16, 3)).astype(np.float32)
    want_lmk = (rng.random((2, 3, 68, 2)) * 16).astype(np.float32)
    images, lmk = bench.train_inputs(2, 3, 16)
    np.testing.assert_array_equal(images, want_im)
    np.testing.assert_array_equal(lmk, want_lmk)


# (mode, knobs, the reference's metric string)
MODES = [
    ("headline", {"BENCH_BATCH": "1", "BENCH_MICROBATCH": "1",
                  "BENCH_REPS": "1", "BENCH_INNER_REPS": "1"},
     "faces/sec/chip (regress+render, 224px, batch-1)"),
    ("train", {"BENCH_BATCH": "1", "BENCH_REPS": "1", "BENCH_CHUNK": "1"},
     "faces/sec/chip (train fwd+bwd, 224px, batch-1)"),
    ("render512", {"BENCH_BATCH": "1", "BENCH_MICROBATCH": "1",
                   "BENCH_REPS": "1"},
     "faces/sec/chip (render-only, 512px, batch-1)"),
]


@pytest.fixture(scope="module")
def module_runs(tmp_path_factory):
    """The three `python -m facerecon_tpu_torch.bench --device cpu` runs,
    started together (each is a few plain-path passes at full width, tens
    of seconds): mode -> (process, its stdout and stderr files, its
    BENCH_RECORD file). Any run still going at teardown is killed."""
    runs = {}
    try:
        for mode, knobs, _ in MODES:
            d = tmp_path_factory.mktemp(mode)
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("BENCH_")}
            env.update(knobs, BENCH_RECORD=str(d / "record.jsonl"),
                       OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
            if mode != "headline":
                env["BENCH_MODE"] = mode
            with open(d / "out", "w") as out, open(d / "err", "w") as err:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "facerecon_tpu_torch.bench",
                     "--device", "cpu"], cwd=ROOT, env=env, stdout=out,
                    stderr=err)
            runs[mode] = (proc, d)
        yield runs
    finally:
        for proc, _ in runs.values():
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("mode,knobs,metric", MODES,
                         ids=[m[0] for m in MODES])
def test_module_prints_the_reference_line(module_runs, mode, knobs, metric):
    proc, d = module_runs[mode]
    rc = proc.wait(timeout=600)
    assert rc == 0, (d / "err").read_text()[-3000:]
    lines = (d / "out").read_text().splitlines()
    assert len(lines) == 1, lines
    payload = json.loads(lines[0])
    assert list(payload) == ["metric", "value", "unit", "vs_baseline"]
    assert payload["metric"] == metric
    assert payload["unit"] == "faces/s"
    assert payload["vs_baseline"] is None
    assert payload["value"] > 0
    assert (d / "record.jsonl").read_text() == lines[0] + "\n"


@pytest.mark.parametrize("mode", [None, "train", "render512"])
def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, mode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if mode is None:
        monkeypatch.delenv("BENCH_MODE", raising=False)
    else:
        monkeypatch.setenv("BENCH_MODE", mode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
