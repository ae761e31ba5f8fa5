"""The port's live-chunk walk probe (facerecon_tpu_torch/ops/probes.py,
kernel K6's plain version) against the TPU probe it replaces,
benchmarks/ctzloop_probe.py::kernel, run through pl.pallas_call in
interpret mode with the probe's own grid spec, looped and unrolled.

Bar: +inf at exactly the same pixels, and within 1e-6 (absolute and
relative) elsewhere. The reason it is not bit for bit: XLA's CPU backend
contracts the probe's `a * p + b` forms into fused multiply-adds in
interpret mode, while the port rounds the multiply and the add apart, as
its CUDA kernel does (-fmad=false); here 21 of 132 covered minima differ
by one ulp. The test checks that reason too: the plain version with
each form fused (modelled in float64, exact for a product of two
float32 values) equals the probe bit for bit.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops.probes import (COL_PX, SETUP_SHAPE, ctz_walk,
                                            ctz_walk_reference)

torch.set_num_threads(2)
PROBE = (Path(__file__).resolve().parent.parent / "benchmarks"
         / "ctzloop_probe.py")
N_PROG = 8
# the empty word, bit 31 alone, every bit, and a few mixed words
WORDS = np.array([0, 1 << 31, 0xFFFFFFFF, 1, 0x0F0F0F0F, 0x80000001,
                  0x12345678, 0xDEADBEEF], np.uint32).view(np.int32)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("ctzloop_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    return np.random.default_rng(0).standard_normal(SETUP_SHAPE).astype(
        np.float32)


def _run_probe(probe, mask, setup, looped):
    f = pl.pallas_call(
        functools.partial(probe.kernel, looped=looped),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N_PROG,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            scratch_shapes=[
                pltpu.VMEM(SETUP_SHAPE, jnp.float32),
                pltpu.VMEM((probe.COL_PX, probe._CHUNK), jnp.float32),
                pltpu.SemaphoreType.DMA((1,)),
            ],
            out_specs=[pl.BlockSpec((1, probe.COL_PX, 1),
                                    lambda t, *_: (t, 0, 0),
                                    memory_space=pltpu.VMEM)],
        ),
        out_shape=[jax.ShapeDtypeStruct((N_PROG, probe.COL_PX, 1),
                                        jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(mask[None]), jnp.asarray(setup))[0])[..., 0]


def _fused_model(mask, setup):
    """ctz_walk_reference with each `a * p + b` as one fused
    multiply-add (float64 product, one rounding to float32)."""
    s = setup[:6, :32 * 128].astype(np.float64).reshape(6, 32, 128)
    p = np.arange(COL_PX, dtype=np.float64)[:, None, None]
    e0, e1, ez = ((s[k] * p + s[k + 1]).astype(np.float32)
                  for k in (0, 2, 4))
    cov = (e0 >= 0) & (e1 >= 0) & (e0 + e1 <= 1)
    chunk_min = np.where(cov, ez, np.inf).min(axis=-1)
    bits = ((mask.astype(np.int64)[:, None] >> np.arange(32)) & 1) == 1
    return np.where(bits[:, None, :], chunk_min[None], np.inf).min(axis=-1)


@pytest.mark.parametrize("looped", [False, True])
def test_plain_version_matches_pallas_probe(probe, setup, looped):
    ref = _run_probe(probe, WORDS, setup, looped)
    got = ctz_walk_reference(torch.from_numpy(WORDS),
                             torch.from_numpy(setup)).numpy()
    assert got.shape == (N_PROG, COL_PX) and got.dtype == np.float32
    fin = np.isfinite(ref)
    assert 0 < fin.sum() < fin.size
    assert np.array_equal(np.isfinite(got), fin)
    assert not fin[0].any() and fin[2].any()     # word 0 tests nothing
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_fused_model(WORDS, setup), ref)


def test_wrapper_runs_plain_version_on_cpu(setup):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; it rejects what the kernel does not take. Every word's
    minimum is the minimum over its bits' one-bit words."""
    mask, st = torch.from_numpy(WORDS), torch.from_numpy(setup)
    before = _build.LAUNCHES["ctz_walk"]
    got = ctz_walk(mask, st)
    assert torch.equal(got, ctz_walk_reference(mask, st))
    assert _build.LAUNCHES["ctz_walk"] == before
    singles = ctz_walk(torch.tensor([np.int32(np.uint32(1 << k))
                                     for k in range(32)]), st)
    full = singles.amin(dim=0)
    assert torch.equal(got[2], full)
    for bad_mask, bad_setup in ((mask.to(torch.int64), st),
                                (mask, st[:, :4096].contiguous()),
                                (mask, st.double()),
                                (mask, st.T.contiguous().T)):
        with pytest.raises(ValueError):
            ctz_walk(bad_mask, bad_setup)
