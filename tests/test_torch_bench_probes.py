"""The port's probes (facerecon_tpu_torch/benchmarks/) on the CPU, against
the reference's benchmarks/calib_probe.py, roofline_probe.py,
cnn_probe.py, cnn_micro_probe.py, gather_probe.py and scatter_probe.py
on the same numpy inputs, at small sizes:

  - cnn_probe: the cuts' states (stem, first n blocks, head stub), built
    from weights drawn in the flax fused layout and carried over by
    jax_params.fused_state_dict, give the reference's truncated
    FusedResNetRegressor's outputs (its own _prefix_params and _head_stub,
    loaded from its file) at 64 px, batch 2, f32, within 1e-4 x max; since
    a cut's output is the head's bias, each cut's features before the
    head also equal the full model's block outputs, taken with a forward
    hook, exactly;
  - the probes whose functions live inside the reference's main() are
    restated in JAX here, each beside the line it restates: relu and the
    gathers within 1e-6 of the max, the scatter-min and the sort exactly
    (the reference's uint32 0xFFFFFFFF sentinel mapped to INT32_MAX),
    the stems and the block within 1e-5 x max in f32, each pool form
    exactly against its own reference form;
  - the reference's two pool forms compute different functions (SAME
    pads (0, 1) at 112 px, the slices (1, 1)), in JAX and in the port
    alike, at the same outputs;
  - the chained timer feeds each call the previous call's scalar, or
    passes it as `seed`;
  - each twin's main with --device cpu at tiny sizes prints the
    reference's case lines in order, and without --device raises on a
    host with no card.
"""

import ast
import importlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from facerecon_tpu.models.fused import FusedResNetRegressor as RefFused
from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch.benchmarks import _timing
from facerecon_tpu_torch.benchmarks import calib_probe as CAL
from facerecon_tpu_torch.benchmarks import cnn_micro_probe as MIC
from facerecon_tpu_torch.benchmarks import cnn_probe as CNN
from facerecon_tpu_torch.benchmarks import gather_probe as GAT
from facerecon_tpu_torch.benchmarks import scatter_probe as SCA
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.models.fused import FusedResNetRegressor

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parent.parent / "benchmarks"
N_COEFF = tiny_config().n_coeff
NAMES = ["calib_probe", "roofline_probe", "cnn_probe", "cnn_micro_probe",
         "gather_probe", "scatter_probe"]


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


# --- cnn_probe ---

@pytest.fixture(scope="module")
def reference_cnn_probe():
    spec = importlib.util.spec_from_file_location("cnn_probe",
                                                  BENCH / "cnn_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fused_params():
    """Weights of the full fused ResNet-50 drawn with numpy in the flax
    layout (shapes from the reference module, no init run): kernels
    normal / sqrt(fan_in), biases normal x 0.1."""
    shapes = jax.eval_shape(lambda: RefFused(N_COEFF, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(3)

    def draw(path, s):
        if path[-1].key == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        else:
            std = 0.1
        return (rng.standard_normal(s.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def port_full(fused_params):
    m = FusedResNetRegressor(N_COEFF, dtype=torch.float32)
    m.load_state_dict(jax_params.fused_state_dict(fused_params))
    return m.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def images64():
    return np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("cut", range(len(CNN.CUTS)),
                         ids=[t for t, _ in CNN.CUTS])
def test_cnn_cut_matches_reference_truncation(reference_cnn_probe,
                                              fused_params, port_full,
                                              images64, cut):
    """benchmarks/cnn_probe.py:79-96: the cut's model on the prefix
    params (or the full model), against the port's cut_model."""
    stages = CNN.CUTS[cut][1]
    if stages is None:
        want = RefFused(N_COEFF, dtype=jnp.float32).apply(
            fused_params, images64, train=False)
    else:
        nb = sum(stages)
        want = RefFused(N_COEFF, stage_sizes=tuple(stages),
                        dtype=jnp.float32).apply(
            reference_cnn_probe._prefix_params(fused_params, nb), images64,
            train=False)
    with torch.no_grad():
        got = CNN.cut_model(port_full, stages)(torch.from_numpy(images64))
    _close(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("n_blocks", [0, 3, 7, 13])
def test_cnn_head_stub_is_the_reference_stub(reference_cnn_probe,
                                             fused_params, port_full,
                                             n_blocks):
    weight, bias = CNN.head_stub(port_full.state_dict(), n_blocks)
    want = reference_cnn_probe._head_stub(fused_params["params"], n_blocks)
    np.testing.assert_array_equal(weight.numpy(), np.asarray(want["kernel"]).T)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(want["bias"]))


@pytest.mark.parametrize("cut", range(len(CNN.CUTS)),
                         ids=[t for t, _ in CNN.CUTS])
def test_cnn_cut_features_are_the_full_models(port_full, images64, cut):
    """The cut's pooled features before its head equal the full model's
    activations at the cut point (the input of block n, or the output of
    the last block), pooled the same way, bit for bit."""
    stages = CNN.CUTS[cut][1]
    nb = len(port_full.blocks) if stages is None else sum(stages)
    m = CNN.cut_model(port_full, stages)
    seen = {}
    h1 = m.head.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("cut", args[0]))
    if nb < len(port_full.blocks):
        h2 = port_full.blocks[nb].register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("full", args[0]))
    else:
        h2 = port_full.blocks[nb - 1].register_forward_hook(
            lambda mod, args, out: seen.__setitem__("full", out))
    x = torch.from_numpy(images64)
    try:
        with torch.no_grad():
            m(x)
            port_full(x)
    finally:
        h1.remove()
        h2.remove()
    want = seen["full"].mean(dim=(2, 3)).to(torch.float32)
    assert seen["cut"].shape == want.shape
    assert torch.equal(seen["cut"], want)
    assert want.abs().max() > 0


# --- calib_probe ---

@pytest.fixture(scope="module")
def calib_inputs():
    return CAL.make_inputs(2, "cpu")


@pytest.mark.parametrize("k", [1, 4])
def test_calib_relu_matches_reference(calib_inputs, k):
    """benchmarks/calib_probe.py:58-62, on a (2,56,56,64) bf16 input."""
    x = calib_inputs[0]
    xj = jnp.asarray(_np(x), jnp.bfloat16)
    want = sum(jnp.sum(jax.nn.relu(xj * (1.0 + i * 1e-30))
                       .astype(jnp.float32)) for i in range(k))
    got = CAL.relu_k(k)(x)
    assert got.dtype == torch.float32
    _close(float(got), float(want), 1e-6)


@pytest.mark.parametrize("k", [1, 4])
def test_calib_gather_matches_reference(calib_inputs, k):
    """benchmarks/calib_probe.py:64-68."""
    _, pvr, bidx = calib_inputs
    assert bidx.min() >= 0 and bidx.max() < 70656
    want = sum(jnp.sum(jnp.take_along_axis(
        jnp.asarray(pvr.numpy()) * (1.0 + i * 1e-30),
        jnp.asarray(bidx.numpy()), axis=1)) for i in range(k))
    _close(float(CAL.talax_k(k)(pvr, bidx)), float(want), 1e-6)


# --- cnn_micro_probe ---

def _ref_s2d(x):                      # benchmarks/cnn_micro_probe.py:67-71
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _ref_conv(x, w, stride, pad, b0):  # :73-87, in x's dtype
    y = jax.lax.conv_general_dilated(
        x, w, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return (y + b0).astype(x.dtype)


def _ref_pool_rw(y):                   # :89-91
    return nn.max_pool(nn.relu(y), (3, 3), strides=(2, 2), padding="SAME")


def _ref_pool_slices(y):               # :93-103
    y = nn.relu(y)
    yp = jnp.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=-jnp.inf)
    parts = [yp[:, a:a + 112:2, b:b + 112:2, :]
             for a in range(3) for b in range(3)]
    out = parts[0]
    for p in parts[1:]:
        out = jnp.maximum(out, p)
    return out


def _ref_block(x, w1a, w3, w1b):       # :126-134, in x's dtype
    def co(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=x.dtype)
    y = nn.relu(co(x, w1a))
    y = nn.relu(co(y, w3))
    y = co(y, w1b)
    return nn.relu(y + x)


def _hwio(w):
    return jnp.asarray(_np(w).transpose(2, 3, 1, 0))


@pytest.fixture(scope="module")
def micro():
    """cnn_micro_probe's inputs at batch 1, with f32 copies of the stem
    weights."""
    d = MIC.make_inputs(1, "cpu")
    d["w4f"], d["w7f"] = d["w4"].float(), d["w7"].float()
    return d


def test_micro_s2d_matches_reference(micro):
    np.testing.assert_array_equal(MIC.s2d(micro["img"]).numpy(),
                                  np.asarray(_ref_s2d(micro["img"].numpy())))


@pytest.mark.parametrize("form", ["conv4", "conv7"])
def test_micro_stem_matches_reference_f32(micro, form):
    img, b0 = micro["img"], micro["b0"]
    if form == "conv4":
        got = MIC.conv4(img, micro["w4f"], b0)
        want = _ref_conv(_ref_s2d(jnp.asarray(img.numpy())),
                         _hwio(micro["w4f"]), 1, ((1, 2), (1, 2)),
                         jnp.asarray(b0.numpy()))
    else:
        got = MIC.conv7(img, micro["w7f"], b0)
        want = _ref_conv(jnp.asarray(img.numpy()), _hwio(micro["w7f"]), 2,
                         ((2, 3), (2, 3)), jnp.asarray(b0.numpy()))
    assert got.shape == (1, 112, 112, 64) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), 1e-5)


def test_micro_stems_agree_f32(micro):
    """The s2d stem computes the native 7x7/s2 stem (_stem_to_s2d)."""
    a = MIC.conv4(micro["img"], micro["w4f"], micro["b0"])
    b = MIC.conv7(micro["img"], micro["w7f"], micro["b0"])
    _close(a.numpy(), b.numpy(), 1e-5)


@pytest.fixture(scope="module")
def pool_input():
    return np.random.default_rng(5).standard_normal(
        (2, 112, 112, 4)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["pool_rw", "pool_slices"])
def test_micro_pool_matches_its_reference_form(pool_input, form, dtype):
    y = torch.from_numpy(pool_input).to(dtype)
    ref = {"pool_rw": _ref_pool_rw, "pool_slices": _ref_pool_slices}[form]
    want = ref(jnp.asarray(_np(y), jnp.bfloat16 if dtype == torch.bfloat16
                           else jnp.float32))
    got = getattr(MIC, form)(y)
    assert got.shape == (2, 56, 56, 4) and got.dtype == dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_pool_forms_differ_in_both_packages(pool_input):
    """The reference's fault, kept: its SAME pool pads (0, 1) at 112 px
    and its slice pool (1, 1), so most outputs differ, at the same
    places in JAX and in the port."""
    y = torch.from_numpy(pool_input)
    port = (MIC.pool_rw(y) != MIC.pool_slices(y)).numpy()
    yj = jnp.asarray(pool_input)
    ref = np.asarray(_ref_pool_rw(yj) != _ref_pool_slices(yj))
    np.testing.assert_array_equal(port, ref)
    assert port.mean() > 0.5


def test_micro_block_matches_reference_f32(micro):
    """The stage-1 block in f32 on a (1,56,56,256) input."""
    x = micro["x256"].float()
    w = [micro[k].float() for k in ("w1a", "w3", "w1b")]
    got = MIC.block(x, *w)
    want = _ref_block(jnp.asarray(x.numpy()), *[_hwio(v) for v in w])
    _close(got.numpy(), np.asarray(want), 1e-5)


# --- gather_probe ---

_REF_GATHERS = {                       # benchmarks/gather_probe.py
    "rows (B,3F,5) <- (B,N,5)": lambda x, i: [jnp.take(x, i, axis=1)],
    "rows (B,3F,8) <- (B,N,8)": lambda x, i: [jnp.take(x, i, axis=1)],
    "lanes (B,6,3F) <- (B,6,N) ax-1": lambda x, i: [jnp.take(x, i, axis=2)],
    "lanes (B,3F) <- (B,N) ax-1": lambda x, i: [jnp.take(x, i, axis=1)],
    "lanes 6x(B,3F) <- 6x(B,N)": lambda x, i: [
        jnp.take(x * (1.0 + k * 1e-30), i, axis=1) for k in range(6)],
    "talax (B,px) <- (B,rows)": lambda x, i: [
        jnp.take_along_axis(x, i, axis=1)],
    "talax 16x(B,px) <- 16x(B,rows)": lambda x, i: [
        jnp.take_along_axis(x * (1.0 + k * 1e-30), i, axis=1)
        for k in range(16)],
    "talax (B,16,px) <- (B,16,rows)": lambda x, i: [
        jnp.take_along_axis(x, i[:, None, :], axis=2)],
    "adj rows (B,N*deg,3)+sum": lambda x, a: [
        jnp.take(x, a.reshape(-1), axis=1).reshape(
            x.shape[0], a.shape[0], a.shape[1], 3).sum(2)],
    "adj per-k 6x(B,N,3) summed": lambda x, a: [
        sum(jnp.take(x * (1.0 + k * 1e-30), a[:, k], axis=1)
            for k in range(a.shape[1]))],
}


@pytest.fixture(scope="module")
def gather_inputs():
    """Small arrays of the probe's kinds: N 50, 3F 90, 40 rows, 30 px,
    70 faces, degree 6, batch 2."""
    rng = np.random.default_rng(0)
    n, f3, rows, px, faces, b = 50, 90, 40, 30, 70, 2
    return dict(
        idx=rng.integers(0, n, (f3,)).astype(np.int32),
        pv5=rng.random((b, n, 5)), pv8=rng.random((b, n, 8)),
        pvt=rng.random((b, 6, n)), pv1=rng.random((b, n)),
        pvr=rng.random((b, rows)), pvr16=rng.random((b, 16, rows)),
        bidx=rng.integers(0, rows, (b, px)),
        adj=rng.integers(0, faces, (n, 6)).astype(np.int32),
        fn3=rng.random((b, faces, 3)))


@pytest.mark.parametrize("case", GAT.CASES, ids=[c[0] for c in GAT.CASES])
def test_gather_form_matches_reference(gather_inputs, case):
    tag, form, x, i = case
    xs = gather_inputs[x].astype(np.float32)
    ix = gather_inputs[i]
    got = form(torch.from_numpy(xs), torch.from_numpy(
        ix.astype(np.int64 if i == "bidx" else np.int32)))
    want = _REF_GATHERS[tag](jnp.asarray(xs), jnp.asarray(ix, jnp.int32))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-6)
    _close(float(GAT.summed(form)(torch.from_numpy(xs), torch.from_numpy(
        ix.astype(np.int64 if i == "bidx" else np.int32)))),
        float(sum(jnp.sum(w) for w in want)), 1e-6)


# --- scatter_probe ---

@pytest.fixture(scope="module")
def scatter_case():
    """scatter_probe's data at batch 3, 500 candidates, 16 px, and the
    flat indices."""
    size, batch = 16, 3
    idx, zb, ids = SCA.make_inputs(batch, 500, size, "cpu")
    gi = SCA.flat_index(idx, size * size, torch.zeros(()))
    return idx, zb, ids, gi, batch * size * size


def _unsentinel(a):
    a = np.asarray(a).astype(np.int64)
    return np.where(a == 0xFFFFFFFF, SCA.INT32_MAX, a)


def test_scatter_min_matches_reference(scatter_case):
    """benchmarks/scatter_probe.py:70-74, in uint32."""
    idx, zb, _, gi, n = scatter_case
    want = jnp.full((n,), 0xFFFFFFFF, jnp.uint32).at[
        jnp.asarray(gi.numpy())].min(jnp.asarray(zb.numpy().reshape(-1),
                                                 jnp.uint32), mode="drop")
    got = SCA.scatter_min(gi, zb.reshape(-1), n)
    np.testing.assert_array_equal(got.numpy(), _unsentinel(want))
    assert (got.numpy() == SCA.INT32_MAX).any()        # empty pixels


def test_two_pass_matches_reference(scatter_case):
    """:76-86: pass 1, the element gather, pass 2."""
    _, zb, ids, gi, n = scatter_case
    g = jnp.asarray(gi.numpy())
    zf = jnp.asarray(zb.numpy().reshape(-1), jnp.uint32)
    out = jnp.full((n,), 0xFFFFFFFF, jnp.uint32).at[g].min(zf, mode="drop")
    idw = jnp.where(out[g] == zf, jnp.asarray(ids.numpy().reshape(-1),
                                              jnp.uint32),
                    jnp.uint32(0xFFFFFFFF))
    out2 = jnp.full((n,), 0xFFFFFFFF, jnp.uint32).at[g].min(idw, mode="drop")
    zmin, got2 = SCA.two_pass(gi, zb.reshape(-1), ids.reshape(-1), n)
    np.testing.assert_array_equal(zmin.numpy(), _unsentinel(out))
    np.testing.assert_array_equal(got2.numpy(), _unsentinel(out2))


def test_scatter_cases_match_reference_scalars(scatter_case):
    """:70-98's scalars where they do not meet the sentinel: pass 1's
    pixel 0 (the most crowded), the element gather's sum and the sort's
    first key."""
    idx, zb, ids, gi, n = scatter_case
    fns = dict(SCA.make_cases(16 * 16))
    seed = torch.zeros(())
    zf = zb.numpy().reshape(-1).astype(np.int64)
    want0 = zf[gi.numpy() == 0].min()
    assert float(fns["scatter-min u32 1-pass"](idx, zb, ids, seed)) == \
        np.float32(want0)
    assert float(fns["element gather"](idx, zb, ids, seed)) == np.float32(
        int(zb[0, 0]) * gi.numel())
    want = np.asarray(jnp.sort(jnp.asarray(idx.numpy()), axis=1))
    np.testing.assert_array_equal(torch.sort(idx, dim=1).values.numpy(),
                                  want)
    assert float(fns["sort (proxy)"](idx, zb, ids, seed)) == want[0, 0]


# --- the timer ---

def test_chain_feeds_each_call_the_previous_scalar():
    seen = []

    def one(x, y):
        seen.append(x)
        return (x.sum() + y) * 1e31
    x, y = torch.tensor([1.5, -2.0]), torch.tensor(0.25)
    total = _timing.chain(one, (x, y), inner=3)
    assert torch.equal(seen[0], x)
    for k in (1, 2):
        carry = (seen[k - 1].sum() + y) * 1e31 * 1e-30
        assert torch.equal(seen[k], x * (1.0 + carry * 1e-30))
    assert float(total) == pytest.approx(
        float(sum((s.sum() + y) * 1e31 for s in seen)), rel=1e-6)


def test_seeded_chain_passes_the_carry_as_seed():
    seeds = []

    def one(a, seed):
        seeds.append(float(seed))
        return a.sum() * 1e32
    _timing.chain(one, (torch.ones(3),), inner=3, seeded=True)
    assert seeds == pytest.approx([0.0, 3e2, 3e2])


# --- each twin's main ---

def _reference_tags(name):
    """The tags the reference times, in order: the string first argument
    of each timed(...) call, or cnn_probe's `cuts` list."""
    tree = ast.parse((BENCH / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and name == "cnn_probe"
                and getattr(node.targets[0], "id", "") == "cuts"):
            return [t for t, _ in ast.literal_eval(node.value)]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "timed"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [n.args[0].value for n in calls]


@pytest.mark.parametrize("name", NAMES)
def test_main_prints_the_reference_case_lines(monkeypatch, capsys, name):
    """main with --device cpu at tiny sizes: one timing line a reference
    case, in the reference's order, with finite times and sums."""
    env = {"calib_probe": {"BATCH": "1"},
           "cnn_probe": {"BATCH": "1", "INNER": "1", "REPS": "1",
                         "DTYPE": "float32"},
           "cnn_micro_probe": {"BATCH": "1"},
           "gather_probe": {"BATCH": "1"},
           "scatter_probe": {"BATCH": "2", "M": "300", "SIZE": "32"}}
    for k, v in env.get(name, {}).items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"facerecon_tpu_torch.benchmarks.{name}")
    if hasattr(mod, "INNER"):
        monkeypatch.setattr(mod, "INNER", 1)
        monkeypatch.setattr(mod, "REPS", 1)
    if name == "roofline_probe":
        monkeypatch.setattr(mod, "BIG", (2, 16, 64))
        monkeypatch.setattr(mod, "MM", 32)
    if name == "cnn_probe":
        monkeypatch.setattr(mod, "default_config",
                            lambda **kw: tiny_config(**kw))
    cases = mod.main(["--device", "cpu"])
    want = _reference_tags(name)
    if name == "roofline_probe":
        want = [t.replace("8192", "32") for t in want]
    assert [c.tag for c in cases] == want
    for c in cases:
        assert np.isfinite([c.seconds, c.first, c.last]).all()
    out = capsys.readouterr().out.splitlines()
    if name == "scatter_probe":
        timing = [ln for ln in out if re.search(r": +\d+\.\d+ ms/2$", ln)]
        assert [ln.rsplit(":", 1)[0] for ln in timing] == want
        compiled = [ln for ln in out if re.search(r": compile \d+s$", ln)]
        assert [ln.rsplit(":", 1)[0] for ln in compiled] == want
        return
    timing = [ln for ln in out if "[compile " in ln]
    assert [ln.split(":")[0].rstrip() for ln in timing] == want
    for ln in timing:
        assert re.search(r": +\d+\.\d+ ms(/\d+)?  \[compile \d+s\]$", ln), ln


@pytest.mark.parametrize("name", NAMES)
def test_main_needs_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"facerecon_tpu_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
