"""The port's fused ResNet-50 regressor (facerecon_tpu_torch/models/fused.py)
against the JAX reference on one set of weights.

A perturbed BN model (non-trivial weights and running statistics, like
tests/test_fused_model.py's) is folded by the reference's fuse_variables
and carried across with jax_params. In float32 the two fused models agree
to 1e-4 x max|y|: torch's and XLA's CPU convolutions use different
algorithms and summation orders over some 50 layers. The port's own
numpy fold must reproduce the reference's fused parameters exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from facerecon_tpu.models.fused import build_fused_model, fuse_variables
from facerecon_tpu.models.resnet import build_model

from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch.models import fused as TF

torch.set_num_threads(2)


def _leaf(path, shape, rng):
    """A non-trivial value for one BN-model variable, by its flax name."""
    name = jtu.keystr(path[-1:])
    n = rng.standard_normal(shape)
    if "kernel" in name:
        v = n / np.sqrt(np.prod(shape[:-1]))          # LeCun-normal
    elif "scale" in name:
        v = 1.0 + 0.1 * n
    elif "var" in name:
        v = np.abs(1.0 + 0.1 * n) + 0.01
    else:
        v = 0.1 * n                                   # bias, mean
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def bn_variables(cfg):
    """Perturbed weights and running statistics of the BN model (a fresh
    init has a zero head and unit statistics, which would hide folding
    mistakes), drawn with numpy on the structure flax gives."""
    model = build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    return jtu.tree_map_with_path(lambda p, s: _leaf(p, s.shape, rng),
                                  dict(shapes))


def test_port_fold_matches_reference_fold(cfg, bn_variables):
    ref = jtu.tree_map(np.asarray, fuse_variables(bn_variables, cfg))
    got = TF.fuse_variables(bn_variables)
    assert jtu.tree_structure(got) == jtu.tree_structure(ref)
    for a, b in zip(jtu.tree_leaves(got), jtu.tree_leaves(ref)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_fused_model_matches_reference(cfg, bn_variables):
    fv = fuse_variables(bn_variables, cfg)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    y_ref = np.asarray(build_fused_model(cfg, dtype=jnp.float32).apply(
        fv, jnp.asarray(x)))
    model = TF.build_fused_model(cfg, dtype=torch.float32)
    model.load_state_dict(jax_params.fused_state_dict(
        jtu.tree_map(np.asarray, fv)))
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    scale = float(np.abs(y_ref).max())
    assert scale > 0
    assert float(np.abs(y - y_ref).max()) < 1e-4 * scale


def test_same_padding_matches_flax():
    """SAME padding (before, after) as flax computes it: asymmetric at
    stride 2, which torch's symmetric padding= cannot express."""
    assert TF._same_pads(224, 3, 2) == (0, 1)
    assert TF._same_pads(112, 3, 2) == (0, 1)
    assert TF._same_pads(56, 3, 1) == (1, 1)
    assert TF._same_pads(56, 1, 2) == (0, 0)
    assert TF._same_pads(224, 7, 2) == (2, 3)
