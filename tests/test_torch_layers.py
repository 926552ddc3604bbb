"""Port ops and layers against the JAX package on the CPU: layer_norm,
Dense and dropout_add_layer_norm (inference). Inputs come from a numpy
seed, weights are copied across, and everything compares in float32 at
1e-5 (both sides accumulate in f32; only summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.fused_dropout_ln import \
    dropout_add_layer_norm as jax_dln
from analytics_zoo_tpu.ops.layernorm import layer_norm as jax_ln
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu_torch.ops import dropout_add_layer_norm, layer_norm
from analytics_zoo_tpu_torch.ops.fused_dropout_ln import draw_bits
from analytics_zoo_tpu_torch.pipeline.api.keras.engine.base import (
    get_activation_fn, init_tensor)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

TOL = 1e-5


def _rows(seed, shape, offset=0.0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal(shape) + offset).astype(np.float32)


@pytest.mark.parametrize("eps,offset", [(1e-5, 0.0), (1e-12, 0.0),
                                        (1e-5, 3.0)])
def test_layer_norm_matches_jax(eps, offset):
    """Single-pass statistics: a row mean of 3 keeps E[x^2] - mean^2 away
    from the two-pass result in the last bits, and both sides agree."""
    x = _rows(0, (4, 9, 64), offset)
    g = _rows(1, (64,))
    b = _rows(2, (64,))
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            eps))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), eps).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_layer_norm_constant_row_is_finite():
    x = torch.full((2, 16), 7.0)
    y = layer_norm(x, torch.ones(16), torch.zeros(16))
    assert torch.isfinite(y).all() and y.abs().max() == 0


def test_dropout_add_layer_norm_inference_matches_jax():
    x, r = _rows(3, (2, 5, 32)), _rows(4, (2, 5, 32))
    g, b = _rows(5, (32,)), _rows(6, (32,))
    ref = np.asarray(jax_dln(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g),
                             jnp.asarray(b), jax.random.PRNGKey(0), 0.1,
                             training=False))
    gen = torch.Generator().manual_seed(0)
    for training, p in ((False, 0.1), (True, 0.0)):
        out = dropout_add_layer_norm(
            torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(g),
            torch.from_numpy(b), gen, p, training=training).numpy()
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_dropout_add_layer_norm_training_draws_from_generator():
    """Training draws 32-bit words from the explicit generator and keeps
    those below keep * 2**32, as the TPU kernel thresholds its bits: the
    same seed gives the same output, and the result is
    layer_norm(mask * x / keep + resid) with the mask of those words."""
    x = torch.randn(64, 128)
    r = torch.zeros(64, 128)
    g, b = torch.ones(128), torch.zeros(128)
    y1 = dropout_add_layer_norm(x, r, g, b,
                                torch.Generator().manual_seed(7), 0.25)
    y2 = dropout_add_layer_norm(x, r, g, b,
                                torch.Generator().manual_seed(7), 0.25)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    bits = draw_bits(x.shape, torch.Generator().manual_seed(7), "cpu")
    keep = (bits.long() & 0xFFFFFFFF) < int(0.75 * 2 ** 32)
    manual = layer_norm(torch.where(keep, x * (1 / 0.75),
                                    torch.zeros_like(x)) + r, g, b)
    torch.testing.assert_close(y1, manual, rtol=0, atol=0)
    assert 0.7 < keep.float().mean().item() < 0.8


@pytest.mark.parametrize("activation", [None, "softmax", "tanh"])
def test_dense_matches_jax(activation):
    x = _rows(7, (6, 3, 16))
    jd = JDense(5, activation=activation)
    params = jd.build(jax.random.PRNGKey(0), (None, 3, 16))
    params["bias"] = jnp.asarray(_rows(8, (5,)))
    ref = np.asarray(jd.call(params, jnp.asarray(x)))
    td = Dense(5, activation=activation)
    td.build_params(torch.Generator().manual_seed(0), (None, 3, 16))
    assert td.kernel.shape == (16, 5) and td.bias.shape == (5,)
    with torch.no_grad():
        td.kernel.copy_(torch.from_numpy(np.array(params["kernel"])))
        td.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    out = td(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_dense_without_bias_and_output_shape():
    td = Dense(4, bias=False, input_dim=8)
    td.build_params(torch.Generator().manual_seed(0), (None, 8))
    assert [n for n, _ in td.named_parameters()] == ["kernel"]
    assert td.compute_output_shape((None, 8)) == (None, 4)
    assert td(torch.ones(2, 8)).shape == (2, 4)


def test_init_tensor_draws_follow_the_named_scheme():
    gen = torch.Generator().manual_seed(0)
    w = init_tensor(gen, (200, 300), "glorot_uniform")
    limit = np.sqrt(6.0 / 500)
    assert w.shape == (200, 300) and w.abs().max() <= limit
    assert w.abs().max() > 0.9 * limit
    assert init_tensor(gen, (3,), "zero").abs().sum() == 0
    assert init_tensor(gen, (3,), "one").sum() == 3
    with pytest.raises(ValueError):
        init_tensor(gen, (3,), "nope")


def test_activations_ported_so_far():
    """Every activation name of the JAX package, against its function on
    the same (positive, for log and sqrt) inputs, within 1e-6."""
    from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
    x = torch.tensor([[1.0, 2.0, 3.0]])
    sm = get_activation_fn("softmax")(x)
    np.testing.assert_allclose(sm.numpy(),
                               np.asarray(jax.nn.softmax(x.numpy())),
                               atol=1e-7)
    assert get_activation_fn("linear")(x) is x
    v = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    for name in jbase.ACTIVATIONS:
        xin = np.abs(v) + 0.1 if name in ("log", "sqrt") else 3 * v
        got = get_activation_fn(name)(torch.from_numpy(xin)).numpy()
        want = np.asarray(jbase.get_activation_fn(name)(jnp.asarray(xin)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="Unknown activation"):
        get_activation_fn("nope")
