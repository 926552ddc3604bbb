"""The port's int8 ops (``ops/quant.py``) against the JAX package's on
the CPU, with inputs from a numpy seed and the same scales on both
sides.

- ``quantize_weight``: q and scale equal exactly (both in numpy).
- ``matmul`` and ``conv2d`` in every tier (float kernel, weight-only,
  calibrated, calibrated with a requantization multiplier), with and
  without bias, with relu, no activation and softmax: int8 outputs and
  the int32 accumulators equal exactly (integer products; the entry
  quantize divides by the same float32 scale and rounds half to even on
  both sides); float outputs within 1e-6 relative (float32 products and
  softmax in another order).
- the calibration recorder's ranges within 1e-6 relative.
- int8 max pooling equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import quant as jquant
from analytics_zoo_tpu.pipeline.api.keras.engine.base import \
    NamedActivation as JNamed
from analytics_zoo_tpu.pipeline.api.keras.layers import pooling as jpool
from analytics_zoo_tpu_torch.ops import quant as tquant
from analytics_zoo_tpu_torch.pipeline.api.keras.engine.base import \
    NamedActivation as TNamed
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    MaxPooling2D
from analytics_zoo_tpu_torch.utils.op_census import OpCensus

REL_TOL = 1e-6
ACTS = [None, "relu", "softmax"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, what
    if got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=REL_TOL,
                                   atol=REL_TOL * np.abs(want).max(),
                                   err_msg=what)


def _acts(name):
    return (None, None) if name is None else (JNamed(name), TNamed(name))


def _pair(w, name, tier, rs, x=None):
    """The kernel ``w`` in both packages in ``tier``: "float",
    "weight_only", "calibrated", "requant"."""
    if tier == "float":
        return jnp.asarray(w), torch.from_numpy(w)
    jq, tq = jquant.quantize_weight(w, name), tquant.quantize_weight(w, name)
    if tier == "weight_only":
        return jq, tq
    act_scale = float(np.abs(x).max()) / 127.0
    jq, tq = jq.with_act_scale(act_scale), tq.with_act_scale(act_scale)
    if tier == "requant":
        next_scale = rs.uniform(0.5, 2.0) * act_scale
        r = jquant.chain_requant(act_scale, np.asarray(jq.scale),
                                 next_scale)
        np.testing.assert_array_equal(
            tquant.chain_requant(act_scale, tq.scale, next_scale), r)
        jq, tq = jq.with_requant(r), tq.with_requant(r)
    return jq, tq


@pytest.mark.parametrize("shape", [(7, 5), (3, 3, 4, 6), (5, 5, 3, 8)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape) \
        .astype(np.float32)
    w[..., 0] = 0.0       # an all-zero channel takes the 1e-12 floor
    jq, tq = jquant.quantize_weight(w, "k"), tquant.quantize_weight(w, "k")
    _close(tq.q.numpy(), np.asarray(jq.q))
    _close(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    _close(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    assert tq.q.dtype == torch.int8 and tq.name == "k"


@pytest.mark.parametrize("tier", ["float", "weight_only", "calibrated",
                                  "requant"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("rows", [1, 16, 40])
def test_matmul_matches_jax(tier, act, use_bias, rows):
    rs = np.random.default_rng(rows + 7 * use_bias)
    x = rs.standard_normal((rows, 24)).astype(np.float32)
    w = rs.standard_normal((24, 12)).astype(np.float32) * 0.3
    b = rs.standard_normal(12).astype(np.float32) if use_bias else None
    jw, tw = _pair(w, "['d']['kernel']", tier, rs, x)
    ja, ta = _acts(act)
    want = jquant.matmul(jnp.asarray(x), jw,
                         None if b is None else jnp.asarray(b), ja)
    got = tquant.matmul(torch.from_numpy(x), tw,
                        None if b is None else torch.from_numpy(b), ta)
    _close(got.numpy(), np.asarray(want), f"{tier} {act}")
    if tier == "requant" and act != "softmax":
        assert got.dtype == torch.int8


def test_matmul_takes_int8_and_leading_dims():
    rs = np.random.default_rng(3)
    x = rs.integers(-127, 128, (2, 5, 16)).astype(np.int8)
    w = rs.standard_normal((16, 8)).astype(np.float32)
    jw = jquant.quantize_weight(w, "k").with_act_scale(0.05)
    tw = tquant.quantize_weight(w, "k").with_act_scale(0.05)
    want = jquant.matmul(jnp.asarray(x), jw, None, None)
    got = tquant.matmul(torch.from_numpy(x), tw, None, None)
    _close(got.numpy(), np.asarray(want))
    assert got.shape == (2, 5, 8)


CONVS = [  # (x shape, kernel (kh, kw, cin, out), strides, padding, dilation)
    ((2, 3, 9, 9), (3, 3, 3, 8), (1, 1), "SAME", (1, 1)),
    ((2, 3, 16, 16), (7, 7, 3, 16), (2, 2), "SAME", (1, 1)),   # k = 147
    ((1, 4, 10, 11), (3, 3, 4, 6), (2, 1), "VALID", (1, 1)),
    ((1, 4, 10, 10), (3, 3, 4, 8), (1, 1), "SAME", (2, 2)),
    ((3, 8, 5, 5), (1, 1, 8, 4), (1, 1), "VALID", (1, 1)),
]


@pytest.mark.parametrize("case", range(len(CONVS)))
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("tier", ["float", "weight_only", "calibrated",
                                  "requant"])
@pytest.mark.parametrize("act", ACTS)
def test_conv2d_matches_jax(case, layout, tier, act):
    xshape, kshape, strides, padding, dilation = CONVS[case]
    rs = np.random.default_rng(case)
    x = rs.standard_normal(xshape).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rs.standard_normal(kshape).astype(np.float32) * 0.2
    b = rs.standard_normal(kshape[-1]).astype(np.float32)
    dn = (layout, "HWIO", layout)
    jw, tw = _pair(w, "['c']['kernel']", tier, rs, x)
    ja, ta = _acts(act)
    want = jquant.conv2d(jnp.asarray(x), jw, strides, padding, dilation,
                         dn, jnp.asarray(b), ja)
    got = tquant.conv2d(torch.from_numpy(x), tw, strides, padding,
                        dilation, dn, torch.from_numpy(b), ta)
    _close(got.numpy(), np.asarray(want), f"{tier} {act}")


@pytest.mark.parametrize("case", range(len(CONVS)))
def test_int8_accumulators_equal_jax(case):
    """The int32 accumulators themselves, from int8 inputs: the port's
    im2col and integer product against XLA's int32 convolution, and the
    product against numpy's int64 one."""
    xshape, kshape, strides, padding, dilation = CONVS[case]
    rs = np.random.default_rng(10 + case)
    x = rs.integers(-127, 128, xshape).astype(np.int8)
    w = rs.integers(-127, 128, kshape).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), strides, padding,
        rhs_dilation=dilation, dimension_numbers=("NCHW", "HWIO", "NCHW"),
        preferred_element_type=jnp.int32)
    qt = tquant.QuantTensor(torch.from_numpy(w), torch.ones(1))
    acc = tquant._conv_int8(torch.from_numpy(x), qt, strides, padding,
                            dilation, ("NCHW", "HWIO", "NCHW"))
    _close(acc.permute(0, 3, 1, 2).numpy(), np.asarray(want))
    a = rs.integers(-127, 128, (5, int(np.prod(kshape[:3])))) \
        .astype(np.int8)
    got = tquant.int_product(torch.from_numpy(a), qt)
    ref = a.astype(np.int64) @ w.reshape(-1, kshape[-1]).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int32


def test_calibration_recorder_matches_jax():
    rs = np.random.default_rng(5)
    x = rs.standard_normal((4, 3, 8, 8)).astype(np.float32)
    w = rs.standard_normal((3, 3, 3, 4)).astype(np.float32)
    dn = ("NCHW", "HWIO", "NCHW")
    jw, tw = (m.quantize_weight(w, "['c']['kernel']")
              for m in (jquant, tquant))
    with jquant.calibrating() as jr:
        jquant.conv2d(jnp.asarray(x), jw, (1, 1), "SAME", None, dn, None,
                      JNamed("relu"))
    with tquant.calibrating() as tr:
        tquant.conv2d(torch.from_numpy(x), tw, (1, 1), "SAME", None, dn,
                      None, TNamed("relu"))
    assert set(tr) == set(jr) == {"['c']['kernel']",
                                  "['c']['kernel']::out"}
    for k in jr:
        assert tr[k] == pytest.approx(jr[k], rel=REL_TOL)
    assert tquant.calibration_scales(tr) == pytest.approx(
        jquant.calibration_scales(jr), rel=REL_TOL)


@pytest.mark.parametrize("border_mode", ["valid", "same"])
@pytest.mark.parametrize("dim_ordering", ["th", "tf"])
def test_int8_max_pooling_matches_jax(border_mode, dim_ordering):
    rs = np.random.default_rng(2)
    shape = (2, 3, 7, 7) if dim_ordering == "th" else (2, 7, 7, 3)
    x = rs.integers(-128, 128, shape).astype(np.int8)
    x.flat[0] = -128    # a -128 next to SAME padding stays -128
    want = jpool._pool2d(jnp.asarray(x), (2, 2), (2, 2),
                         "SAME" if border_mode == "same" else "VALID",
                         "max", dim_ordering)
    got = MaxPooling2D((2, 2), border_mode=border_mode,
                       dim_ordering=dim_ordering)(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want))


def test_chained_matmul_divides_once():
    """A requantizing kernel feeding the next one: one division (the
    entry quantize), two int32 products, two roundings."""
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.standard_normal((20, 16)).astype(np.float32))
    w1, w2 = (tquant.quantize_weight(
        rs.standard_normal(s).astype(np.float32), n)
        for s, n in (((16, 8), "a"), ((8, 4), "b")))
    w2 = w2.with_act_scale(0.1)
    w1 = w1.with_act_scale(0.02).with_requant(
        tquant.chain_requant(0.02, w1.scale, 0.1))
    relu = TNamed("relu")
    with OpCensus() as census:
        h = tquant.matmul(x, w1, None, relu)
        y = tquant.matmul(h, w2, None, None)
    assert h.dtype == torch.int8 and y.dtype == torch.float32
    s = census.int8_summary()
    assert (s["int32_products"], s["float_products"], s["roundings"],
            s["divisions"]) == (2, 0, 2, 1)
