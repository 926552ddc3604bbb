"""The port's fused dropout + add + layer norm and its layer-norm backward
against the JAX package on the CPU.

The plain versions of the two CUDA kernels (``dln_forward_reference``,
``dln_backward_reference``) are held against the TPU kernels themselves
(``_dln_forward`` / ``_dln_backward`` in Pallas interpret mode), fed the
same uint32 bits from ``jax.random.bits``; the autograd wiring of
``dropout_add_layer_norm`` against ``jax.vjp`` of the JAX op's custom VJP
``_dln``; and the layer-norm backward against ``jax.grad`` of JAX's
``layer_norm``. The CUDA kernels are held against these plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerance: float32 on both sides, differing only in summation order and
rsqrt rounding: 1e-5 elementwise on values of order one (outputs, z, row
statistics, dx, dresid), and 1e-5 of the largest entry on dgamma/dbeta,
sums over every row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import fused_dropout_ln as jf
from analytics_zoo_tpu.ops.layernorm import layer_norm as jax_ln
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as tf
from analytics_zoo_tpu_torch.ops.layernorm import layer_norm

TOL = 1e-5


def _close(got, want, err_msg="", scaled=False):
    want = np.asarray(want)
    tol = TOL * max(1.0, np.abs(want).max()) if scaled else TOL
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want,
                               atol=tol, rtol=0, err_msg=err_msg)


def _case(seed, n, d):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, d)).astype(np.float32)
    r = (rs.standard_normal((n, d)) + 2.0).astype(np.float32)
    g = (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32)
    b = (0.1 * rs.standard_normal(d)).astype(np.float32)
    dy = rs.standard_normal((n, d)).astype(np.float32)
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n, d),
                                      jnp.uint32))
    return x, r, g, b, dy, bits


def _t(a):
    return torch.from_numpy(np.array(a))


def _tbits(bits):
    """The uint32 words as the port stores them: int32, same bits."""
    return torch.from_numpy(np.array(bits).view(np.int32))


# (rows, features, keep): the BERT width, a narrow one, Mosaic's block
# sizes of 8 and 512 rows, a low keep
DLN_CASES = [(64, 768, 0.9), (256, 128, 0.9), (8, 256, 0.75),
             (512, 384, 0.5)]


@pytest.mark.parametrize("n,d,keep", DLN_CASES)
def test_plain_versions_match_the_tpu_kernels(monkeypatch, n, d, keep):
    monkeypatch.setenv("ZOO_TPU_PALLAS_INTERPRET", "1")
    x, r, g, b, dy, bits = _case(0, n, d)
    block = jf._pick_rows(n)
    jy, jz, jmean, jinv = jf._dln_forward(*map(jnp.asarray, (x, r, bits, g,
                                                            b)),
                                          keep, 1e-5, block)
    y, z, mean, inv = tf.dln_forward(_t(x), _t(r), _tbits(bits), _t(g),
                                     _t(b), keep)
    assert y.dtype == z.dtype == torch.float32 and mean.shape == (n, 1)
    for name, got, want in (("y", y, jy), ("z", z, jz), ("mean", mean, jmean),
                            ("inv", inv, jinv)):
        _close(got, want, name)
    jdx, jdres, jdg, jdb = jf._dln_backward(
        jnp.asarray(dy), jz, jnp.asarray(bits), jnp.asarray(g), jmean, jinv,
        keep, block)
    dx, dres, dg, db = tf.dln_backward(_t(dy), z, _tbits(bits), _t(g), mean,
                                       inv, keep)
    _close(dx, jdx, "dx")
    _close(dres, jdres, "dres")
    # the TPU kernel's per-block partials, summed outside as JAX sums them
    _close(dg, np.asarray(jdg).sum(axis=(0, 1)), "dgamma", scaled=True)
    _close(db, np.asarray(jdb).sum(axis=(0, 1)), "dbeta", scaled=True)


@pytest.mark.parametrize("n,d,keep", DLN_CASES)
def test_autograd_matches_jax_vjp_of_the_custom_rule(monkeypatch, n, d,
                                                     keep):
    monkeypatch.setenv("ZOO_TPU_PALLAS_INTERPRET", "1")
    x, r, g, b, dy, bits = _case(1, n, d)
    y_ref, vjp = jax.vjp(
        lambda x, r, g, b: jf._dln(x, r, jnp.asarray(bits), g, b, keep,
                                   1e-5, jf._pick_rows(n)),
        *map(jnp.asarray, (x, r, g, b)))
    want = vjp(jnp.asarray(dy))
    tx, tr, tg, tb = (_t(a).requires_grad_() for a in (x, r, g, b))
    # the op's own shape: (batch, length, features) rows
    y = tf.dropout_add_layer_norm(tx.reshape(2, n // 2, d),
                                  tr.reshape(2, n // 2, d), tg, tb, None,
                                  1.0 - keep, bits=_tbits(bits))
    assert y.shape == (2, n // 2, d)
    assert isinstance(y.grad_fn.next_functions[0][0],
                      tf._DropoutAddLayerNorm._backward_cls)
    _close(y.detach(), y_ref, "y")
    got = torch.autograd.grad(y, (tx, tr, tg, tb),
                              _t(dy).reshape(2, n // 2, d))
    for name, gv, wv in zip(("dx", "dresid", "dgamma", "dbeta"), got, want):
        _close(gv, wv, name, scaled=name in ("dgamma", "dbeta"))


def test_the_op_draws_full_range_words_from_the_generator():
    """Training without given bits draws 32-bit words over the whole
    range from the generator (the TPU kernel thresholds uint32 words; a
    31-bit draw would keep every row), and the same seed gives the same
    output."""
    words = tf.draw_bits((256, 512), torch.Generator().manual_seed(0), "cpu")
    assert words.dtype == torch.int32
    assert 0.45 < (words < 0).float().mean().item() < 0.55
    assert 0.85 < tf._keep_mask(words, 0.9).float().mean().item() < 0.95
    x = torch.randn(4, 32, 128)
    args = (torch.zeros_like(x), torch.ones(128), torch.zeros(128))
    y1 = tf.dropout_add_layer_norm(x, *args, torch.Generator().manual_seed(3),
                                   0.1)
    y2 = tf.dropout_add_layer_norm(x, *args, torch.Generator().manual_seed(3),
                                   0.1)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)


def test_eligibility_and_the_composed_paths():
    """Inference and p=0 compose layer_norm(x + resid); rows wider than
    the kernel holds compose the same bits-based mask; no launch is
    counted on the CPU."""
    _kernels.LAUNCHES.reset()
    x, r = torch.randn(3, 5, 64), torch.randn(3, 5, 64)
    g, b = torch.ones(64), torch.zeros(64)
    gen = torch.Generator().manual_seed(0)
    want = layer_norm(x + r, g, b)
    for training, p in ((False, 0.1), (True, 0.0)):
        out = tf.dropout_add_layer_norm(x, r, g, b, gen, p, training)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    wide = tf.KERNEL_MAX_D + 128
    xw, rw = torch.randn(4, wide), torch.randn(4, wide)
    bits = tf.draw_bits((4, wide), gen, "cpu")
    out = tf.dropout_add_layer_norm(xw, rw, torch.ones(wide),
                                    torch.zeros(wide), None, 0.5, bits=bits)
    dropped = torch.where(tf._keep_mask(bits, 0.5), xw / 0.5,
                          torch.zeros_like(xw))
    torch.testing.assert_close(out, layer_norm(dropped + rw, torch.ones(wide),
                                               torch.zeros(wide)),
                               rtol=0, atol=1e-6)
    assert _kernels.LAUNCHES.snapshot() == {}
    with pytest.raises(ValueError, match="below 1"):
        tf.dropout_add_layer_norm(x, r, g, b, gen, 1.0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(8, 64)
    bits = torch.zeros(8, 64, dtype=torch.int32)
    g = torch.ones(64)
    with pytest.raises(ValueError, match="int32"):
        tf.dln_forward(x, x, bits.long(), g, g, 0.9)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tf.dln_forward(x.double(), x.double(), bits, g, g, 0.9)
    with pytest.raises(ValueError, match="D <="):
        wide = torch.randn(2, tf.KERNEL_MAX_D + 1)
        tf.dln_forward(wide, wide, torch.zeros(2, tf.KERNEL_MAX_D + 1,
                                               dtype=torch.int32),
                       torch.ones(tf.KERNEL_MAX_D + 1),
                       torch.ones(tf.KERNEL_MAX_D + 1), 0.9)
    with pytest.raises(ValueError, match="keep"):
        tf.dln_forward(x, x, bits, g, g, 1.0)
    with pytest.raises(ValueError, match="resid"):
        tf.dln_forward(x, x[:4], bits, g, g, 0.9)


@pytest.mark.parametrize("shape,eps,offset", [
    ((4, 9, 64), 1e-5, 0.0), ((4, 9, 64), 1e-12, 0.0),
    ((6, 128), 1e-5, 3.0), ((2, 3, 5, 32), 1e-12, 1.0)])
def test_layer_norm_backward_matches_jax_grad(shape, eps, offset):
    rs = np.random.default_rng(5)
    x = (rs.standard_normal(shape) + offset).astype(np.float32)
    g = rs.standard_normal(shape[-1]).astype(np.float32)
    b = rs.standard_normal(shape[-1]).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda x, g, b: jax_ln(x, g, b, eps),
                         *map(jnp.asarray, (x, g, b)))
    want = vjp(jnp.asarray(dy))
    tx, tg, tb = (_t(a).requires_grad_() for a in (x, g, b))
    y = layer_norm(tx, tg, tb, eps)
    _close(y.detach(), y_ref, "y")
    got = torch.autograd.grad(y, (tx, tg, tb), _t(dy))
    for name, gv, wv in zip(("dx", "dgamma", "dbeta"), got, want):
        _close(gv, wv, name, scaled=name != "dx")
