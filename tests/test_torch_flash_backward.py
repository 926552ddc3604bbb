"""The port's flash-attention backward against the JAX package on the CPU.

On CPU tensors the backward wrapper runs its plain version, so these tests
hold the plain version of the two backward kernels (dq; dk, dv and the
key-bias gradient) against the TPU kernels themselves
(``_flash_backward_blhd`` in Pallas interpret mode) and against
``jax.grad`` of JAX's ``attention_reference``, and hold the autograd
wiring of ``flash_attention_blhd`` against the same. The CUDA kernels are
held against this plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerance: float32 on both sides, sums taken in another order: 1e-5 on
dq, dk and dv (their entries are O(1)), and 1e-5 of the largest entry on
the key-bias gradient, a sum over every query and head.

On the card the float32 kernels run every product on the tensor cores as
three TF32 products ("3xTF32"). The last tests emulate that arithmetic
here and hold it to the card's float32 limits against ``jax.grad``, and
show that a single TF32 product would not meet them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as ja
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as ta

TOL = 1e-5

# the forward's case list (tests/test_torch_attention.py): causal and not,
# key bias and none, causal Lq < Lk, a one-row query, ragged lengths, d=128
CASES = [
    (2, 128, 128, 2, 64, False, True),
    (2, 128, 128, 2, 64, True, False),
    (2, 64, 192, 2, 64, True, True),
    (1, 1, 77, 2, 64, True, False),
    (2, 100, 100, 3, 64, False, True),
    (1, 131, 131, 2, 128, True, True),
]


def _inputs(seed, b, lq, lk, h, d):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rs.standard_normal((b, lk, h, d)).astype(np.float32)
    do = rs.standard_normal((b, lq, h, d)).astype(np.float32)
    # BERT padding bias: -10000 on a ragged tail, noise elsewhere
    kb = (0.5 * rs.standard_normal((b, lk))).astype(np.float32)
    for i in range(b):
        kb[i, rs.integers(1, lk + 1):] = -10000.0
    return q, k, v, do, kb


def _jax_grads(q, k, v, do, kb, causal):
    """jax.grad of attention_reference, in the (B, L, H, d) layout."""
    def f(q, k, v, kb):
        out = ja.attention_reference(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), bias=kb[:, None, None, :],
            causal=causal)
        return out.transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, kb)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _assert_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        g = np.asarray(g).reshape(np.shape(w))
        tol = TOL if name != "dbias" else TOL * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", CASES)
def test_plain_backward_matches_the_tpu_kernels_and_jax_grad(
        monkeypatch, b, lq, lk, h, d, causal, bias):
    monkeypatch.setenv("ZOO_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do, kb = _inputs(0, b, lq, lk, h, d)
    if not bias:
        kb = np.zeros_like(kb)
    sm = 1.0 / math.sqrt(d)
    tq, tk, tv, tdo, tkb = map(torch.from_numpy, (q, k, v, do, kb))
    o, lse = ta.flash_forward_reference(tq, tk, tv, tkb, causal, sm)
    got = ta.flash_backward_blhd(tq, tk, tv, tkb, o, lse, tdo, causal)
    assert [g.dtype for g in got] == [torch.float32] * 4
    assert got[3].shape == (b, lk)
    jq, jk, jv, jkb, jdo = map(jnp.asarray, (q, k, v, kb, do))
    jo, jlse = ja._flash_forward_blhd(jq, jk, jv, jkb, causal, sm, lq, lk)
    kernels = ja._flash_backward_blhd(jq, jk, jv, jkb, jo, jlse, jdo, causal,
                                      sm, lq, lk)
    _assert_grads([g.numpy() for g in got], [np.asarray(g) for g in kernels])
    _assert_grads([g.numpy() for g in got], _jax_grads(q, k, v, do, kb,
                                                       causal))


@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", CASES)
def test_autograd_through_flash_attention_matches_jax_grad(
        b, lq, lk, h, d, causal, bias):
    q, k, v, do, kb = _inputs(1, b, lq, lk, h, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tbias = torch.from_numpy(kb[:, None, None, :].copy()).requires_grad_() \
        if bias else None
    out = ta.flash_attention_blhd(tq, tk, tv, bias=tbias, causal=causal)
    assert isinstance(out.grad_fn, ta._FlashAttentionBLHD._backward_cls)
    inputs = (tq, tk, tv) + ((tbias,) if bias else ())
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(do))
    want = _jax_grads(q, k, v, do, kb if bias else np.zeros_like(kb), causal)
    _assert_grads([g.numpy() for g in grads], want[:len(grads)])


def test_kernel_route_keeps_autograd_history_when_the_kernel_output_has_none(
        monkeypatch):
    """The fault of the first slice, reproduced on the CPU: on the card
    the forward wrapper fills a fresh ``torch.empty`` through ctypes, so
    its output has no autograd history. With the wrapper made to return
    such tensors here, ``flash_attention_blhd`` must still return a tensor
    whose backward runs the backward wrapper and gives JAX's gradients."""
    real_fwd = ta.flash_forward_blhd
    calls = []

    def fwd_without_history(*a, **kw):
        with torch.no_grad():
            return real_fwd(*a, **kw)

    monkeypatch.setattr(ta, "flash_forward_blhd", fwd_without_history)
    q, k, v, do, kb = _inputs(2, 2, 128, 128, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ta.flash_attention_blhd(tq, tk, tv, bias=torch.from_numpy(
        kb[:, None, None, :].copy()))
    assert out.requires_grad, "the kernel route dropped autograd history"
    real_bwd = ta.flash_backward_blhd

    def bwd_spy(*a, **kw):
        calls.append(a)
        return real_bwd(*a, **kw)

    monkeypatch.setattr(ta, "flash_backward_blhd", bwd_spy)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert len(calls) == 1
    _assert_grads([g.numpy() for g in grads],
                  _jax_grads(q, k, v, do, kb, False)[:3])


def test_serving_skips_the_autograd_function():
    """Without a gradient (inference) the route is the forward kernel's
    wrapper alone, and on the CPU no launch is counted."""
    _kernels.LAUNCHES.reset()
    q = torch.randn(2, 64, 2, 64)
    with torch.inference_mode():
        out = ta.flash_attention_blhd(q, q, q)
    assert out.grad_fn is None
    assert _kernels.LAUNCHES.snapshot() == {}


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.randn(1, 16, 2, 64)
    kb = torch.zeros(1, 16)
    o, lse = ta.flash_forward_blhd(q, q, q, kb)
    with pytest.raises(ValueError, match="dO must be"):
        ta.flash_backward_blhd(q, q, q, kb, o, lse, o[:, :8])
    with pytest.raises(ValueError, match="lse must be"):
        ta.flash_backward_blhd(q, q, q, kb, o, lse[:1], o)
    with pytest.raises(ValueError, match="unit head-dim stride"):
        dot = torch.randn(1, 16, 64, 2).transpose(2, 3)
        ta.flash_backward_blhd(q, q, q, kb, o, lse, dot)


# ---------------------------------------------------------------------------
# 3xTF32: the float32 kernels' product arithmetic, emulated
# ---------------------------------------------------------------------------

# chip_smoke.py's float32 limit for K2/K3: |g - w| <= a * max|w| + r * |w|
F32_LIMIT = (1e-5, 1e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """a . b as the kernels take it in float32: a = a_hi + a_lo and
    b = b_hi + b_lo, each half TF32, and lo . lo dropped. Products of TF32
    values are exact in float32; sums are float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + \
        torch.einsum(eq, a_hi, b_hi)


def _einsum_1xtf32(eq, a, b):
    """a . b as one TF32 product (``allow_tf32``'s arithmetic)."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _emulated_backward(einsum, q, k, v, kb, o, lse, do, causal, scale):
    """The backward kernels' function (flash_backward_reference) with
    every product taken by ``einsum``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = einsum("blhd,bkhd->bhlk", q, k) * scale + kb[:, None, None, :]
    if causal:
        keep = torch.arange(lk)[None, :] <= torch.arange(lq)[:, None] + \
            (lk - lq)
        s = torch.where(keep, s, torch.full_like(s, ta.DEFAULT_MASK_VALUE))
    p = torch.exp(s - lse.reshape(b, h, lq, 1))
    dp = einsum("blhd,bkhd->bhlk", do, v)
    ds = p * (dp - (do * o).sum(-1).permute(0, 2, 1)[..., None])
    dq = einsum("bhlk,bkhd->blhd", ds, k) * scale
    dk = einsum("bhlk,blhd->bkhd", ds, q) * scale
    dv = einsum("bhlk,blhd->bkhd", p, do)
    return dq, dk, dv, ds.sum(dim=2).sum(dim=1)


def _over_f32_limit(got, want):
    """max over the entries of |got - want| / (a * max|want| + r * |want|)
    for dq, dk, dv and dbias."""
    a, r = F32_LIMIT
    out = {}
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        g = np.asarray(g, np.float64).reshape(np.shape(w))
        w = np.asarray(w, np.float64)
        out[name] = float((np.abs(g - w) /
                           (a * np.abs(w).max() + r * np.abs(w))).max())
    return out


TF32_CASES = [(l, d, causal) for l in (128, 300) for d in (64, 128)
              for causal in (False, True)]


def _tf32_case(l, d, causal, einsum):
    q, k, v, do, kb = _inputs(3, 2, l, l, 2, d)
    tq, tk, tv, tdo, tkb = map(torch.from_numpy, (q, k, v, do, kb))
    sm = 1.0 / math.sqrt(d)
    o, lse = ta.flash_forward_reference(tq, tk, tv, tkb, causal, sm)
    got = _emulated_backward(einsum, tq, tk, tv, tkb, o, lse, tdo, causal,
                             sm)
    return _over_f32_limit([g.numpy() for g in got],
                           _jax_grads(q, k, v, do, kb, causal))


@pytest.mark.parametrize("l,d,causal", TF32_CASES)
def test_3xtf32_products_meet_the_float32_limits(l, d, causal):
    over = _tf32_case(l, d, causal, _einsum_3xtf32)
    assert max(over.values()) <= 1.0, over


@pytest.mark.parametrize("l,d,causal", TF32_CASES)
def test_one_tf32_product_misses_the_float32_limits(l, d, causal):
    over = _tf32_case(l, d, causal, _einsum_1xtf32)
    assert max(over[n] for n in ("dq", "dk", "dv")) > 1.0, over


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12], dtype=torch.float32)
    want = [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
            -(1.0 + 2 ** -10), 1.0]
    assert _tf32(x).tolist() == want


def test_backward_operands_off_16_byte_boundaries_are_copied():
    """The backward kernels copy 16-byte chunks: the fused projection's
    views reach them as they are, a view whose start is off a 16-byte
    boundary as a contiguous copy."""
    qkv = torch.randn(2, 8, 3 * 2 * 64)
    q = qkv[..., :128].reshape(2, 8, 2, 64)
    assert ta._aligned16(q) is q
    odd = torch.randn(2 * 8 * 2 * 64 + 1)[1:].reshape(2, 8, 2, 64)
    got = ta._aligned16(odd)
    assert got is not odd and got.data_ptr() % 16 == 0
    assert torch.equal(got, odd)
