"""Port attention (analytics_zoo_tpu_torch.ops.attention) against the JAX
package on the CPU.

On CPU tensors the kernel wrapper runs its plain version, so these tests
hold the routing, masking, padding and layout logic around the CUDA
kernel against JAX's ``attention_reference``, JAX's
``flash_attention_blhd`` and — in interpret mode — the TPU kernel itself.
The kernel is held against the same plain version on the GPU
(tests/test_torch_gpu.py, chip_smoke.py). Everything compares in float32
with a 1e-5 tolerance: both sides accumulate in f32 and differ only in
summation order.
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


def _inputs(seed, b, lq, lk, h, d, bias):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rs.standard_normal((b, lk, h, d)).astype(np.float32)
    kb = None
    if bias:
        # BERT padding bias: -10000 on a ragged tail, noise elsewhere
        kb = (0.5 * rs.standard_normal((b, lk))).astype(np.float32)
        for i in range(b):
            kb[i, rs.integers(1, lk + 1):] = -10000.0
    return q, k, v, kb


def _bhld(x):
    return np.transpose(x, (0, 2, 1, 3))


def _jax_reference(q, k, v, kb, causal, q_offset=None):
    bias = None if kb is None else jnp.asarray(kb[:, None, None, :])
    out = ja.attention_reference(jnp.asarray(_bhld(q)), jnp.asarray(_bhld(k)),
                                 jnp.asarray(_bhld(v)), bias=bias,
                                 causal=causal, q_offset=q_offset)
    return _bhld(np.asarray(out))


# (b, lq, lk, h, d, causal, bias): causal and not, key bias and none,
# causal Lq < Lk (bottom-right), ragged lengths, both head dims
KERNEL_CASES = [
    (2, 128, 128, 2, 64, False, True),
    (2, 128, 128, 2, 64, True, False),
    (2, 64, 192, 2, 64, True, True),
    (1, 1, 77, 2, 64, True, False),
    (2, 100, 100, 3, 64, False, True),
    (1, 131, 131, 2, 128, True, True),
]


@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", KERNEL_CASES)
def test_blhd_matches_jax(b, lq, lk, h, d, causal, bias):
    q, k, v, kb = _inputs(0, b, lq, lk, h, d, bias)
    bias4 = None if kb is None else kb[:, None, None, :]
    o = ta.flash_attention_blhd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias4 is None else torch.from_numpy(bias4),
        causal=causal).numpy()
    assert o.shape == (b, lq, h, d)
    np.testing.assert_allclose(o, _jax_reference(q, k, v, kb, causal),
                               atol=TOL, rtol=0)
    jo = ja.flash_attention_blhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias4 is None else jnp.asarray(bias4), causal=causal)
    np.testing.assert_allclose(o, np.asarray(jo), atol=TOL, rtol=0)


@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", KERNEL_CASES)
def test_lse_matches_jax_logsumexp(b, lq, lk, h, d, causal, bias):
    q, k, v, kb = _inputs(1, b, lq, lk, h, d, bias)
    kbt = torch.zeros(b, lk) if kb is None else torch.from_numpy(kb)
    _, lse = ta.flash_forward_blhd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), kbt, causal)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    logits = logits + jnp.asarray(kbt.numpy())[:, None, None, :]
    if causal:
        mask = jnp.tril(jnp.ones((lq, lk), bool), k=lk - lq)
        logits = jnp.where(mask, logits, ja.DEFAULT_MASK_VALUE)
    ref = jax.scipy.special.logsumexp(logits, axis=-1).reshape(b * h, lq)
    assert lse.shape == (b * h, lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_plain_version_matches_tpu_kernel_in_interpret_mode(monkeypatch):
    """The TPU kernel itself (``_flash_forward_blhd``, the launcher on the
    serving path) in Pallas interpret mode, against the port's plain
    version of the CUDA kernel: o and lse."""
    monkeypatch.setenv("ZOO_TPU_PALLAS_INTERPRET", "1")
    b, l, h, d = 1, 128, 2, 64
    q, k, v, kb = _inputs(2, b, l, l, h, d, True)
    sm = 1.0 / math.sqrt(d)
    for causal in (False, True):
        jo, jlse = ja._flash_forward_blhd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
            causal, sm, 128, 128)
        o, lse = ta.flash_forward_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kb), causal, sm)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(),
                                   np.asarray(jlse).reshape(b * h, l),
                                   atol=TOL, rtol=0)


def test_reference_and_blockwise_match_jax():
    """The two plain paths the kernel declines to: a full (B, H, Lq, Lk)
    bias, a chunked-prefill q_offset, causal Lq > Lk."""
    rs = np.random.default_rng(3)
    b, h, d = 2, 2, 32
    for lq, lk, causal, q_offset, full_bias in [
            (256, 256, False, None, True), (64, 512, True, 100, False),
            (256, 128, True, None, False), (96, 96, True, None, True)]:
        q = rs.standard_normal((b, h, lq, d)).astype(np.float32)
        k = rs.standard_normal((b, h, lk, d)).astype(np.float32)
        v = rs.standard_normal((b, h, lk, d)).astype(np.float32)
        bias = (rs.standard_normal((b, h, lq, lk)).astype(np.float32)
                if full_bias else None)
        ref = np.asarray(ja.attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            bias=None if bias is None else jnp.asarray(bias),
            causal=causal, q_offset=q_offset))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        tb = None if bias is None else torch.from_numpy(bias)
        for fn in (ta.attention_reference, ta.attention_blockwise,
                   ta.flash_attention):
            out = fn(tq, tk, tv, bias=tb, causal=causal,
                     q_offset=q_offset).numpy()
            np.testing.assert_allclose(out, ref, atol=TOL, rtol=0,
                                       err_msg=fn.__name__)


@pytest.mark.parametrize("lq,lk,d,causal,bias_kind,q_offset,dtype,kernel", [
    (128, 128, 64, False, "key", None, torch.float32, True),
    (64, 128, 128, True, "none", None, torch.bfloat16, True),
    (64, 128, 64, True, "none", 64, torch.float32, True),     # default off
    (7, 300, 64, False, "key1", None, torch.float32, True),   # (1,1,1,L)
    (128, 128, 64, False, "full", None, torch.float32, False),
    (64, 128, 64, True, "none", 10, torch.float32, False),    # prefill
    (128, 64, 64, True, "none", None, torch.float32, False),  # Lq > Lk
    (128, 128, 32, False, "none", None, torch.float32, False),
    (128, 128, 64, False, "none", None, torch.float16, False),
])
def test_router_sends_kernel_shapes_to_kernel(monkeypatch, lq, lk, d, causal,
                                              bias_kind, q_offset, dtype,
                                              kernel):
    calls = []
    real = ta.flash_forward_blhd

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(ta, "flash_forward_blhd", spy)
    b, h = 2, 2
    q = torch.randn(b, lq, h, d).to(dtype)
    k = torch.randn(b, lk, h, d).to(dtype)
    v = torch.randn(b, lk, h, d).to(dtype)
    bias = {"none": None, "key": torch.zeros(b, 1, 1, lk),
            "key1": torch.zeros(1, 1, 1, lk),
            "full": torch.zeros(b, h, lq, lk)}[bias_kind]
    o = ta.flash_attention_blhd(q, k, v, bias=bias, causal=causal,
                                q_offset=q_offset)
    assert o.shape == (b, lq, h, d) and o.dtype == dtype
    assert len(calls) == (1 if kernel else 0)
    if kernel:
        kb = calls[0][3]
        assert kb.shape == (b, lk) and kb.dtype == torch.float32


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.randn(1, 16, 2, 64)
    kb = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="head dim"):
        ta.flash_forward_blhd(q[..., :32], q[..., :32], q[..., :32], kb)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        ta.flash_forward_blhd(q, q[:, :8], q[:, :8], kb[:, :8], causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ta.flash_forward_blhd(q.half(), q.half(), q.half(), kb)
    with pytest.raises(ValueError, match="key bias"):
        ta.flash_forward_blhd(q, q, q, kb.double())
    with pytest.raises(ValueError, match="unit head-dim stride"):
        qt = torch.randn(1, 16, 64, 2).transpose(2, 3)
        ta.flash_forward_blhd(qt, qt, qt, kb)


def test_launch_counter_does_not_move_on_cpu():
    _kernels.LAUNCHES.reset()
    q = torch.randn(2, 64, 2, 64)
    ta.flash_forward_blhd(q, q, q, torch.zeros(2, 64))
    ta.flash_attention_blhd(q, q, q, causal=True)
    assert _kernels.LAUNCHES.get(ta.KERNEL_NAME) == 0
    assert _kernels.LAUNCHES.snapshot() == {}


def test_kernel_library_is_keyed_on_sources_and_built_lazily():
    """Importing the ops builds nothing; the library name hashes the
    sources and flags, and lands under build/torch_kernels/."""
    sources = _kernels._sources()
    assert [s.name for s in sources] == ["flash_fwd.cu"]
    assert len(_kernels._digest()) == 16
    assert _kernels._lib is None
    assert _kernels.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
