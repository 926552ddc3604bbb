"""The flash-attention forward kernel's arithmetic and launch path, on the
CPU.

On the card the float32 forward kernel (``csrc/flash_fwd.cu``) runs both
products on the tensor cores as three TF32 products ("3xTF32": x = hi + lo,
both halves TF32, the lo . lo term dropped), over 32-key tiles with an
online softmax in log2 units. The first tests emulate that arithmetic
here, tile by tile, and hold o and lse against JAX's
``attention_reference`` and ``logsumexp`` at ``chip_smoke.py``'s float32
limits (o: 1e-4 absolute; lse: 1e-4), in every float32 shape
``chip_smoke.py`` checks the kernel at (at a small batch and head count),
and show that a single TF32 product per product would miss them.

The last tests drive the wrapper's launch path with a stand-in for the
kernel library: operands off 16-byte boundaries reach the kernel as
aligned copies (its tiles arrive by 16-byte cp.async), and every C entry
point's ctypes declaration takes as many arguments as its C signature and
its Python call pass.
"""

import contextlib
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as ja
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as ta
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as tdln

# chip_smoke.py's float32 limits for the forward kernel
O_ATOL = 1e-4
LSE_TOL = 1e-4
# keys a streamed tile of the float32 kernel
F32_KEY_TILE = 32
LOG2E = 1.0 / math.log(2.0)

# chip_smoke.py's KERNEL_CASES (name, lq, lk, d, causal, key bias) at
# batch 1-2 and 2 heads
CASES = [
    ("train_shape", 1, 512, 512, 64, False, True),
    ("bert_base", 2, 512, 512, 64, False, True),
    ("causal_square", 1, 512, 512, 64, True, False),
    ("causal_lq_lt_lk", 1, 128, 512, 64, True, False),
    ("ragged_300", 2, 300, 300, 64, False, True),
    ("head_dim_128", 1, 512, 512, 128, True, True),
    ("decode_row", 2, 1, 77, 64, True, True),
    ("ragged_77", 2, 77, 77, 64, False, True),
    ("ragged_77_d128", 2, 77, 77, 128, False, True),
]
H = 2


def _inputs(seed, b, lq, lk, d, bias):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, lq, H, d)).astype(np.float32)
    k = rs.standard_normal((b, lk, H, d)).astype(np.float32)
    v = rs.standard_normal((b, lk, H, d)).astype(np.float32)
    kb = np.zeros((b, lk), np.float32)
    if bias:
        # BERT padding bias: -10000 on a ragged tail, noise elsewhere
        kb = (0.5 * rs.standard_normal((b, lk))).astype(np.float32)
        for i in range(b):
            kb[i, rs.integers(1, lk + 1):] = -10000.0
    return q, k, v, kb


def _jax_o_lse(q, k, v, kb, causal):
    """JAX's attention_reference (o) and logsumexp of its logits (lse),
    in the kernel's layouts: o (B, Lq, H, d), lse (B*H, Lq)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = ja.attention_reference(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        bias=jnp.asarray(kb)[:, None, None, :], causal=causal)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    logits = logits + jnp.asarray(kb)[:, None, None, :]
    if causal:
        mask = jnp.tril(jnp.ones((lq, lk), bool), k=lk - lq)
        logits = jnp.where(mask, logits, ja.DEFAULT_MASK_VALUE)
    lse = jax.scipy.special.logsumexp(logits, axis=-1).reshape(b * h, lq)
    return np.asarray(o.transpose(0, 2, 1, 3)), np.asarray(lse)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernels round (``tf32_rna`` in wgmma.cuh)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """a . b as three TF32 products, the small terms first: lo . hi +
    hi . lo + hi . hi. Products of TF32 values are exact in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + \
        torch.einsum(eq, a_hi, b_hi)


def _einsum_1xtf32(eq, a, b):
    """a . b as one TF32 product (``allow_tf32``'s arithmetic)."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _emulated_forward(einsum, q, k, v, kb, causal, scale):
    """The float32 kernel's function and arithmetic: 32-key tiles, logits
    in log2 units, masked entries dropped, the online softmax's running
    max and rescale, l summed unrounded, o = acc / max(l, 1e-30) and
    lse = m * ln 2 + log(l); both products taken by ``einsum``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    rows = torch.arange(lq)[:, None] + (lk - lq)
    m = torch.full((b, h, lq, 1), -math.inf)
    l = torch.zeros(b, h, lq, 1)
    acc = torch.zeros(b, h, lq, d)
    for k0 in range(0, lk, F32_KEY_TILE):
        kt, vt = k[:, k0:k0 + F32_KEY_TILE], v[:, k0:k0 + F32_KEY_TILE]
        x = einsum("blhd,bkhd->bhlk", q, kt) * (scale * LOG2E) + \
            kb[:, None, None, k0:k0 + F32_KEY_TILE] * LOG2E
        if causal:
            keys = k0 + torch.arange(kt.shape[1])[None, :]
            x = torch.where(keys <= rows, x, torch.full_like(x, -math.inf))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + einsum("bhlk,bkhd->bhld", p, vt)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    o = (acc / l_safe).permute(0, 2, 1, 3)
    lse = (m * math.log(2.0) + torch.log(l_safe)).reshape(b * h, lq)
    return o, lse


def _case(name, einsum):
    _, b, lq, lk, d, causal, bias = next(c for c in CASES if c[0] == name)
    q, k, v, kb = _inputs(5, b, lq, lk, d, bias)
    o, lse = _emulated_forward(einsum, *map(torch.from_numpy, (q, k, v, kb)),
                               causal, 1.0 / math.sqrt(d))
    jo, jlse = _jax_o_lse(q, k, v, kb, causal)
    return (float(np.abs(o.numpy() - jo).max()) / O_ATOL,
            float(np.abs(lse.numpy() - jlse).max()) / LSE_TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_3xtf32_forward_meets_the_float32_limits(name):
    o_over, lse_over = _case(name, _einsum_3xtf32)
    assert o_over <= 1.0 and lse_over <= 1.0, (o_over, lse_over)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_one_tf32_product_misses_the_float32_limits(name):
    o_over, lse_over = _case(name, _einsum_1xtf32)
    assert max(o_over, lse_over) > 1.0, (o_over, lse_over)


def test_tile_by_tile_emulation_is_the_plain_function():
    """In exact float32 products the emulation's online softmax is the
    plain version's function (flash_forward_reference)."""
    q, k, v, kb = map(torch.from_numpy, _inputs(6, 2, 77, 140, 64, True))
    exact = lambda eq, a, b: torch.einsum(eq, a, b)
    for causal in (False, True):
        o, lse = _emulated_forward(exact, q, k, v, kb, causal, 0.125)
        ro, rl = ta.flash_forward_reference(q, k, v, kb, causal, 0.125)
        torch.testing.assert_close(o, ro, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, rl, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the launch path, with a stand-in for the kernel library
# ---------------------------------------------------------------------------

_ENTRY_POINTS = ("zoo_flash_fwd", "zoo_flash_bwd_dq", "zoo_flash_bwd_dkv",
                 "zoo_dln_fwd", "zoo_dln_bwd", "zoo_dln_bwd_blocks")


class _FakeLibrary:
    """Records each call of a C entry point, after checking it against the
    ctypes declaration ``_kernels._bind`` gives it; returns 0 (no error)
    and, for the partial-row count, ``blocks``."""

    def __init__(self, blocks=5):
        self.calls = {}
        for name in _ENTRY_POINTS:
            setattr(self, name, self._entry(name, blocks))
        _kernels._bind(self)

    def _entry(self, name, blocks):
        def call(*args):
            assert len(args) == len(call.argtypes), (name, len(args))
            self.calls.setdefault(name, []).append(args)
            return blocks if name == "zoo_dln_bwd_blocks" else 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on CPU tensors: the library is a
    :class:`_FakeLibrary`, the device context and stream are stand-ins,
    and the launch counter is a fresh one."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "LAUNCHES", _kernels.LaunchCounter())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def test_forward_launch_copies_operands_off_16_byte_boundaries(fake_card):
    b, l, h, d = 2, 8, 2, 64
    qkv = torch.randn(b, l, 3 * h * d)
    q, k, _ = (t.reshape(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    off_start = torch.randn(b * l * h * d + 1)[1:].reshape(b, l, h, d)
    off_rows = torch.randn(b, l, h, d + 2)[..., :d]   # rows 264 bytes apart
    kb = torch.zeros(b, l)
    for v in (off_start, off_rows):
        o, lse = ta._launch_forward(q, k, v, kb, False, 0.125)
        args = fake_card.calls["zoo_flash_fwd"][-1]
        # the fused projection's views reach the kernel as they are
        assert args[0] == q.data_ptr() and args[1] == k.data_ptr()
        assert args[2] != v.data_ptr() and args[2] % 16 == 0
        # element strides (batch, length, head) of q, k, v, o: 16 bytes
        assert all(s * 4 % 16 == 0 for s in args[14:26]), args[14:26]
        assert args[4] == o.data_ptr() and o.is_contiguous()
        assert o.shape == (b, l, h, d) and lse.shape == (b * h, l)
    assert _kernels.LAUNCHES.get(ta.KERNEL_NAME) == 2


def test_backward_launch_sizes_the_partials_on_the_device(fake_card):
    """dln_bwd's call: the partial rows the device query gives (the stand-in
    says 5), two (5, D) partial buffers, and dgamma/dbeta as the call's
    own (D,) outputs."""
    n, d = 37, 770
    dy = torch.randn(n, d)
    stats = torch.ones(n, 1)
    bits = torch.zeros(n, d, dtype=torch.int32)
    dx, dres, dgamma, dbeta = tdln._launch_backward(
        dy, dy, bits, torch.ones(d), stats, stats, 0.9)
    assert fake_card.calls["zoo_dln_bwd_blocks"] == [(n,)]
    args, = fake_card.calls["zoo_dln_bwd"]
    g_part, b_part, g_ptr, b_ptr, rows, n_arg, d_arg = args[8:15]
    assert (rows, n_arg, d_arg) == (5, n, d)
    assert b_part - g_part == 5 * d * 4
    assert (g_ptr, b_ptr) == (dgamma.data_ptr(), dbeta.data_ptr())
    assert dgamma.shape == dbeta.shape == (d,)
    assert args[6:8] == (dx.data_ptr(), dres.data_ptr())
    assert _kernels.LAUNCHES.get(tdln.BWD_KERNEL_NAME) == 1


def _c_parameter_counts():
    """Each ``extern "C"`` function of csrc/*.cu: its number of
    parameters."""
    counts = {}
    for src in _kernels._sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            counts[m.group(1)] = len(params)
    return counts


def test_ctypes_declarations_match_the_c_signatures():
    counts = _c_parameter_counts()
    lib = _FakeLibrary()
    assert set(counts) == set(_ENTRY_POINTS)
    for name, n in counts.items():
        assert len(getattr(lib, name).argtypes) == n, name
