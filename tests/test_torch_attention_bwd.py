"""The attention backward's other routes against the JAX package on the CPU.

The blockwise route (every shape the flash kernels decline: a head dim
other than 64 or 128, a full (B, H, Lq, Lk) bias, a chunked-prefill
``q_offset``, causal with Lq > Lk) differentiates through the port's
``_BlockwiseAttention``, the counterpart of JAX's custom VJP
``_attention_blockwise``. Its dq, dk, dv and dbias are held against
``jax.grad`` of JAX's ``attention_blockwise``: float32 within 1e-5 of the
largest entry (both sides accumulate in f32 and differ in summation
order), bfloat16 within 2e-2 of it.

The ``full`` remat policy (``ZooConfig.flash_remat``,
``ZOO_TPU_FLASH_REMAT``) makes the kernel route's backward differentiate
through the reference attention: it is held against ``jax.grad`` of JAX's
``attention_reference`` within 1e-5, with the backward kernels' wrapper
never called.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import attention as ja
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.ops import attention as ta

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (b, h, lq, lk, d, bias, causal, q_offset); bias shapes by name:
# "full" (B, H, Lq, Lk), "b1qk" (B, 1, Lq, Lk), "1h1k" (1, H, 1, Lk),
# "b11k" (B, 1, 1, Lk), "bhq1" (B, H, Lq, 1: a key-broadcast bias)
CASES = [
    (2, 2, 64, 64, 80, "full", False, None),
    (2, 2, 64, 64, 32, "b1qk", True, None),
    (2, 3, 48, 64, 32, "1h1k", False, None),
    (2, 2, 96, 64, 32, None, True, None),
    (2, 2, 96, 64, 80, "b11k", True, None),
    (2, 2, 32, 96, 32, "full", True, 16),
    (1, 2, 64, 64, 80, "bhq1", True, None),
    (1, 2, 512, 512, 80, "1h1k", True, None),
    (1, 2, 256, 256, 32, "full", False, None),
]
# bfloat16 on the cases that reach every branch: d = 80, a full bias
# sliced by key block, causal Lq > Lk, a q_offset, L = 512
BF16_CASES = [CASES[i] for i in (0, 4, 5, 7, 8)]


def _bias_shape(kind, b, h, lq, lk):
    return {"full": (b, h, lq, lk), "b1qk": (b, 1, lq, lk),
            "1h1k": (1, h, 1, lk), "b11k": (b, 1, 1, lk),
            "bhq1": (b, h, lq, 1)}[kind]


def _inputs(seed, b, h, lq, lk, d, bias):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rs.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rs.standard_normal((b, h, lk, d)).astype(np.float32)
    do = rs.standard_normal((b, h, lq, d)).astype(np.float32)
    bb = None
    if bias is not None:
        bb = rs.standard_normal(_bias_shape(bias, b, h, lq, lk)).astype(
            np.float32)
    return q, k, v, bb, do


def _jax_grads(q, k, v, bb, do, causal, q_offset, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(x, jd) for x in (q, k, v)]
    if bb is not None:
        args.append(jnp.asarray(bb, jd))

    def f(q, k, v, *b):
        out = ja.attention_blockwise(q, k, v, bias=b[0] if b else None,
                                     causal=causal, q_offset=q_offset)
        return (out.astype(jnp.float32) * jnp.asarray(do)).sum()

    grads = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, bb, do, causal, q_offset, dtype, fn=None):
    td = getattr(torch, dtype)
    leaves = [torch.tensor(x).to(td).requires_grad_(True)
              for x in (q, k, v) + (() if bb is None else (bb,))]
    bias = leaves[3] if bb is not None else None
    out = (fn or ta.attention_blockwise)(leaves[0], leaves[1], leaves[2],
                                         bias=bias, causal=causal,
                                         q_offset=q_offset)
    (out.float() * torch.tensor(do)).sum().backward()
    return out, [t.grad.float().numpy() for t in leaves]


def _err(a, b):
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in CASES] +
                         [(c, "bfloat16") for c in BF16_CASES])
def test_blockwise_backward_matches_jax_grad(case, dtype):
    b, h, lq, lk, d, bias, causal, q_offset = case
    q, k, v, bb, do = _inputs(7, b, h, lq, lk, d, bias)
    # the kernel declines every one of these shapes
    kb = ta._as_key_bias(None if bb is None else torch.tensor(bb), b, lk)
    assert q_offset is not None or \
        not ta._route_eligible(kb, lq, lk, d, causal, torch.float32)
    out, got = _port_grads(q, k, v, bb, do, causal, q_offset, dtype)
    assert out.grad_fn.__class__ is ta._BlockwiseAttention._backward_cls
    want = _jax_grads(q, k, v, bb, do, causal, q_offset, dtype)
    names = ["dq", "dk", "dv", "dbias"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert _err(g, w) <= TOL[dtype], (name, _err(g, w))


@pytest.mark.parametrize("case", CASES[:6])
def test_blockwise_backward_matches_autograd_plain_version(case):
    """The plain version: autograd through the blockwise forward's ops,
    on the same inputs, float32 within 1e-5."""
    b, h, lq, lk, d, bias, causal, q_offset = case

    def plain(q, k, v, bias=None, causal=False, q_offset=None):
        with torch.enable_grad():
            return ta._blockwise_fwd_impl(
                q, k, v, bias, causal, 1.0 / np.sqrt(d),
                ta._fallback_block(k.shape[2]), q_offset)[0]

    q, k, v, bb, do = _inputs(11, b, h, lq, lk, d, bias)
    _, got = _port_grads(q, k, v, bb, do, causal, q_offset, "float32")
    _, want = _port_grads(q, k, v, bb, do, causal, q_offset, "float32",
                          fn=plain)
    for g, w in zip(got, want):
        assert _err(g, w) <= 1e-5


def _saved_numels(fn, q, k, v, bias):
    numels = []

    def pack(t):
        numels.append((tuple(t.shape), t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(q, k, v, bias)
    return out, numels


def test_blockwise_saves_o_of_l_tensors():
    """One blockwise call at L = 512 (two key blocks) saves q, k, v, the
    bias, o, m and l: no saved tensor has Lq·Lk elements. Autograd
    through the forward's ops, the old route, saves every block's score
    and probability tiles."""
    b, h, l, d = 1, 2, 512, 80
    q, k, v, bb, _ = _inputs(3, b, h, l, l, d, "b11k")
    leaves = [torch.tensor(x).requires_grad_(True) for x in (q, k, v, bb)]

    out, saved = _saved_numels(
        lambda q, k, v, bias: ta.attention_blockwise(q, k, v, bias,
                                                     causal=True),
        *leaves)
    assert out.grad_fn.__class__ is ta._BlockwiseAttention._backward_cls
    assert len(saved) == 7, saved
    assert all(n < l * l for _, n in saved), saved
    assert sum(n for _, n in saved) <= 5 * b * h * l * d + 2 * b * h * l + l

    _, old = _saved_numels(
        lambda q, k, v, bias: ta._blockwise_fwd_impl(
            q, k, v, bias, True, 1.0 / np.sqrt(d), 256)[0], *leaves)
    assert max(n for _, n in old) >= b * h * l * 256


def test_blockwise_skips_the_cotangent_of_a_bias_without_grad(monkeypatch):
    """A full (B, H, Lq, Lk) bias that needs no gradient (a mask or a
    position bias) gets no cotangent: the backward builds and reduces no
    dbias, and dq, dk, dv still match jax.grad of JAX's
    attention_blockwise."""
    b, h, l, d = 1, 2, 512, 80
    q, k, v, bb, do = _inputs(6, b, h, l, l, d, "full")
    dbs = []
    impl = ta._blockwise_bwd_impl

    def spy(*a, **kw):
        out = impl(*a, **kw)
        dbs.append(out[3])
        return out

    monkeypatch.setattr(ta, "_blockwise_bwd_impl", spy)
    leaves = [torch.tensor(x).requires_grad_(True) for x in (q, k, v)]
    bias = torch.tensor(bb)
    out = ta.attention_blockwise(*leaves, bias=bias, causal=True)
    (out * torch.tensor(do)).sum().backward()
    assert dbs == [None] and bias.grad is None

    def f(q, k, v):
        o = ja.attention_blockwise(q, k, v, bias=jnp.asarray(bb),
                                   causal=True)
        return (o * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    for t, w in zip(leaves, want):
        assert _err(t.grad.numpy(), np.asarray(w)) <= TOL["float32"]


def test_blockwise_forward_only_call_saves_nothing():
    q, k, v, _, _ = _inputs(5, 1, 2, 64, 64, 80, None)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, saved = _saved_numels(
        lambda q, k, v, bias: ta.attention_blockwise(q, k, v, bias),
        tq, tk, tv, None)
    assert saved == [] and out.grad_fn is None
    want = ja.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    assert _err(out.numpy(), np.asarray(want)) <= TOL["float32"]


def test_blhd_entry_takes_the_blockwise_function_for_declined_shapes():
    """flash_attention_blhd routes d = 80 to the blockwise Function and
    its gradient matches JAX's flash_attention_blhd (which takes its own
    blockwise route for d = 80)."""
    rs = np.random.default_rng(2)
    b, l, h, d = 2, 64, 2, 80
    q, k, v, do = (rs.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    kb = (0.5 * rs.standard_normal((b, l))).astype(np.float32)
    leaves = [torch.tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = ta.flash_attention_blhd(*leaves, bias=torch.tensor(
        kb)[:, None, None, :], causal=True)
    (out * torch.tensor(do)).sum().backward()

    def f(q, k, v):
        o = ja.flash_attention_blhd(q, k, v, bias=jnp.asarray(
            kb)[:, None, None, :], causal=True)
        return (o * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    for t, w in zip(leaves, want):
        assert _err(t.grad.numpy(), np.asarray(w)) <= TOL["float32"]


# ---------------------------------------------------------------------------
# the remat policy
# ---------------------------------------------------------------------------

@pytest.fixture
def no_context(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_FLASH_REMAT", raising=False)
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


@pytest.mark.parametrize("name,policy", [
    ("", "lse"), ("lse", "lse"), ("save-lse-recompute-probs", "lse"),
    ("kernel", "lse"), ("full", "full"), ("full-residual", "full"),
    ("xla", "full"), ("  FULL ", "full")])
def test_remat_policy_aliases_match_jax(no_context, monkeypatch, name,
                                        policy):
    monkeypatch.setenv("ZOO_TPU_FLASH_REMAT", name)
    assert ta._flash_remat_policy() == policy
    assert ja._flash_remat_policy() == policy
    assert ta._REMAT_POLICIES == ja._REMAT_POLICIES


def test_remat_policy_reads_the_context_and_its_env(no_context,
                                                    monkeypatch):
    assert ta._flash_remat_policy() == "lse"
    tnn.init_nncontext(tnn.ZooConfig(flash_remat="full-residual"),
                       device="cpu")
    assert ta._flash_remat_policy() == "full"
    # the environment comes first, as in JAX
    monkeypatch.setenv("ZOO_TPU_FLASH_REMAT", "lse")
    assert ta._flash_remat_policy() == "lse"
    monkeypatch.setenv("ZOO_TPU_FLASH_REMAT", "full")
    tnn.set_nncontext(None)
    assert tnn.ZooConfig.from_env().flash_remat == "full"


def test_unknown_remat_policy_raises(no_context, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FLASH_REMAT", "bogus")
    with pytest.raises(ValueError, match="unknown flash remat policy"):
        ta._flash_remat_policy()
    with pytest.raises(ValueError, match="unknown flash remat policy"):
        ja._flash_remat_policy()


def test_full_policy_backward_without_a_bias_grad():
    """``_reference_vjp_blhd`` with ``bias_grad`` False makes no bias
    leaf, returns None for it and the same dq, dk, dv."""
    rs = np.random.default_rng(7)
    b, l, h, d = 2, 48, 2, 64
    q, k, v, do = (torch.tensor(rs.standard_normal((b, l, h, d)).astype(
        np.float32)) for _ in range(4))
    kb = torch.tensor((0.5 * rs.standard_normal((b, l))).astype(np.float32))
    with_bias = ta._reference_vjp_blhd(q, k, v, kb, do, True, 0.125)
    without = ta._reference_vjp_blhd(q, k, v, kb, do, True, 0.125,
                                     bias_grad=False)
    assert len(without) == 4 and without[3] is None
    assert with_bias[3].shape == (b, l) and not kb.requires_grad
    for a, w in zip(without[:3], with_bias[:3]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("causal,lq,lk", [(False, 64, 64), (True, 48, 64)])
def test_full_policy_skips_the_backward_kernels(no_context, monkeypatch,
                                                causal, lq, lk):
    """Under ``full`` the kernel route's backward never calls
    ``flash_backward_blhd``; dq, dk, dv and the key bias's gradient equal
    jax.grad of JAX's attention_reference within 1e-5."""
    def refuse(*a, **k):
        raise AssertionError("flash_backward_blhd called under 'full'")

    monkeypatch.setattr(ta, "flash_backward_blhd", refuse)
    tnn.init_nncontext(tnn.ZooConfig(flash_remat="full"), device="cpu")
    rs = np.random.default_rng(4)
    b, h, d = 2, 2, 64
    q, do = (rs.standard_normal((b, lq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rs.standard_normal((b, lk, h, d)).astype(np.float32)
            for _ in range(2))
    kb = (0.5 * rs.standard_normal((b, 1, 1, lk))).astype(np.float32)
    leaves = [torch.tensor(x).requires_grad_(True) for x in (q, k, v, kb)]
    out = ta.flash_attention_blhd(*leaves[:3], bias=leaves[3],
                                  causal=causal)
    assert out.grad_fn.__class__ is ta._FlashAttentionBLHD._backward_cls
    (out * torch.tensor(do)).sum().backward()

    def f(q, k, v, kb):
        o = ja.attention_reference(q.transpose(0, 2, 1, 3),
                                   k.transpose(0, 2, 1, 3),
                                   v.transpose(0, 2, 1, 3), bias=kb,
                                   causal=causal)
        return (o.transpose(0, 2, 1, 3) * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(x)
                                               for x in (q, k, v, kb)))
    for t, w in zip(leaves, want):
        assert _err(t.grad.numpy(), np.asarray(w)) <= TOL["float32"]
