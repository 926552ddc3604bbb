"""Attention ops: the flash-attention kernels (CUDA, Hopper) and their
plain PyTorch counterparts.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``.
:func:`flash_attention_blhd` is the entry the transformer blocks call. It
routes every shape the CUDA kernels take (a key bias or none, head dim 64
or 128, float32 or bfloat16, causal only with Lq <= Lk at the default
offset) to the kernels, and every other shape (a full (B, H, Lq, Lk)
bias, a chunked-prefill ``q_offset``, causal with Lq > Lk) to
:func:`attention_blockwise`. The TPU router's ``KERNEL_MIN_SEQ`` and
``% 128`` gates were Mosaic tuning and are not carried over: the CUDA
kernels mask their own ragged edges. The TPU package's ``ZOO_TPU_*``
routing switches are not ported either — nothing can hide the kernels.

On the kernel route, when an input needs a gradient, the call goes
through :class:`_FlashAttentionBLHD`, the counterpart of the TPU
package's custom VJP ``_flash_attention_blhd``: the forward kernel
(``csrc/flash_fwd.cu``) saves lse, and the backward runs the dq and dkv
kernels (``csrc/flash_bwd.cu``) through :func:`flash_backward_blhd`.
Without a gradient (serving) the forward kernel runs alone.

Each wrapper (:func:`flash_forward_blhd`, :func:`flash_backward_blhd`)
launches its kernels on CUDA tensors and runs its plain version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`) only
on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL_NAME = "flash_fwd"
DQ_KERNEL_NAME = "flash_bwd_dq"
DKV_KERNEL_NAME = "flash_bwd_dkv"
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Reference implementation (the test oracle)
# ---------------------------------------------------------------------------

def _causal_mask(lq: int, lk: int, q_offset, device) -> torch.Tensor:
    """(lq, lk) bool, True where query row i may see key j: j <= i + off,
    with off = lk - lq (bottom-right) unless ``q_offset`` pins it."""
    off = lk - lq if q_offset is None else int(q_offset)
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(off)


def attention_reference(q, k, v, bias=None, causal=False, sm_scale=None,
                        q_offset=None):
    """q,k,v: (B, H, L, D). bias broadcastable to (B, H, Lq, Lk).

    ``q_offset`` places causal query row 0 at absolute key position
    ``q_offset``; None keeps the bottom-right alignment ``lk - lq``.
    Logits are f32; probabilities round to v's dtype before the second
    product, as in the JAX reference."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        mask = _causal_mask(lq, lk, q_offset, logits.device)
        logits = torch.where(mask, logits,
                             torch.full_like(logits, DEFAULT_MASK_VALUE))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# Blockwise path: online softmax over key blocks, O(L) memory. Takes every
# shape the kernel declines.
# ---------------------------------------------------------------------------

def _fallback_block(n: int) -> int:
    """Key block length: 256 (then 128), the largest candidate strictly
    smaller than ``n`` that divides it, so any L >= 256 splits into at
    least two blocks and no (L, L) score tile is built; other lengths run
    as a single block."""
    for cand in (256, 128):
        if cand < n and n % cand == 0:
            return cand
    return n


def _blockwise_fwd_impl(q, k, v, bias, causal, sm_scale, block_k,
                        q_offset=None):
    """Returns (o, m, l): o (B, H, Lq, d) in q's dtype, and the per-row
    softmax max and denominator (B, H, Lq, 1) f32, kept apart (not folded
    into lse) as the JAX implementation does."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    offset = lk - lq if q_offset is None else int(q_offset)
    slice_k = bias is not None and bias.shape[3] == lk
    qf = q.float()
    acc = torch.zeros(b, h, lq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq, 1), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, h, lq, 1, dtype=torch.float32, device=q.device)
    q_pos = offset + torch.arange(lq, device=q.device)[:, None]
    for start in range(0, lk, block_k):
        k_blk = k[:, :, start:start + block_k].float()
        v_blk = v[:, :, start:start + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk) * sm_scale
        if bias is not None:
            bb = bias.float()
            s = s + (bb[..., start:start + block_k] if slice_k else bb)
        if causal:
            k_pos = start + torch.arange(block_k, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s,
                            torch.full_like(s, DEFAULT_MASK_VALUE))
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = correction * l + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v_blk.float())
        m = m_cur
    l_safe = torch.clamp(l, min=1e-30)
    return (acc / l_safe).to(q.dtype), m, l_safe


def attention_blockwise(q, k, v, bias=None, causal=False, sm_scale=None,
                        q_offset=None):
    """O(L)-memory attention: q,k,v (B, H, L, D) -> (B, H, L, D). Its
    gradient is PyTorch's autograd through these ops; the TPU package's
    hand-written blockwise backward is not ported yet."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None and bias.dim() != 4:
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    bk = _fallback_block(k.shape[2])
    return _blockwise_fwd_impl(q, k, v, bias, causal, sm_scale, bk,
                               q_offset)[0]


# ---------------------------------------------------------------------------
# The flash forward kernel: plain version and wrapper
# ---------------------------------------------------------------------------

def flash_forward_reference(q, k, v, kbias, causal, sm_scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same function, masking
    rules and outputs. q: (B, Lq, H, d); k, v: (B, Lk, H, d); kbias:
    (B, Lk) f32. Returns o (B, Lq, H, d) in q's dtype and lse (B*H, Lq)
    f32. Causal masking is bottom-right aligned (row i sees keys
    <= i + Lk - Lq), masked logits take DEFAULT_MASK_VALUE, and p rounds
    to v's dtype before p . v, as in the TPU kernel."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float()) * sm_scale
    s = s + kbias.float()[:, None, None, :]
    if causal:
        mask = _causal_mask(lq, lk, None, s.device)
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhlk,bkhd->blhd", p.to(v.dtype).float(), v.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).reshape(b * h, lq)
    return o.to(q.dtype), lse


def _check_kernel_args(q, k, v, kbias, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, L, H, d) q, k, v")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention takes head dim 64 or 128, got {d}")
    if causal and lq > lk:
        raise ValueError("causal flash attention needs Lq <= Lk")
    if min(b, lq, lk, h) < 1:
        raise ValueError("flash attention needs non-empty operands")
    if kbias.shape != (b, lk) or kbias.dtype != torch.float32:
        raise ValueError(f"key bias must be ({b}, {lk}) float32, got "
                         f"{tuple(kbias.shape)} {kbias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit head-dim stride")
    if kbias.stride(1) != 1:
        raise ValueError("key bias needs a unit key stride")
    devices = {t.device for t in (q, k, v, kbias)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


def flash_forward_blhd(q, k, v, kbias, causal=False, sm_scale=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash-attention forward kernel over (B, L, H, d) operands.

    Counterpart of ``_flash_forward_blhd`` (the TPU launcher of
    ``_flash_fwd_kernel``). q, k, v may be strided views (the reshape of a
    fused QKV projection); only the head dim must be unit-stride. Returns
    o (B, Lq, H, d) contiguous in q's dtype and lse (B*H, Lq) f32.

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` or raises; on CPU
    tensors it runs :func:`flash_forward_reference`."""
    _check_kernel_args(q, k, v, kbias, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, kbias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash forward runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_forward(q, k, v, kbias, causal, sm_scale)


def _launch_forward(q, k, v, kbias, causal, sm_scale):
    """The forward kernel's launch: operands off 16-byte boundaries
    copied (:func:`_aligned16`), o and lse allocated, one launch."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lib = _kernels.library()
    q, k, v = (_aligned16(t) for t in (q, k, v))
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.zoo_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d,
            KERNEL_DTYPES.index(q.dtype), int(bool(causal)),
            float(sm_scale),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            kbias.stride(0), stream)
    _kernels.check(err, KERNEL_NAME)
    _kernels.LAUNCHES.add(KERNEL_NAME, q.dtype)
    return o, lse


# ---------------------------------------------------------------------------
# The flash backward kernels (dq; dk, dv, dbias): plain version and wrapper
# ---------------------------------------------------------------------------

def _delta(o, do) -> torch.Tensor:
    """rowsum(dO * O) in f32, (B, Lq, H): the softmax-jacobian diagonal
    term, computed outside the kernels as the JAX wrapper computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_backward_reference(q, k, v, kbias, o, lse, do, causal, sm_scale
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: the same
    function, masking rules, rounding and outputs. Rebuilds s from q, k
    and the key bias under the forward's mask, then p = exp(s - lse),
    dp = dO . v^T, ds = p * (dp - delta) with delta = rowsum(dO * O),
    dq = ds . k * scale, dv = p^T . dO, dk = ds^T . q * scale, and the key
    bias gradient as ds's column sums over queries and heads. ds rounds
    to k's (q's) dtype before dq (dk) and p to dO's dtype before dv, where
    the TPU kernels round. Returns dq (B, Lq, H, d), dk, dv (B, Lk, H, d)
    in the operands' dtypes and dkb (B, Lk) f32."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float()) * sm_scale
    s = s + kbias.float()[:, None, None, :]
    if causal:
        mask = _causal_mask(lq, lk, None, s.device)
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.exp(s - lse.reshape(b, h, lq, 1))
    dof = do.float()
    dp = torch.einsum("blhd,bkhd->bhlk", dof, v.float())
    ds = p * (dp - _delta(o, do).permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhlk,bkhd->blhd", ds.to(k.dtype).float(),
                      k.float()) * sm_scale
    dk = torch.einsum("bhlk,blhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * sm_scale
    dv = torch.einsum("bhlk,blhd->bkhd", p.to(do.dtype).float(), dof)
    dkb = ds.sum(dim=2).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkb


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its start and its batch, length and head strides
    fall on 16-byte boundaries (the kernels copy tiles 16 bytes at a
    time), else a contiguous copy. The fused QKV projection's views
    at d in {64, 128} always qualify."""
    esize = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            (s * esize) % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_backward_blhd(q, k, v, kbias, o, lse, do, causal=False,
                        sm_scale=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor]:
    """The flash-attention backward kernels over (B, L, H, d) operands.

    Counterpart of ``_flash_backward_blhd`` (the TPU launcher of
    ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``). q, k, v, o
    and dO may be strided views; only the head dim must be unit-stride.
    lse is the forward's (B*H, Lq) f32. Returns dq, dk, dv contiguous in
    the operands' dtype and dkb (B, Lk) f32; delta and the head sum of
    the bias gradient are plain torch, as in JAX.

    On CUDA tensors this launches ``csrc/flash_bwd.cu`` (dq, then dkv) or
    raises; on CPU tensors it runs :func:`flash_backward_reference`. The
    kernels are deterministic: no atomics, each output summed by one block
    in a fixed order."""
    _check_kernel_args(q, k, v, kbias, causal)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, t in (("o", o), ("dO", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit head-dim stride")
    if lse.shape != (b * h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b * h}, {lq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, kbias, o, lse, do, causal,
                                        sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash backward runs on cuda or cpu, not "
                         f"{q.device}")
    lib = _kernels.library()
    q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    delta = _delta(o, do).contiguous()
    lse = lse.contiguous()
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=q.device)
    db = torch.empty((b * h, lk), dtype=torch.float32, device=q.device)
    strides = _kernels.strides_arg(q, k, v, do, dq, dk, dv, kbias.stride(0))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            kbias.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dims = (b, h, lq, lk, d, KERNEL_DTYPES.index(q.dtype),
            int(bool(causal)), float(sm_scale), strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.zoo_flash_bwd_dq(*args, dq.data_ptr(), *dims, stream)
        _kernels.check(err, DQ_KERNEL_NAME)
        _kernels.LAUNCHES.add(DQ_KERNEL_NAME, q.dtype)
        err = lib.zoo_flash_bwd_dkv(*args, dk.data_ptr(), dv.data_ptr(),
                                    db.data_ptr(), *dims, stream)
        _kernels.check(err, DKV_KERNEL_NAME)
        _kernels.LAUNCHES.add(DKV_KERNEL_NAME, q.dtype)
    return dq, dk, dv, db.reshape(b, h, lk).sum(dim=1)


class _FlashAttentionBLHD(torch.autograd.Function):
    """The kernel route with a gradient: the counterpart of the TPU
    package's custom VJP ``_flash_attention_blhd`` under its default
    save-lse-recompute-probs policy. Saves (q, k, v, kbias, o, lse); the
    backward runs :func:`flash_backward_blhd`."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, causal, sm_scale):
        o, lse = flash_forward_blhd(q, k, v, kbias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, kbias, o, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kbias, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv, dkb = flash_backward_blhd(q, k, v, kbias, o, lse, do,
                                              ctx.causal, ctx.sm_scale)
        return (dq, dk, dv, dkb if ctx.needs_input_grad[3] else None,
                None, None)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _as_key_bias(bias, b: int, lk: int, device=None
                 ) -> Optional[torch.Tensor]:
    """(B|1, 1, 1, Lk)-broadcastable bias -> (B, Lk) f32; no bias -> zeros;
    any other bias -> None (not a key bias)."""
    if bias is None:
        return torch.zeros(b, lk, dtype=torch.float32, device=device)
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 \
            and bias.shape[3] == lk and bias.shape[0] in (1, b):
        kb = bias.reshape(bias.shape[0], lk).float().contiguous()
        if bias.shape[0] == 1 and b > 1:
            kb = kb.expand(b, lk)
        return kb
    return None


def _route_eligible(kb, lq, lk, d, causal, dtype) -> bool:
    """Shapes the CUDA kernel takes: a key bias (or none), d in {64, 128},
    float32 or bfloat16, and causal only with lq <= lk (lq > lk would
    leave leading query rows fully masked; the blockwise path handles
    those)."""
    return (kb is not None and d in KERNEL_HEAD_DIMS and
            dtype in KERNEL_DTYPES and (not causal or lq <= lk) and
            lq >= 1 and lk >= 1)


def _kernel_route(q, k, v, bias, causal, q_offset):
    """The (B, Lk) key bias when the kernel takes these (B, L, H, d)
    operands, else None."""
    b, lq, _, d = q.shape
    lk = k.shape[1]
    # a non-default q_offset is the chunked-prefill rectangle; the kernel
    # hardcodes the bottom-right alignment
    if q_offset is not None and int(q_offset) != lk - lq:
        return None
    kb = _as_key_bias(bias, b, lk, q.device)
    if not _route_eligible(kb, lq, lk, d, causal, q.dtype):
        return None
    return kb


def flash_attention_blhd(q, k, v, bias=None, causal=False, sm_scale=None,
                         q_offset=None):
    """q,k,v: (B, L, H, D) -> (B, L, H, D), the layout a fused QKV
    projection's reshape produces with no copy. Kernel-eligible shapes run
    the kernels on these strided operands directly (through
    :class:`_FlashAttentionBLHD` when an input needs a gradient);
    everything else takes :func:`attention_blockwise` on transposed
    views."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kb = _kernel_route(q, k, v, bias, causal, q_offset)
    if kb is not None:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, kb)):
            return _FlashAttentionBLHD.apply(q, k, v, kb, causal, sm_scale)
        return flash_forward_blhd(q, k, v, kb, causal, sm_scale)[0]

    def tr(t):
        return t.transpose(1, 2)

    return tr(attention_blockwise(tr(q), tr(k), tr(v), bias=bias,
                                  causal=causal, sm_scale=sm_scale,
                                  q_offset=q_offset))


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    q_offset=None):
    """q,k,v: (B, H, L, D) -> (B, H, L, D). Same routing as
    :func:`flash_attention_blhd`: the kernel reads (B, H, L, D) operands
    through their (B, L, H, D) transposed views, so no copy is made."""
    def tr(t):
        return t.transpose(1, 2)

    return tr(flash_attention_blhd(tr(q), tr(k), tr(v), bias=bias,
                                   causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset))
