"""Attention ops: the flash-attention forward kernel (CUDA, Hopper) and
its plain PyTorch counterparts.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``, forward only.
:func:`flash_attention_blhd` is the entry the transformer blocks call. It
routes every shape the CUDA kernel takes (a key bias or none, head dim 64
or 128, float32 or bfloat16, causal only with Lq <= Lk at the default
offset) to :func:`flash_forward_blhd`, the kernel's wrapper, and every
other shape (a full (B, H, Lq, Lk) bias, a chunked-prefill ``q_offset``,
causal with Lq > Lk) to :func:`attention_blockwise`. The TPU router's
``KERNEL_MIN_SEQ`` and ``% 128`` gates were Mosaic tuning and are not
carried over: the CUDA kernel masks its own ragged edges. The TPU
package's ``ZOO_TPU_*`` routing switches are not ported either — nothing
can hide the kernel.

:func:`flash_forward_blhd` launches the kernel on CUDA tensors and runs
:func:`flash_forward_reference`, its plain version, only on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL_NAME = "flash_fwd"
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
    """O(L)-memory attention: q,k,v (B, H, L, D) -> (B, H, L, D), forward
    only (the backward arrives with the training slice)."""
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
        raise ValueError("flash forward takes (B, L, H, d) q, k, v")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash forward takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash forward takes head dim 64 or 128, got {d}")
    if causal and lq > lk:
        raise ValueError("causal flash forward needs Lq <= Lk")
    if min(b, lq, lk, h) < 1:
        raise ValueError("flash forward needs non-empty operands")
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
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, kbias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash forward runs on cuda or cpu, not "
                         f"{q.device}")
    lib = _kernels.library()
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
    _kernels.LAUNCHES.add(KERNEL_NAME)
    return o, lse


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
    the kernel on these strided operands directly; everything else takes
    :func:`attention_blockwise` on transposed views."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kb = _kernel_route(q, k, v, bias, causal, q_offset)
    if kb is not None:
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
