"""Ring attention: sequence parallelism by rotating K/V chunks.

Counterpart of ``analytics_zoo_tpu/parallel/ring_attention.py``. The
sequence axis is split over the ranks of a group: each rank holds a query
chunk, and the key/value chunks (with their slice of the key bias) rotate
around the ring by ``ppermute`` while an online-softmax accumulator folds
each arriving chunk: full attention with O(L/n) score memory a rank.
There are n-1 rotate-and-fold steps, and the last chunk is folded without
a final rotation (so one rank makes no ``ppermute`` at all). The causal
mask compares global positions (``rank * L_local + i``).

The fold is plain torch, as JAX's is plain ``jnp``: no kernel runs here.
Its backward is autograd through the fold, as JAX's is AD; the
``ppermute``'s backward sends the cotangents back around the ring
(``parallel/collectives.py``).

``axis_name`` is a mesh axis of the ambient context or a process group
(``ulysses.axis_group``); the ``*_sharded`` forms take and return global
arrays (``ulysses.sharded_seq_attention``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import DEFAULT_MASK_VALUE
from .collectives import group_rank, group_size, ppermute
from .ulysses import axis_group, sharded_seq_attention


def _ring(q, k, v, axis_name, causal, sm_scale, kbias, blhd: bool):
    """The ring over (B, Lq, H, d) operands (``blhd``) or (B, H, Lq, d)
    ones; scores, accumulators and the fold keep the operands' layout."""
    group = axis_group(axis_name)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n, idx = group_size(group), group_rank(group)
    if blhd:
        b, lq, h, d = q.shape
        lk = k.shape[1]
        scores, apply_p = "bqhd,bkhd->bqhk", "bqhk,bkhd->bqhd"
        acc_shape, stat_shape = (b, lq, h, d), (b, lq, h, 1)
    else:
        b, h, lq, d = q.shape
        lk = k.shape[2]
        scores, apply_p = "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"
        acc_shape, stat_shape = (b, h, lq, d), (b, h, lq, 1)
    dev = q.device
    qf = q.float()

    def chunk_scores(k_chunk, src, kb_chunk):
        s = torch.einsum(scores, qf, k_chunk.float()) * sm_scale
        if kb_chunk is not None:
            s = s + kb_chunk.float()[:, None, None, :]
        if causal:
            q_pos = idx * lq + torch.arange(lq, device=dev)[:, None]
            k_pos = src * lk + torch.arange(lk, device=dev)[None, :]
            keep = q_pos >= k_pos
            keep = keep[None, :, None, :] if blhd else keep[None, None]
            s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        return s

    def fold(acc, k_cur, v_cur, src, kb_cur):
        o, m, l = acc
        s = chunk_scores(k_cur, src, kb_cur)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = correction * l + p.sum(dim=-1, keepdim=True)
        o = o * correction + torch.einsum(apply_p, p, v_cur.float())
        return o, m_cur, l

    acc = (torch.zeros(acc_shape, device=dev),
           torch.full(stat_shape, -math.inf, device=dev),
           torch.zeros(stat_shape, device=dev))
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur, kb_cur = k, v, kbias
    for i in range(n - 1):
        # ring step i holds the chunk that started at rank idx - i
        acc = fold(acc, k_cur, v_cur, (idx - i) % n, kb_cur)
        k_cur = ppermute(k_cur, group, perm)
        v_cur = ppermute(v_cur, group, perm)
        if kb_cur is not None:
            kb_cur = ppermute(kb_cur, group, perm)
    o, _, l = fold(acc, k_cur, v_cur, (idx - (n - 1)) % n, kb_cur)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention(q, k, v, axis_name, causal: bool = False,
                   sm_scale: Optional[float] = None, kbias=None):
    """This rank's q, k, v: (B, H, L_local, D); returns (B, H, L_local,
    D). ``kbias``: this rank's additive key bias (B, L_local), the
    padding-mask form, rotating with its K/V chunk."""
    return _ring(q, k, v, axis_name, causal, sm_scale, kbias, blhd=False)


def ring_attention_blhd(q, k, v, axis_name, causal: bool = False,
                        sm_scale: Optional[float] = None, kbias=None):
    """This rank's q, k, v: (B, L_local, H, D); returns (B, L_local, H,
    D): the fold keeps the query length ahead of the heads, so a fused
    QKV projection's (B, L, H, d) reshape enters and leaves with no
    transpose."""
    return _ring(q, k, v, axis_name, causal, sm_scale, kbias, blhd=True)


def ring_attention_sharded(q, k, v, mesh, causal=False, sm_scale=None,
                           seq_axis: str = "seq", kbias=None):
    """(B, H, L, D) global arrays, L split over ``seq_axis``."""
    return sharded_seq_attention(ring_attention, q, k, v, mesh,
                                 causal=causal, sm_scale=sm_scale,
                                 seq_axis=seq_axis, kbias=kbias)


def ring_attention_blhd_sharded(q, k, v, mesh, causal=False,
                                sm_scale=None, seq_axis: str = "seq",
                                kbias=None):
    """(B, L, H, D) global arrays, L split over ``seq_axis``."""
    return sharded_seq_attention(ring_attention_blhd, q, k, v, mesh,
                                 causal=causal, sm_scale=sm_scale,
                                 seq_axis=seq_axis, kbias=kbias,
                                 layout="blhd")
