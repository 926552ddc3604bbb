"""Ulysses-style sequence parallelism: all-to-all head/sequence swap.

Counterpart of ``analytics_zoo_tpu/parallel/ulysses.py``. Activations
arrive split on the SEQUENCE axis over the ranks of a group; one
``all_to_all`` re-splits them on the HEAD axis, so each rank holds a
subset of the heads over the FULL sequence; attention runs locally
through the port's flash attention (on the card, the CUDA forward kernel
and, under autograd, its two backward kernels, at (B, L, H/n, d)); a
second ``all_to_all`` restores the sequence split. The key bias is
all-gathered to full length. The all-to-alls follow JAX's ``tiled=True``
layout exactly (``parallel/collectives.py``), and their backward is the
reverse all-to-all.

Requires ``num_heads % n == 0`` (else it raises, naming the ring) and
``L % n == 0``.

``axis_name`` is a mesh axis of the ambient context (``"seq"``) or a
process group. The ``*_sharded`` forms take global (B, ..., L, ...)
arrays on every rank, run this rank's chunk under the mesh's
``seq_axis`` group and all-gather the output back to global, as JAX's
``shard_map`` wrappers take and return global arrays.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .collectives import all_gather, all_to_all, group_rank, group_size


def axis_group(axis_name):
    """The process group of ``axis_name``: a mesh axis name of the
    ambient context, or a group given as it is (None: one rank)."""
    if axis_name is None or not isinstance(axis_name, str):
        return axis_name
    from ..common.nncontext import get_nncontext
    return get_nncontext().mesh.group(axis_name)


def _ulysses_impl(q, k, v, axis_name, head_axis, seq_axis, attn_fn,
                  causal, sm_scale, kbias):
    """The all-to-all head/seq swap around ``attn_fn(q, k, v, bias,
    causal, sm_scale)``, a full-L local attention in the operands'
    layout (``head_axis`` / ``seq_axis`` locate those dims)."""
    group = axis_group(axis_name)
    n = group_size(group)
    h, d = q.shape[head_axis], q.shape[3]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads % devices == 0, got "
                         f"H={h} over {n} devices (use ring_attention)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    def seq_to_head(x):
        return all_to_all(x, group, split_axis=head_axis,
                          concat_axis=seq_axis)

    def head_to_seq(x):
        return all_to_all(x, group, split_axis=seq_axis,
                          concat_axis=head_axis)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    bias = None
    if kbias is not None:
        kb_full = all_gather(kbias, group, dim=1)
        bias = kb_full[:, None, None, :]          # (B, 1, 1, L)
    return head_to_seq(attn_fn(qh, kh, vh, bias, causal, sm_scale))


def ulysses_attention(q, k, v, axis_name, causal: bool = False,
                      sm_scale: Optional[float] = None, kbias=None):
    """This rank's q, k, v: (B, H, L_local, D); returns (B, H, L_local,
    D). ``kbias``: this rank's additive key bias (B, L_local), gathered to
    full length for the local attention."""
    from ..ops.attention import flash_attention

    def attn(q, k, v, bias, causal, sm_scale):
        return flash_attention(q, k, v, bias=bias, causal=causal,
                               sm_scale=sm_scale)

    return _ulysses_impl(q, k, v, axis_name, head_axis=1, seq_axis=2,
                         attn_fn=attn, causal=causal, sm_scale=sm_scale,
                         kbias=kbias)


def ulysses_attention_blhd(q, k, v, axis_name, causal: bool = False,
                           sm_scale: Optional[float] = None, kbias=None):
    """This rank's q, k, v: (B, L_local, H, D); returns (B, L_local, H,
    D). The layout the fused QKV projection's reshape produces: the
    all-to-alls swap its head and sequence axes and the local attention is
    ``flash_attention_blhd``, the kernels' own layout."""
    from ..ops.attention import flash_attention_blhd

    def attn(q, k, v, bias, causal, sm_scale):
        return flash_attention_blhd(q, k, v, bias=bias, causal=causal,
                                    sm_scale=sm_scale)

    return _ulysses_impl(q, k, v, axis_name, head_axis=2, seq_axis=1,
                         attn_fn=attn, causal=causal, sm_scale=sm_scale,
                         kbias=kbias)


def sharded_seq_attention(per_shard_fn, q, k, v, mesh, causal=False,
                          sm_scale=None, seq_axis: str = "seq",
                          kbias=None, layout: str = "bhld"):
    """Global q, k, v on every rank — (B, H, L, D) for ``layout="bhld"``,
    (B, L, H, D) for ``"blhd"`` — with L split over the mesh's
    ``seq_axis``: this rank's chunk goes through ``per_shard_fn`` over
    that axis's group, and the chunks are all-gathered back to the global
    output. ``kbias``: an optional global (B, L) additive key bias."""
    group = mesh.group(seq_axis)
    n, r = group_size(group), group_rank(group)
    dim = 1 if layout == "blhd" else 2
    length = q.shape[dim]
    if length % n:
        raise ValueError(f"sequence length {length} does not split over "
                         f"{n} ranks of {seq_axis!r}")
    c = length // n

    def chunk(t, axis):
        return t.narrow(axis, r * c, c)

    kb = None if kbias is None else chunk(kbias, 1)
    out = per_shard_fn(chunk(q, dim), chunk(k, dim), chunk(v, dim),
                       group, causal=causal, sm_scale=sm_scale, kbias=kb)
    return all_gather(out, group, dim=dim)


def ulysses_attention_sharded(q, k, v, mesh, causal=False, sm_scale=None,
                              seq_axis: str = "seq", kbias=None):
    """(B, H, L, D) global arrays, L split over ``seq_axis``."""
    return sharded_seq_attention(ulysses_attention, q, k, v, mesh,
                                 causal=causal, sm_scale=sm_scale,
                                 seq_axis=seq_axis, kbias=kbias)


def ulysses_attention_blhd_sharded(q, k, v, mesh, causal=False,
                                   sm_scale=None, seq_axis: str = "seq",
                                   kbias=None):
    """(B, L, H, D) global arrays, L split over ``seq_axis``."""
    return sharded_seq_attention(ulysses_attention_blhd, q, k, v, mesh,
                                 causal=causal, sm_scale=sm_scale,
                                 seq_axis=seq_axis, kbias=kbias,
                                 layout="blhd")
