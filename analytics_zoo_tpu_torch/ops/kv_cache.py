"""KV-cache incremental decode: slab-allocated cache + append-one attention.

Counterpart of ``analytics_zoo_tpu/ops/kv_cache.py``. The generative
serving path (``serving/generation.py``) decodes one token per model call
against per-layer K/V slabs in the blhd layout (B, S, H, D), the layout
the fused-QKV reshape produces:

- ``DecodeState``: the per-layer K/V slabs, per-sequence write lengths
  and an optional sampling generator.
- ``write_prompt`` / ``place_slot``: stash a prefilled prompt's K/V rows
  in the slab head, or splice one sequence into a gang slot.
- ``cached_attention_step``: one-token attention against the slab, an
  einsum contracting the single query row against S cached keys, masked
  at each sequence's write length; ``cached_attention_chunk`` its
  C-token rectangle (chunked prefill, speculative verification).
- ``decode_step_is_cached``: the probe that no full-sequence attention
  contraction ran.

The attention here is plain torch, as the JAX package's is plain ``jnp``
(no Pallas kernel): there is no decode-attention kernel to port.

Where the port differs from JAX:

- Slabs are written **in place** (``index_copy_`` and slice copies), so a
  decode step writes B·C rows, never a copy of the slab. Every writer
  returns the cache it wrote, so the JAX call shapes stay, but that is
  the object it was given: callers that need the state before a write
  keep a :meth:`DecodeState.clone`. JAX's ``init_decode_state`` hands the
  same tuple of zero arrays to K and V (harmless for immutable arrays);
  here K and V are separate allocations, since writing K must leave V
  alone.
- ``_write_row`` and ``place_slot`` reproduce ``dynamic_update_slice``'s
  clamp: a write of C rows at offset ``i`` lands at
  ``clamp(i, 0, S - C)``, so rows that would run past the slab end are
  written shifted back instead of raising.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .quant import dequantize_rows, quantize_rows


class Int8KVSlab:
    """One KV slab stored int8: (B, S, H, D) rows + (B, S, H, 1) f32
    per-row scales. Dequantization folds into the attention einsums as a
    per-score / per-probability multiply, so the f32 slab is never
    materialized: memory holds 1 byte/elem + 4/D bytes of scale instead
    of 4 bytes/elem."""
    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.scale.nbytes)

    def dequantize(self):
        return dequantize_rows(self.q, self.scale)

    def clone(self) -> "Int8KVSlab":
        return Int8KVSlab(self.q.clone(), self.scale.clone())

    def __repr__(self):
        return f"Int8KVSlab(shape={tuple(self.q.shape)})"


def quantize_kv(kv) -> Int8KVSlab:
    """Project f32 K/V rows (..., H, D) into an int8 slab payload with
    one scale per (row, head)."""
    if isinstance(kv, Int8KVSlab):
        return kv
    q, scale = quantize_rows(kv, axis=-1)
    return Int8KVSlab(q, scale)


class DecodeState(NamedTuple):
    """State threaded through ``decode_step``.

    ``k_cache``/``v_cache``: one (B, S, H, D) slab per transformer layer
    (blhd layout; S is the bucket capacity, shared by every slot).
    ``lengths``: (B,) int32 on the slabs' device: tokens written per
    slot; slot b's valid cache rows are ``[0, lengths[b])``. A freed slot
    is just ``lengths[b] = 0``: stale rows are masked out, never read.
    ``rng``: a ``torch.Generator`` for sampling (None => greedy only).
    """
    k_cache: Tuple[torch.Tensor, ...]
    v_cache: Tuple[torch.Tensor, ...]
    lengths: torch.Tensor
    rng: Optional[torch.Generator]

    @property
    def batch(self) -> int:
        return self.k_cache[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.k_cache[0].shape[1]

    @property
    def num_layers(self) -> int:
        return len(self.k_cache)

    def clone(self) -> "DecodeState":
        """A copy of every slab and of the lengths (the generator is
        shared): the state as it stands, kept apart from later in-place
        writes."""
        return DecodeState(tuple(s.clone() for s in self.k_cache),
                           tuple(s.clone() for s in self.v_cache),
                           self.lengths.clone(), self.rng)


def cache_length_buckets(max_len: int, min_bucket: int = 128):
    """Power-of-two slab capacities up to (and covering) ``max_len``: a
    small fixed set of slab shapes."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    lo = max(1, min_bucket)
    buckets = []
    b = 1 << max(0, math.ceil(math.log2(lo)))
    while True:
        buckets.append(b)
        if b >= max_len:
            return buckets
        b *= 2


def pick_cache_bucket(length: int, buckets) -> int:
    """Smallest bucket holding ``length`` tokens (prompt + generation
    headroom). Lengths beyond the largest bucket raise: the scheduler must
    clamp max_new_tokens to the slab budget at admission, not discover the
    overflow mid-generation."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"length {length} exceeds largest cache bucket {buckets[-1]}")


def _is_int8(dtype) -> bool:
    return isinstance(dtype, str) and dtype == "int8" or dtype is torch.int8


def init_decode_state(num_layers: int, batch: int, capacity: int,
                      num_heads: int, head_dim: int,
                      dtype=torch.float32, rng=None,
                      device=None) -> DecodeState:
    """Preallocate zeroed (B, S, H, D) slabs for every layer on
    ``device``, K and V apart.

    ``dtype="int8"`` (or ``torch.int8``) allocates ``Int8KVSlab`` slabs;
    every read/write helper below dispatches on the slab type, so the
    decode path is otherwise unchanged."""
    shape = (batch, capacity, num_heads, head_dim)
    if _is_int8(dtype):
        def make():
            return Int8KVSlab(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=device))
    else:
        def make():
            return torch.zeros(shape, dtype=dtype, device=device)
    return DecodeState(
        k_cache=tuple(make() for _ in range(num_layers)),
        v_cache=tuple(make() for _ in range(num_layers)),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        rng=rng)


def _row_index(lengths, c: int, s: int) -> torch.Tensor:
    """(B·C,) rows of the (B·S, ...) flattened slab that sequence b's C
    new rows land on: ``clamp(lengths[b], 0, S - C) + [0, C)``, the start
    ``dynamic_update_slice`` clamps to."""
    if c > s:
        raise ValueError(f"cannot write {c} rows into a slab of {s}")
    dev = lengths.device
    start = lengths.long().clamp(0, s - c)
    rows = start[:, None] + torch.arange(c, device=dev)[None, :]
    base = s * torch.arange(lengths.shape[0], device=dev)[:, None]
    return (rows + base).reshape(-1)


def _scatter_rows(slab, new, idx) -> None:
    b, s = slab.shape[:2]
    tail = tuple(slab.shape[2:])
    slab.view((b * s,) + tail).index_copy_(
        0, idx, new.reshape((-1,) + tail).to(slab.dtype))


def _write_row(cache, new, lengths):
    """Write each sequence's (C, H, D) rows at its own offset, in place:
    B·C rows scattered into the slab, no slab copy."""
    idx = _row_index(lengths, new.shape[1], cache.shape[1])
    if isinstance(cache, Int8KVSlab):
        new = quantize_kv(new)
        _scatter_rows(cache.q, new.q, idx)
        _scatter_rows(cache.scale, new.scale, idx)
        return cache
    _scatter_rows(cache, new, idx)
    return cache


def write_prompt(cache, kv, lengths=None):
    """Stash projected prompt K/V (B, Lp, H, D) into the slab head.

    The slab tail keeps zeros; they are masked by ``lengths`` at read time
    so per-sequence prompt padding inside Lp is harmless too."""
    lp = kv.shape[1]
    cap = cache.shape[1]
    if lp > cap:
        raise ValueError(f"prompt length {lp} exceeds slab capacity {cap}")
    if isinstance(cache, Int8KVSlab):
        kvq = quantize_kv(kv)
        cache.q[:, :lp].copy_(kvq.q)
        cache.scale[:, :lp].copy_(kvq.scale)
        return cache
    cache[:, :lp].copy_(kv)
    return cache


def place_slot(cache, slot, kv):
    """Replace one slot's leading rows with a prefilled (S, H, D) or
    (Lp, H, D) sequence: the continuous-batching join path. ``kv`` may be
    f32 rows or an already-quantized ``Int8KVSlab`` payload (the
    prefix-cache hit path stores rows pre-quantized). ``slot`` is clamped
    to ``[0, B - 1]``, as ``dynamic_update_slice`` clamps it."""
    slot = min(max(int(slot), 0), cache.shape[0] - 1)
    n = kv.shape[0]
    if n > cache.shape[1]:
        raise ValueError(f"{n} rows exceed slab capacity {cache.shape[1]}")
    if isinstance(cache, Int8KVSlab):
        kvq = quantize_kv(kv)
        cache.q[slot, :n].copy_(kvq.q)
        cache.scale[slot, :n].copy_(kvq.scale)
        return cache
    if isinstance(kv, Int8KVSlab):
        kv = kv.dequantize()
    cache[slot, :n].copy_(kv)
    return cache


def evict_slot(lengths, slot):
    """Freeing a slot is a length reset: stale K/V rows stay in the slab
    but are masked out of every subsequent step. Returns new lengths."""
    out = lengths.clone()
    out[int(slot)] = 0
    return out


def cached_attention_step(q, k_new, v_new, k_cache, v_cache, lengths,
                          sm_scale=None):
    """One decode step of attention against the cache. O(S) per token.

    q, k_new, v_new: (B, 1, H, D): this step's projected query/key/value.
    k_cache, v_cache: (B, S, H, D) slabs; lengths: (B,) int32 rows written.

    Returns (o, k_cache, v_cache, new_lengths) with o: (B, 1, H, D). The
    new K/V row is written at ``lengths`` first (in place), so the query
    attends to itself (causal row i sees keys <= i) and
    ``new_lengths = lengths + 1``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k_cache = _write_row(k_cache, k_new, lengths)
    v_cache = _write_row(v_cache, v_new, lengths)
    new_lengths = lengths + 1

    # (B, H, S) scores: a single query row vs the whole slab, O(S)
    s = _score_slab(q[:, 0].float(), k_cache) * sm_scale
    cap = k_cache.shape[1]
    valid = torch.arange(cap, device=s.device)[None, :] < \
        new_lengths[:, None]
    s = s.masked_fill(~valid[:, None, :], -1e30)
    # rows with lengths == 0 (empty slots) softmax over the single -1e30
    # plateau: finite, and the scheduler discards their output anyway
    p = torch.softmax(s, dim=-1)
    o = _mix_slab(p, v_cache)
    return (o[:, None].to(q.dtype), k_cache, v_cache, new_lengths)


def _scale_bhs(slab):
    """An int8 slab's per-row scales as (B, H, S)."""
    return slab.scale[..., 0].permute(0, 2, 1)


def _score_slab(q, k_cache):
    """(B, H, D) query rows vs a (B, S, H, D) slab -> (B, H, S) scores.
    For an int8 slab the per-row scale factors out of the dot product, so
    dequantization is a (B, H, S) multiply."""
    if isinstance(k_cache, Int8KVSlab):
        s = torch.einsum("bhd,bshd->bhs", q, k_cache.q.float())
        return s * _scale_bhs(k_cache)
    return torch.einsum("bhd,bshd->bhs", q, k_cache.float())


def _mix_slab(p, v_cache):
    """(B, H, S) probabilities times a (B, S, H, D) value slab ->
    (B, H, D). Int8: fold the per-row scale into p before the einsum."""
    if isinstance(v_cache, Int8KVSlab):
        p = p * _scale_bhs(v_cache)
        return torch.einsum("bhs,bshd->bhd", p, v_cache.q.float())
    return torch.einsum("bhs,bshd->bhd", p, v_cache.float())


def cached_attention_chunk(q, k_new, v_new, k_cache, v_cache, lengths,
                           sm_scale=None, n_valid=None):
    """C-token attention against the cache: the rectangular decode step.

    q, k_new, v_new: (B, C, H, D): C new rows per sequence, written (in
    place) at each sequence's own ``lengths`` offset, then attended
    causally: chunk row c (absolute position ``lengths[b] + c``) sees slab
    keys ``<= lengths[b] + c``. One call serves both chunked prefill
    (C = chunk size) and speculative verification (C = k drafts + 1).

    ``n_valid`` ((B,) int32, optional) handles ragged tails: lengths
    advance by ``n_valid`` instead of C, so rows >= n_valid land ABOVE the
    watermark, never attended by a valid row and overwritten by the next
    write at the new ``lengths``.

    Returns (o, k_cache, v_cache, new_lengths) with o: (B, C, H, D). The
    score tensor is (B, H, C, S): with C << S there is no (S, S)
    contraction, so ``decode_step_is_cached`` holds.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    c = q.shape[1]
    k_cache = _write_row(k_cache, k_new, lengths)
    v_cache = _write_row(v_cache, v_new, lengths)
    new_lengths = lengths + (c if n_valid is None else n_valid)

    qf = q.float()
    if isinstance(k_cache, Int8KVSlab):
        s = torch.einsum("bchd,bshd->bhcs", qf, k_cache.q.float())
        s = s * _scale_bhs(k_cache)[:, :, None, :]
    else:
        s = torch.einsum("bchd,bshd->bhcs", qf, k_cache.float())
    s = s * sm_scale
    dev = s.device
    pos = lengths[:, None] + torch.arange(c, device=dev)[None, :]  # (B, C)
    valid = (torch.arange(k_cache.shape[1], device=dev)[None, None, :]
             <= pos[:, :, None])                                   # (B, C, S)
    s = s.masked_fill(~valid[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    if isinstance(v_cache, Int8KVSlab):
        p = p * _scale_bhs(v_cache)[:, :, None, :]
        o = torch.einsum("bhcs,bshd->bchd", p, v_cache.q.float())
    else:
        o = torch.einsum("bhcs,bshd->bchd", p, v_cache.float())
    return (o.to(q.dtype), k_cache, v_cache, new_lengths)


def grow_slab(cache, new_capacity: int):
    """Re-place a slab into a larger bucket: a new zero-padded slab along
    the S axis. Used when a gang outgrows its capacity bucket (scheduler
    grow path)."""
    cap = cache.shape[1]
    if new_capacity < cap:
        raise ValueError(f"cannot shrink slab {cap} -> {new_capacity}")

    def pad(t):
        out = t.new_zeros((t.shape[0], new_capacity) + tuple(t.shape[2:]))
        out[:, :cap].copy_(t)
        return out

    if isinstance(cache, Int8KVSlab):
        return Int8KVSlab(pad(cache.q), pad(cache.scale))
    return pad(cache)


def kv_slab_bytes(state: DecodeState) -> int:
    """Device memory held by the K/V slabs of a decode state (int8 states
    count q + scale bytes)."""
    return sum(int(slab.nbytes)
               for slab in tuple(state.k_cache) + tuple(state.v_cache))


#: the aten ops that contract operands (``dot_general`` in a jaxpr);
#: ``torch.einsum`` and ``torch.matmul`` reach the dispatcher as these
_CONTRACTION_OPS = frozenset({
    "mm", "bmm", "addmm", "addbmm", "baddbmm", "dot", "vdot", "mv",
    "addmv", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention"})


class _OpShapeRecorder(TorchDispatchMode):
    """Records ``(op name, output shapes)`` of every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func.overloadpacket.__name__,
                         [tuple(t.shape) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)]))
        return out


def decode_step_is_cached(fn, *args, capacity=None, **kwargs) -> bool:
    """True iff ``fn(*args, **kwargs)`` runs no full-sequence attention
    contraction: no contraction op (``_CONTRACTION_OPS``) whose OUTPUT
    carries two axes of at least the slab capacity. The cached step's
    score tensor is (B, H, S): one S axis. A fallback that recomputed
    attention over the whole history would produce an (S, S) score block
    and trip this.

    The JAX probe reads a traced jaxpr; this one runs ``fn`` once under
    a dispatch mode that records every op's output shapes, so ``fn``'s in-place slab writes happen
    (pass a :meth:`DecodeState.clone`). Contractions reach the dispatcher
    with their batch axes flattened ((B·C, N) for a (B, C, hidden)
    projection), so keep B·C below the capacity when probing a chunk.
    """
    if capacity is None:
        raise ValueError("pass capacity= (the slab length S)")
    rec = _OpShapeRecorder()
    with rec:
        fn(*args, **kwargs)
    for name, shapes in rec.ops:
        if name in _CONTRACTION_OPS and any(
                sum(d >= capacity for d in shape) >= 2 for shape in shapes):
            return False
    return True


__all__ = [
    "DecodeState", "Int8KVSlab", "quantize_kv", "cache_length_buckets",
    "pick_cache_bucket", "init_decode_state", "write_prompt", "place_slot",
    "evict_slot", "cached_attention_step", "cached_attention_chunk",
    "grow_slab", "kv_slab_bytes", "decode_step_is_cached",
]
