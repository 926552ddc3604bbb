"""Continuous-batching generative serving: decode engines + scheduler.

Counterpart of ``analytics_zoo_tpu/serving/generation.py``. The scheduler,
the prefix cache, the stub and the speculative engine are copies; the
transformer engine drives the port's ``TransformerLayer`` decode API on
one device (see :class:`TransformerDecodeEngine` for what differs).

The serving layer's autoregressive workload front. Classification
serving dispatches a batch and is done; generation holds a sequence in
flight for tens-to-thousands of decode steps. Batching at *request*
granularity (static batching) means the whole gang waits for its
slowest member — short answers pay for long ones. Iteration-level
scheduling (Orca, OSDI '22) rebatches at every token boundary instead:

- the in-flight batch is a set of **cache slots** over preallocated
  power-of-two KV slabs (``ops/kv_cache.py``);
- a finished sequence (stop token / max_new_tokens / deadline) is
  **evicted at the very step it finishes** and its result committed
  immediately;
- the freed slot is **refilled from the admission queue
  mid-generation** — joiners prefill into the running gang without
  stalling it;
- admission reuses the padding-bucket + linger machinery, with the
  EWMA deadline shed extended by a per-token service estimate
  (:meth:`AdmissionController.admit_generate`), and a mid-stream shed
  (:meth:`AdmissionController.stream_expired`) that evicts a sequence
  whose deadline passes while decoding, committing a typed
  ``shed_deadline`` payload that carries the partial tokens.

Two engines implement the gang interface: ``TransformerDecodeEngine``
(the real KV-cache decode path through ``TransformerLayer``) and
``StubDecodeEngine`` (a deterministic CPU stand-in whose decode step
costs a flat ``ms_per_step`` regardless of gang width — the
gang-amortization property that makes continuous batching pay; the
bench ``generation`` leg and the fast-tier smoke run on it).

On top of the base gang interface the engines expose a **generative
fast path**, each piece optional and independently degradable:

- **batched joins** (``join_batch``): concurrent arrivals prefill as
  one padded dispatch instead of N sequential batch-1 prefills;
- **chunked prefill** (``prefill_chunk``): a long prompt splits into
  fixed-width chunks interleaved with the running gang's decode steps,
  bounding the inter-token stall a long joiner inflicts on everyone
  else (the scheduler advances one chunk per token boundary);
- **speculative decoding** (``SpeculativeDecodeEngine``): a cheap
  draft proposes ``k`` tokens per round and the target verifies them
  in one rectangular ``step_chunk``; greedy output is token-for-token
  identical to plain decode (Leviathan et al., 2023);
- **shared-prefix cache** (``PrefixCache``): a content-hash hit
  splices previously computed KV rows into the joiner's slot —
  ``prefill_calls`` does not move;
- **int8 KV slabs** (``kv_dtype="int8"`` on the transformer engine):
  ``ops/kv_cache.Int8KVSlab`` storage at (1 + 4/D)/4 of the f32 bytes.
"""

from __future__ import annotations

import hashlib
import logging
import math
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kv_cache import (Int8KVSlab, cache_length_buckets, evict_slot,
                            grow_slab, pick_cache_bucket, place_slot)
from ..utils import telemetry
from ..utils.telemetry import span
from .admission import (SHED_DEADLINE, AdaptiveBatcher, AdmissionController,
                        now_ms)

logger = logging.getLogger(__name__)

#: eviction reasons — the "reason" label on zoo_generate_evict_total and
#: the "finish" field of committed results
FINISH_STOP = "stop_id"
FINISH_MAX_TOKENS = "max_new_tokens"
FINISH_DEADLINE = "shed_deadline"
FINISH_CANCELLED = "cancelled"

#: typed shed code for prompts no cache bucket can hold
SHED_CAPACITY = "shed_capacity"


@dataclass
class GenRequest:
    """One generate request as it leaves the wire decoder."""

    uri: str
    prompt: np.ndarray                  # 1-D int token ids
    max_new_tokens: int = 32
    stop_id: Optional[int] = None
    temperature: float = 0.0            # 0 = greedy
    deadline_at_ms: Optional[float] = None
    enqueue_ts_ms: Optional[float] = None
    t_in: float = field(default_factory=time.perf_counter)
    trace_id: Optional[str] = None      # client-stamped trace context

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt).astype(np.int64).ravel()
        self.max_new_tokens = max(int(self.max_new_tokens), 1)


@dataclass
class _Slot:
    """Scheduler-side tracker for one in-flight sequence."""

    req: GenRequest
    tokens: List[int] = field(default_factory=list)
    last: int = 0
    t_join: float = 0.0
    t_first_token: Optional[float] = None
    t_tokens: List[float] = field(default_factory=list)
    finish: Optional[str] = None
    prefill_next: Optional[int] = None  # next chunk start; None = done


# ---------------------------------------------------------------------------
# shared-prefix cache
# ---------------------------------------------------------------------------

def prompt_key(prompt: np.ndarray) -> str:
    """Content hash of a prompt token sequence (the cache key)."""
    p = np.ascontiguousarray(np.asarray(prompt, np.int64).ravel())
    return hashlib.sha1(p.tobytes()).hexdigest()


class PrefixCache:
    """LRU map from prompt content-hash to a prefilled-KV payload.

    A hit lets a joiner splice previously computed rows straight into
    its slot (``place_slot``) instead of re-running prefill — the
    dominant cost for agent/template workloads where many requests
    share a long system prompt. Payloads are engine-specific (the
    transformer engine stores per-layer K/V rows, possibly already
    int8-quantized, plus the last-token logits row; the stub stores its
    scripted stream state); the cache only tracks recency and bytes.

    ``lookup`` is the *only* place hit/miss counters move — engines
    call it exactly once per join attempt, so the telemetry counters
    are a true hit ratio. Not thread-safe beyond the scheduler-loop
    single-writer pattern it lives in.
    """

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[str, Tuple[object, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def lookup(self, prompt: np.ndarray):
        """Return the cached payload or None; counts the hit/miss."""
        key = prompt_key(prompt)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            telemetry.counter("zoo_generate_prefix_cache_misses_total").inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        telemetry.counter("zoo_generate_prefix_cache_hits_total").inc()
        return entry[0]

    def insert(self, prompt: np.ndarray, payload, nbytes: int):
        key = prompt_key(prompt)
        if key in self._entries:
            _, old = self._entries.pop(key)
            self._bytes -= old
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return
        self._entries[key] = (payload, nbytes)
        self._bytes += nbytes
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, (_, evicted) = self._entries.popitem(last=False)
            self._bytes -= evicted
        telemetry.gauge("zoo_generate_prefix_cache_bytes").set(self._bytes)

    def contains(self, prompt: np.ndarray) -> bool:
        """Membership probe that does NOT move the hit/miss counters or
        recency — routing affinity accounting must not pollute the true
        hit ratio that ``lookup`` maintains."""
        return prompt_key(prompt) in self._entries

    def key_digest(self, limit: int = 32, width: int = 12) -> List[str]:
        """Newest-first bounded digest of resident keys, truncated to
        ``width`` hex chars — small enough to ride a fleet heartbeat,
        wide enough that a router prefix-match is a real cache hit."""
        keys = list(reversed(self._entries))[: max(int(limit), 0)]
        return [k[: int(width)] for k in keys]

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries), "bytes": self._bytes}


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

class StubDecodeEngine:
    """Deterministic gang-decode stand-in (the generate analogue of
    ``EchoStubModel``).

    Token stream for a prompt ``p``: token i (1-based) is ``p[0] + i``,
    except that when the prompt has a second element ``p[1] > 0`` the
    stream emits ``stop_id`` at position ``p[1]`` — letting tests
    script stop-token eviction per request. ``step()`` sleeps a flat
    ``ms_per_step`` for the *whole gang* (device-like cost: one device
    pass per token boundary, amortized over every active slot) and
    ``join()`` sleeps ``ms_per_prefill + ms_per_prefill_token * Lp``
    once.

    Fast-path knobs mirror the device engine's cost shape:
    ``join_batch`` costs one prefill of the *longest* member (padded
    batch on the device); ``prefill_chunk`` costs only its own tokens;
    ``step_chunk`` costs one flat gang pass regardless of width. A
    ``draft_skew > 0`` makes every ``draft_skew``-th stream token come
    out wrong — an imperfect-draft injector for speculation tests.
    """

    def __init__(self, ms_per_step: float = 1.0,
                 ms_per_prefill: float = 0.0, stop_id: int = 0,
                 capacity_buckets: Optional[Sequence[int]] = None,
                 ms_per_prefill_token: float = 0.0,
                 draft_skew: int = 0,
                 prefix_cache: Optional[PrefixCache] = None):
        self.ms_per_step = float(ms_per_step)
        self.ms_per_prefill = float(ms_per_prefill)
        self.ms_per_prefill_token = float(ms_per_prefill_token)
        self.stop_id = int(stop_id)
        self.draft_skew = int(draft_skew)
        self.prefix_cache = prefix_cache
        self.buckets = list(capacity_buckets or cache_length_buckets(1024))
        self.prefill_calls = 0

    def alloc(self, nslots: int, capacity: int):
        # per-slot [base, emitted, stop_at]; None = free
        return [None] * nslots

    def grow(self, state, capacity: int):
        return state

    # -- stream helpers ---------------------------------------------------
    @staticmethod
    def _entry(req: GenRequest):
        p = req.prompt
        base = int(p[0]) if p.size else 0
        stop_at = int(p[1]) if p.size > 1 and int(p[1]) > 0 else None
        return [base, 1, stop_at]

    def _stream(self, entry, pos: int) -> int:
        base, _, stop_at = entry
        if stop_at == pos:
            return self.stop_id
        tok = base + pos
        if self.draft_skew > 0 and pos % self.draft_skew == 0:
            tok += 1                     # scripted draft mistake
        return tok

    def _prefill_sleep(self, n_tokens: int, base: bool = True):
        ms = (self.ms_per_prefill if base else 0.0) \
            + self.ms_per_prefill_token * n_tokens
        if ms > 0:
            time.sleep(ms / 1e3)

    # -- joins ------------------------------------------------------------
    def join(self, state, slot: int, req: GenRequest):
        self._prefill_sleep(int(req.prompt.size))
        self.prefill_calls += 1
        state[slot] = self._entry(req)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, tuple(state[slot]),
                                     int(req.prompt.size) * 8)
        return state, self._stream(state[slot], 1)

    def join_batch(self, state, joins: Sequence[Tuple[int, GenRequest]]):
        """One fused prefill dispatch: padded-batch cost is the longest
        member's, not the sum — the batched-join win."""
        longest = max(int(r.prompt.size) for _, r in joins)
        self._prefill_sleep(longest)
        self.prefill_calls += 1
        out = {}
        for slot, req in joins:
            state[slot] = self._entry(req)
            if self.prefix_cache is not None:
                self.prefix_cache.insert(req.prompt, tuple(state[slot]),
                                         int(req.prompt.size) * 8)
            out[slot] = self._stream(state[slot], 1)
        return state, out

    def try_cached_join(self, state, slot: int, req: GenRequest):
        """Prefix-cache hit path: no sleep, no ``prefill_calls``."""
        if self.prefix_cache is None:
            return None
        payload = self.prefix_cache.lookup(req.prompt)
        if payload is None:
            return None
        state[slot] = [payload[0], 1, payload[2]]
        return state, self._stream(state[slot], 1)

    def prefill_chunk(self, state, slot: int, req: GenRequest,
                      start: int, end: int, is_last: bool):
        """Advance one prompt chunk; emits the first token only when
        the last chunk lands."""
        self._prefill_sleep(end - start, base=(start == 0))
        self.prefill_calls += 1          # one dispatch per chunk
        if not is_last:
            return state, None
        state[slot] = self._entry(req)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, tuple(state[slot]),
                                     int(req.prompt.size) * 8)
        return state, self._stream(state[slot], 1)

    # -- decode -----------------------------------------------------------
    def step(self, state, feeds: Dict[int, int],
             temps: Dict[int, float]):
        """Advance every fed slot one token; flat gang-wide cost."""
        if self.ms_per_step > 0:
            time.sleep(self.ms_per_step / 1e3)
        out = {}
        for slot in feeds:
            entry = state[slot]
            entry[1] += 1
            out[slot] = self._stream(entry, entry[1])
        return state, out

    def step_chunk(self, state, feeds: Dict[int, List[int]],
                   temps: Dict[int, float]):
        """Rectangular gang step: C fed tokens per slot, C predictions
        back (row i predicts the token after prefix+feeds[:i+1]), one
        flat gang-wide cost. ``draft_skew`` never applies here — the
        verifier is the ground-truth stream."""
        if self.ms_per_step > 0:
            time.sleep(self.ms_per_step / 1e3)
        out = {}
        for slot, toks in feeds.items():
            entry = state[slot]
            base, emitted, stop_at = entry
            preds = []
            for i in range(len(toks)):
                pos = emitted + 1 + i
                preds.append(self.stop_id if stop_at == pos
                             else base + pos)
            entry[1] = emitted + len(toks)
            out[slot] = preds
        return state, out

    def rollback(self, state, drops: Dict[int, int]):
        """Drop the trailing ``drops[slot]`` committed rows (the
        rejected speculative suffix)."""
        for slot, n in drops.items():
            if n > 0 and state[slot] is not None:
                state[slot][1] -= int(n)
        return state

    def evict(self, state, slot: int):
        state[slot] = None
        return state

    def stats(self) -> dict:
        out = {"prefill_calls": self.prefill_calls}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out


class TransformerDecodeEngine:
    """Gang decode over a causal ``TransformerLayer`` via its KV-cache
    API (``prefill`` / ``decode_step`` on ops/kv_cache.py slabs).

    A join prefills the prompt on a batch-1 state of the gang's capacity
    and splices the resulting rows into the joiner's slot: the running
    gang never recomputes. Freed slots sit at length 0: their rows are
    masked out of every step, and whatever the dead slot keeps emitting
    is discarded by the scheduler.

    The layer owns its weights (the JAX engine's ``params`` argument is
    gone) and is moved to ``device``: the context's device unless the
    caller names one, so without a card the engine raises unless asked
    for the CPU. Steps run eagerly (the JAX engine's ``jax.jit`` closures
    become direct calls). Greedy picks are ``argmax`` (the first maximum,
    as ``jnp.argmax``); sampling draws from ``rng``, a ``torch.Generator``
    on the engine's device (None: one seeded with 0), so sampled streams
    repeat under a seed but do not match JAX's.

    ``kv_dtype="int8"`` allocates ``Int8KVSlab`` caches ((1 + 4/D)/4 of
    the f32 bytes: 0.266x at head dim 64); all fast-path verbs are
    slab-polymorphic. A ``prefix_cache`` stores copies of per-layer slot
    rows + the last-token logits row at join time (the slabs are written
    in place, so a view would change under later steps); a hit splices
    them back via ``place_slot`` with no prefill dispatch (watch
    ``prefill_calls`` stand still).
    """

    def __init__(self, layer, max_len: Optional[int] = None, rng=None,
                 kv_dtype=None, prefix_cache: Optional[PrefixCache] = None,
                 device=None):
        if device is None:
            from ..common.nncontext import get_nncontext
            device = get_nncontext().device
        self.device = torch.device(device)
        self.layer = layer.to(self.device).eval()
        self.buckets = cache_length_buckets(
            max_len or layer.seq_len, min_bucket=min(128, layer.seq_len))
        self._rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.kv_dtype = "int8" if kv_dtype in ("int8", torch.int8) \
            else (kv_dtype or torch.float32)
        self.prefix_cache = prefix_cache
        self.prefill_calls = 0
        # slot -> (batch-1 state, chunk width) for in-flight chunked joins
        self._pending: Dict[int, tuple] = {}

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def alloc(self, nslots: int, capacity: int):
        return self.layer.init_decode_state(nslots, capacity,
                                            dtype=self.kv_dtype)

    def grow(self, state, capacity: int):
        if capacity <= state.capacity:
            return state
        return state._replace(
            k_cache=tuple(grow_slab(k, capacity) for k in state.k_cache),
            v_cache=tuple(grow_slab(v, capacity) for v in state.v_cache))

    def _pick(self, logits, temperature: float) -> int:
        if temperature and temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return int(torch.multinomial(probs, 1, generator=self._rng))
        return int(torch.argmax(logits))

    def _picks(self, rows, temps: Sequence[float]) -> List[int]:
        """One pick per row of (N, vocab) logits: one host transfer for
        the greedy rows, a draw for each sampled one."""
        greedy = torch.argmax(rows, dim=-1).tolist()
        return [self._pick(rows[j], t) if t and t > 0.0 else greedy[j]
                for j, t in enumerate(temps)]

    # -- join helpers -----------------------------------------------------
    def _slot_rows(self, slab, b: int, lp: int, copy: bool = False):
        """One sequence's first ``lp`` K/V rows of a batch slab: views to
        splice at once, or copies (``copy``) for a prefix-cache payload."""
        if isinstance(slab, Int8KVSlab):
            rows = Int8KVSlab(slab.q[b, :lp], slab.scale[b, :lp])
        else:
            rows = slab[b, :lp]
        return rows.clone() if copy else rows

    def _splice(self, state, slot: int, k_rows, v_rows, lp: int):
        for k, r in zip(state.k_cache, k_rows):
            place_slot(k, slot, r)
        for v, r in zip(state.v_cache, v_rows):
            place_slot(v, slot, r)
        lengths = state.lengths.clone()
        lengths[slot] = lp
        return state._replace(lengths=lengths)

    def _splice_from(self, state, slot: int, src, b: int, lp: int):
        return self._splice(
            state, slot,
            tuple(self._slot_rows(k, b, lp) for k in src.k_cache),
            tuple(self._slot_rows(v, b, lp) for v in src.v_cache), lp)

    def _cache_insert(self, req: GenRequest, st1, last_logits, b: int = 0):
        if self.prefix_cache is None:
            return
        lp = int(req.prompt.size)
        k_rows = tuple(self._slot_rows(k, b, lp, copy=True)
                       for k in st1.k_cache)
        v_rows = tuple(self._slot_rows(v, b, lp, copy=True)
                       for v in st1.v_cache)
        last_logits = last_logits.clone()
        payload = (k_rows, v_rows, last_logits)
        nbytes = sum(int(x.nbytes) for x in k_rows + v_rows) + \
            int(last_logits.nbytes)
        self.prefix_cache.insert(req.prompt, payload, nbytes)

    def join(self, state, slot: int, req: GenRequest):
        st1 = self.layer.init_decode_state(1, state.capacity,
                                           dtype=self.kv_dtype)
        logits, st1 = self.layer.prefill(
            self._tensor(req.prompt)[None],
            self._tensor([req.prompt.size], torch.int32), st1)
        self.prefill_calls += 1
        lp = int(req.prompt.size)
        state = self._splice_from(state, slot, st1, 0, lp)
        self._cache_insert(req, st1, logits[0])
        return state, self._pick(logits[0], req.temperature)

    def join_batch(self, state, joins: Sequence[Tuple[int, GenRequest]]):
        """Prefill every joiner in ONE padded dispatch, then splice each
        sequence's rows into its gang slot."""
        n = len(joins)
        longest = max(int(r.prompt.size) for _, r in joins)
        toks = np.zeros((n, longest), np.int64)
        lens = np.zeros((n,), np.int32)
        for j, (_, req) in enumerate(joins):
            toks[j, :req.prompt.size] = req.prompt
            lens[j] = req.prompt.size
        stn = self.layer.init_decode_state(n, state.capacity,
                                           dtype=self.kv_dtype)
        logits, stn = self.layer.prefill(
            self._tensor(toks), self._tensor(lens, torch.int32), stn)
        self.prefill_calls += 1
        for j, (slot, req) in enumerate(joins):
            state = self._splice_from(state, slot, stn, j,
                                      int(req.prompt.size))
            self._cache_insert(req, stn, logits[j], b=j)
        picks = self._picks(logits, [r.temperature for _, r in joins])
        return state, {slot: picks[j] for j, (slot, _) in enumerate(joins)}

    def try_cached_join(self, state, slot: int, req: GenRequest):
        """Splice cached rows; None on miss. No prefill dispatch."""
        if self.prefix_cache is None:
            return None
        hit = self.prefix_cache.lookup(req.prompt)
        if hit is None:
            return None
        k_rows, v_rows, last_logits = hit
        state = self._splice(state, slot, k_rows, v_rows,
                             int(req.prompt.size))
        return state, self._pick(last_logits, req.temperature)

    def prefill_chunk(self, state, slot: int, req: GenRequest,
                      start: int, end: int, is_last: bool):
        """Advance one fixed-width prompt chunk on a batch-1 side state
        (the running gang is untouched until the final splice). The last
        (possibly ragged) chunk pads to the established width and masks
        via ``n_valid``."""
        if start == 0:
            st1 = self.layer.init_decode_state(1, state.capacity,
                                               dtype=self.kv_dtype)
            self._pending[slot] = (st1, end - start)
        st1, width = self._pending[slot]
        n_valid = end - start
        buf = np.zeros((1, width), np.int64)
        buf[0, :n_valid] = req.prompt[start:end]
        logits, st1 = self.layer.decode_chunk(
            st1, self._tensor(buf),
            n_valid=self._tensor([n_valid], torch.int32))
        self.prefill_calls += 1
        self._pending[slot] = (st1, width)
        if not is_last:
            return state, None
        del self._pending[slot]
        lp = int(req.prompt.size)
        state = self._splice_from(state, slot, st1, 0, lp)
        last_logits = logits[0, n_valid - 1]
        self._cache_insert(req, st1, last_logits)
        return state, self._pick(last_logits, req.temperature)

    # -- decode -----------------------------------------------------------
    def step(self, state, feeds: Dict[int, int],
             temps: Dict[int, float]):
        tokens = np.zeros((state.batch,), np.int64)
        for slot, tok in feeds.items():
            tokens[slot] = tok
        logits, state = self.layer.decode_step(state, self._tensor(tokens))
        slots = list(feeds)
        picks = self._picks(logits[slots],
                            [temps.get(slot, 0.0) for slot in slots])
        return state, dict(zip(slots, picks))

    def step_chunk(self, state, feeds: Dict[int, List[int]],
                   temps: Dict[int, float]):
        """Rectangular gang step (speculative verification): C fed
        tokens per slot through one ``decode_chunk``, C per-row
        predictions back. Row 0 honours the slot's temperature (it is
        the one guaranteed-emitted token); rows 1.. are the greedy
        verification lane."""
        width = len(next(iter(feeds.values())))
        tokens = np.zeros((state.batch, width), np.int64)
        for slot, toks in feeds.items():
            tokens[slot] = toks
        logits, state = self.layer.decode_chunk(state, self._tensor(tokens))
        greedy_all = torch.argmax(logits, dim=-1).tolist()
        out = {}
        for slot in feeds:
            greedy = greedy_all[slot]
            temp = temps.get(slot, 0.0)
            if temp and temp > 0.0:
                greedy[0] = self._pick(logits[slot, 0], temp)
            out[slot] = [int(t) for t in greedy]
        return state, out

    def rollback(self, state, drops: Dict[int, int]):
        """Length surgery: un-commit the trailing ``drops[slot]`` rows
        (the rejected speculative suffix). The rows stay in the slab
        above the watermark: masked out, overwritten by the next
        write."""
        d = np.zeros((state.batch,), np.int32)
        for slot, n in drops.items():
            d[slot] = n
        return state._replace(
            lengths=state.lengths - self._tensor(d, torch.int32))

    def evict(self, state, slot: int):
        self._pending.pop(slot, None)
        return state._replace(lengths=evict_slot(state.lengths, slot))

    def stats(self) -> dict:
        out = {"prefill_calls": self.prefill_calls}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out


class SpeculativeDecodeEngine:
    """Draft-and-verify gang decode behind the same engine interface
    (Leviathan et al., 2023).

    Each round, per fed slot: the cheap **draft** runs ``k + 1``
    width-1 steps (``k`` proposals plus one throwaway step that writes
    the ``k``-th proposal's KV row, so the draft cache never lags the
    target on full acceptance); the **target** verifies ``[fed, d_1 ..
    d_k]`` in ONE rectangular ``step_chunk``. The longest agreeing
    prefix ``a`` yields ``a + 1`` emitted tokens (``a`` accepted drafts
    plus the target's own next token — the classic bonus), and both
    engines ``rollback`` the rejected ``k - a`` suffix rows by length
    surgery. Greedy output is token-for-token identical to plain
    decode; sampled slots (temperature > 0) force ``a = 0`` and emit
    the target's row-0 sample, which is exactly a plain sampled step.

    ``step`` therefore returns per-slot **lists** of 1..k+1 tokens;
    the scheduler normalises. ``expected_tokens_per_step`` feeds the
    admission estimate.
    """

    def __init__(self, target, draft, k: int = 3):
        self.target = target
        self.draft = draft
        self.k = max(int(k), 1)
        self.buckets = list(target.buckets)
        self._accepted = 0
        self._proposed = 0
        if getattr(target, "prefill_chunk", None) is None or \
                getattr(draft, "prefill_chunk", None) is None:
            self.prefill_chunk = None    # degrade: scheduler won't chunk
        self.prefix_cache = None         # lookups need both caches; skip

    # -- lifecycle (paired states) ----------------------------------------
    def alloc(self, nslots: int, capacity: int):
        return (self.target.alloc(nslots, capacity),
                self.draft.alloc(nslots, capacity))

    def grow(self, state, capacity: int):
        return (self.target.grow(state[0], capacity),
                self.draft.grow(state[1], capacity))

    def join(self, state, slot: int, req: GenRequest):
        t_state, first = self.target.join(state[0], slot, req)
        d_state, _ = self.draft.join(state[1], slot, req)
        return (t_state, d_state), first

    def join_batch(self, state, joins: Sequence[Tuple[int, GenRequest]]):
        t_state, out = self.target.join_batch(state[0], joins)
        d_state, _ = self.draft.join_batch(state[1], joins)
        return (t_state, d_state), out

    def prefill_chunk(self, state, slot: int, req: GenRequest,
                      start: int, end: int, is_last: bool):
        t_state, first = self.target.prefill_chunk(
            state[0], slot, req, start, end, is_last)
        d_state, _ = self.draft.prefill_chunk(
            state[1], slot, req, start, end, is_last)
        return (t_state, d_state), first

    def evict(self, state, slot: int):
        return (self.target.evict(state[0], slot),
                self.draft.evict(state[1], slot))

    # -- decode -----------------------------------------------------------
    def step(self, state, feeds: Dict[int, int],
             temps: Dict[int, float]):
        t_state, d_state = state
        k = self.k
        props: Dict[int, List[int]] = {slot: [] for slot in feeds}
        cur = {slot: int(tok) for slot, tok in feeds.items()}
        for i in range(k + 1):
            d_state, d_out = self.draft.step(d_state, cur, {})
            for slot in feeds:
                tok = int(d_out[slot])
                if i < k:
                    props[slot].append(tok)
                cur[slot] = tok
        chunks = {slot: [int(feeds[slot])] + props[slot] for slot in feeds}
        t_state, preds = self.target.step_chunk(t_state, chunks, temps)
        out: Dict[int, List[int]] = {}
        drops: Dict[int, int] = {}
        for slot in feeds:
            pred = [int(t) for t in preds[slot]]
            a = 0
            if not temps.get(slot):           # sampling can't verify
                while a < k and props[slot][a] == pred[a]:
                    a += 1
            out[slot] = props[slot][:a] + [pred[a]]
            drops[slot] = k - a               # both wrote k+1, keep a+1
            self._accepted += a
            self._proposed += k
        t_state = self.target.rollback(t_state, drops)
        d_state = self.draft.rollback(d_state, drops)
        telemetry.gauge("zoo_generate_draft_acceptance_rate").set(
            self.acceptance_rate)
        return (t_state, d_state), out

    @property
    def acceptance_rate(self) -> float:
        return self._accepted / self._proposed if self._proposed else 0.0

    @property
    def expected_tokens_per_step(self) -> float:
        """EWMA-free admission signal: accepted drafts per round plus
        the always-emitted bonus token."""
        if not self._proposed:
            return 1.0
        return 1.0 + self.k * self.acceptance_rate

    def stats(self) -> dict:
        out = {"k": self.k, "draft_accepted": self._accepted,
               "draft_proposed": self._proposed,
               "acceptance_rate": round(self.acceptance_rate, 4),
               "tokens_per_step": round(self.expected_tokens_per_step, 4)}
        t_stats = getattr(self.target, "stats", None)
        if callable(t_stats):
            out["target"] = t_stats()
        return out


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class ContinuousBatchScheduler:
    """Iteration-level scheduler over a gang-decode engine.

    Loop body (one token boundary): **evict** finished sequences and
    commit their results immediately → **refill** the freed cache
    slots from the admission queue (``admit_generate`` sheds requests
    whose deadline cannot survive the queue depth; joiners prefill
    into the running gang) → **advance chunked prefills** one chunk
    each → **step** the gang one token (``observe_tokens`` feeds the
    per-token EWMA back to admission).

    Refill takes the fast path where the engine offers one: a
    prefix-cache hit joins with no prefill at all; a prompt longer
    than ``prefill_chunk`` tokens joins *incrementally* — one chunk
    per token boundary, decode steps interleaved between chunks, so a
    long joiner can no longer stall the gang for its whole prompt;
    remaining same-boundary joiners fuse into a single batched prefill
    dispatch. Engines missing a verb degrade to the sequential path.

    An engine whose ``step`` returns per-slot token *lists* (the
    speculative engine) is handled natively — every emitted token gets
    its own ``_note_token`` so stop/budget/deadline checks stay
    per-token exact.

    ``continuous=False`` degrades to static batching — the gang only
    refills once *every* slot has drained — which is the baseline leg
    of the bench comparison, not a recommended mode.

    Results leave through ``commit(uri, payload)`` exactly once per
    submitted request: a finished sequence commits ``{"tokens",
    "finish", "timing"}``; a shed one commits ``{"error", "code",
    "tokens"}`` where ``tokens`` carries whatever partial stream the
    deadline allowed.
    """

    def __init__(self, engine, commit: Callable[[str, dict], None],
                 max_slots: int = 8, continuous: bool = True,
                 admission: Optional[AdmissionController] = None,
                 batcher: Optional[AdaptiveBatcher] = None,
                 idle_poll_s: float = 0.02, prefill_chunk: int = 0):
        self.engine = engine
        self._commit_cb = commit
        self.max_slots = max(int(max_slots), 1)
        self.continuous = bool(continuous)
        self.admission = admission
        self.batcher = batcher
        self.idle_poll_s = float(idle_poll_s)
        self.prefill_chunk = max(int(prefill_chunk), 0)

        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        self._queued_steps = 0      # decode-step budget still queued
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._state = None
        self._capacity = 0
        self._committed = set()
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self.counts = {"submitted": 0, "committed": 0, "tokens": 0,
                       "joins": 0, "evictions": 0, "shed": 0,
                       "duplicate_commits": 0}

    # -- public surface -------------------------------------------------
    def submit(self, req: GenRequest):
        with self._lock:
            self.counts["submitted"] += 1
            self._queued_steps += max(int(req.max_new_tokens), 1)
        self._queue.put(req)

    def _note_dequeued(self, req: GenRequest):
        with self._lock:
            self._queued_steps = max(
                self._queued_steps - max(int(req.max_new_tokens), 1), 0)

    def pending_decode_steps(self) -> int:
        """Decode-step backlog: queued requests' full token budgets plus
        the remaining budget of every active slot — the unit the fleet
        router and autoscaler reason in, so a 4-token ping and a
        512-token essay stop counting as the same \"one record\"."""
        with self._lock:
            queued = self._queued_steps
        remaining = 0
        for s in list(self._slots):
            if s is not None:
                remaining += max(
                    int(s.req.max_new_tokens) - len(s.tokens), 0)
        return int(queued + remaining)

    def _engine_prefix_cache(self):
        """The engine's prefix cache, reaching through a speculative
        wrapper to its target (the draft engine never caches)."""
        pc = getattr(self.engine, "prefix_cache", None)
        if pc is None:
            pc = getattr(getattr(self.engine, "target", None),
                         "prefix_cache", None)
        return pc

    def load_report(self, max_keys: int = 32) -> dict:
        """Free-slot / queued-step / prefix-digest snapshot for the
        fleet heartbeat (consumed by ``serving/routing.py``)."""
        active = sum(s is not None for s in self._slots)
        report = {"slots": self.max_slots,
                  "active_slots": active,
                  "free_slots": max(self.max_slots - active, 0),
                  "queue_depth": self._queue.qsize(),
                  "queued_steps": self.pending_decode_steps()}
        pc = self._engine_prefix_cache()
        if pc is not None:
            report["prefix_keys"] = pc.key_digest(limit=max_keys)
        return report

    def start(self):
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(target=self.run,
                                        name="zoo-generate-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        self._drain = bool(drain)
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counts)
        out["queue_depth"] = self._queue.qsize()
        out["active_slots"] = sum(s is not None for s in self._slots)
        out["capacity"] = self._capacity
        out["pending_steps"] = self.pending_decode_steps()
        eng_stats = getattr(self.engine, "stats", None)
        if callable(eng_stats):
            out["engine"] = eng_stats()
        return out

    # -- commit (exactly once) ------------------------------------------
    def _commit(self, uri: str, payload: dict):
        with self._lock:
            if uri in self._committed:
                self.counts["duplicate_commits"] += 1
                logger.error("duplicate commit suppressed for %r", uri)
                return
            self._committed.add(uri)
            self.counts["committed"] += 1
        self._commit_cb(uri, payload)

    def _shed(self, req: GenRequest, code: str, msg: str,
              tokens: Optional[List[int]] = None):
        with self._lock:
            self.counts["shed"] += 1
        telemetry.counter("zoo_generate_shed_total", code=code).inc()
        self._commit(req.uri, {"error": msg, "code": code,
                               "tokens": list(tokens or [])})

    # -- slot lifecycle --------------------------------------------------
    def _slack_ms(self, req: GenRequest) -> Optional[float]:
        if req.deadline_at_ms is None:
            return None
        return req.deadline_at_ms - now_ms()

    def _wants_chunked(self, req: GenRequest) -> bool:
        return (self.prefill_chunk > 0
                and getattr(self.engine, "prefill_chunk", None) is not None
                and int(req.prompt.size) > self.prefill_chunk)

    def _admit(self, req: GenRequest) -> bool:
        """Admission-time shed; True when the request may join."""
        if self.admission is not None:
            n_chunks = 1
            if self._wants_chunked(req):
                n_chunks = math.ceil(int(req.prompt.size)
                                     / self.prefill_chunk)
            tps = float(getattr(self.engine,
                                "expected_tokens_per_step", 1.0) or 1.0)
            ok, code = self.admission.admit_generate(
                self._slack_ms(req), req.max_new_tokens,
                queue_depth=self._queue.qsize(),
                prefill_chunks=n_chunks, tokens_per_step=tps)
            if not ok:
                self._shed(req, code, "deadline unmeetable at admission")
                return False
        try:
            need = pick_cache_bucket(
                int(req.prompt.size) + req.max_new_tokens,
                self.engine.buckets)
        except ValueError:
            self._shed(req, SHED_CAPACITY,
                       "prompt + max_new_tokens exceeds the largest "
                       "cache bucket")
            return False
        if self._state is None:
            self._capacity = need
            self._state = self.engine.alloc(self.max_slots, need)
        elif need > self._capacity:
            self._state = self.engine.grow(self._state, need)
            self._capacity = need
        return True

    def _seat(self, slot: int, req: GenRequest, first: int,
              cached: bool = False):
        """Common join bookkeeping once a slot has its first token."""
        if self._slots[slot] is None:
            self._slots[slot] = _Slot(req=req, t_join=time.perf_counter())
        with self._lock:
            self.counts["joins"] += 1
        telemetry.counter("zoo_generate_join_total").inc()
        telemetry.event("generate_join", uri=req.uri, slot=slot,
                        cached=cached, trace_id=req.trace_id)
        self._note_token(slot, int(first))

    def _join(self, slot: int, req: GenRequest):
        with span("generate/prefill", uri=req.uri, slot=slot,
                  prompt_len=int(req.prompt.size),
                  trace_id=req.trace_id):
            if req.trace_id:
                telemetry.flow("serving/request", req.trace_id, "f")
            self._state, first = self.engine.join(self._state, slot, req)
        self._seat(slot, req, first)

    def _join_batch(self, joins: List[tuple]):
        """Fuse same-boundary joiners into one prefill dispatch."""
        with span("generate/prefill_batch", n=len(joins)):
            for _, req in joins:
                if req.trace_id:
                    telemetry.flow("serving/request", req.trace_id, "f")
            self._state, firsts = self.engine.join_batch(self._state,
                                                         joins)
        telemetry.counter("zoo_generate_batched_join_total").inc(
            len(joins))
        for slot, req in joins:
            self._seat(slot, req, firsts[slot])

    def _try_cached_join(self, slot: int, req: GenRequest) -> bool:
        """Prefix-cache hit: splice rows, skip prefill entirely."""
        fn = getattr(self.engine, "try_cached_join", None)
        if fn is None:
            return False
        with span("generate/prefix_cache_join", uri=req.uri, slot=slot,
                  trace_id=req.trace_id):
            res = fn(self._state, slot, req)
        if res is None:
            return False
        if req.trace_id:
            telemetry.flow("serving/request", req.trace_id, "f")
        self._state, first = res
        self._seat(slot, req, first, cached=True)
        return True

    def _begin_chunked_join(self, slot: int, req: GenRequest):
        """Seat a long-prompt joiner and run its FIRST chunk; the rest
        interleave with decode steps (one chunk per token boundary)."""
        self._slots[slot] = _Slot(req=req, t_join=time.perf_counter(),
                                  prefill_next=0)
        if req.trace_id:
            telemetry.flow("serving/request", req.trace_id, "f")
        telemetry.event("generate_join_begin", uri=req.uri, slot=slot,
                        prompt_len=int(req.prompt.size),
                        trace_id=req.trace_id)
        self._prefill_one_chunk(slot)

    def _prefill_one_chunk(self, slot: int):
        s = self._slots[slot]
        start = s.prefill_next
        lp = int(s.req.prompt.size)
        end = min(start + self.prefill_chunk, lp)
        is_last = end >= lp
        t0 = time.perf_counter()
        with span("generate/prefill_chunk", uri=s.req.uri, slot=slot,
                  start=start, end=end, trace_id=s.req.trace_id):
            self._state, first = self.engine.prefill_chunk(
                self._state, slot, s.req, start, end, is_last)
        dt = time.perf_counter() - t0
        if self.admission is not None:
            self.admission.observe_prefill_chunk(dt)
        telemetry.summary("zoo_generate_prefill_chunk_ms").record(dt * 1e3)
        if is_last:
            s.prefill_next = None
            self._seat(slot, s.req, int(first))
        else:
            s.prefill_next = end

    def _prefill_step(self):
        """Advance every in-flight chunked prefill one chunk."""
        for i, s in enumerate(self._slots):
            if s is not None and s.prefill_next is not None:
                self._prefill_one_chunk(i)

    def _note_token(self, slot: int, tok: int):
        """Record one emitted token; set the slot's finish reason when
        this token ends the sequence (checked in priority order: stop
        token, token budget, deadline)."""
        s = self._slots[slot]
        t_now = time.perf_counter()
        if s.t_first_token is None:
            s.t_first_token = t_now
            telemetry.summary("zoo_generate_ttft_ms").record(
                (t_now - s.req.t_in) * 1e3)
        if telemetry.enabled():
            s.t_tokens.append(t_now)
        s.tokens.append(tok)
        s.last = tok
        with self._lock:
            self.counts["tokens"] += 1
        if s.req.stop_id is not None and tok == s.req.stop_id:
            s.finish = FINISH_STOP
        elif len(s.tokens) >= s.req.max_new_tokens:
            s.finish = FINISH_MAX_TOKENS
        elif self.admission is not None and self.admission.stream_expired(
                s.req.deadline_at_ms):
            s.finish = FINISH_DEADLINE

    def _evict(self, slot: int):
        s = self._slots[slot]
        self._state = self.engine.evict(self._state, slot)
        self._slots[slot] = None
        with self._lock:
            self.counts["evictions"] += 1
        telemetry.counter("zoo_generate_evict_total",
                          reason=s.finish).inc()
        telemetry.event("generate_evict", uri=s.req.uri, slot=slot,
                        reason=s.finish, n_tokens=len(s.tokens),
                        trace_id=s.req.trace_id)
        if s.finish == FINISH_DEADLINE:
            self._shed(s.req, SHED_DEADLINE,
                       "deadline exceeded mid-generation",
                       tokens=s.tokens)
            return
        t_done = time.perf_counter()
        decode_s = max(t_done - s.t_join, 1e-9)
        tokens_per_s = len(s.tokens) / decode_s
        telemetry.summary("zoo_generate_tokens_per_s").record(tokens_per_s)
        timing = {
            "ttft_ms": round((s.t_first_token - s.req.t_in) * 1e3, 3),
            "decode_ms": round(decode_s * 1e3, 3),
            "n_tokens": len(s.tokens),
            "tokens_per_s": round(tokens_per_s, 3),
        }
        if s.req.trace_id:
            timing["trace_id"] = s.req.trace_id
        if s.t_tokens:
            # per-token boundaries relative to join — the waterfall's
            # token ruler (`zoo-serving trace <id>`); recorded only
            # while telemetry is enabled to keep the hot path flat
            timing["token_ms"] = [round((t - s.t_join) * 1e3, 3)
                                  for t in s.t_tokens]
        if s.req.enqueue_ts_ms is not None:
            # lets the client complete the rtt/transport decomposition
            timing["enqueue_ts_ms"] = s.req.enqueue_ts_ms
            timing["server_ms"] = timing["ttft_ms"] + timing["decode_ms"]
            timing["done_ts_ms"] = now_ms()
        self._commit(s.req.uri, {"tokens": list(s.tokens),
                                 "finish": s.finish, "timing": timing})

    # -- loop stages -----------------------------------------------------
    def _evict_finished(self):
        for i, s in enumerate(self._slots):
            if s is not None and s.finish is not None:
                self._evict(i)

    def _oldest_active_deadline(self) -> Optional[float]:
        ds = [s.req.deadline_at_ms for s in self._slots
              if s is not None and s.req.deadline_at_ms is not None]
        return min(ds) if ds else None

    def _refill(self):
        """Fill free slots from the queue.  Static mode refills only
        when the gang is fully drained; continuous mode refills at
        every token boundary.  At empty-gang assembly the adaptive
        batcher may linger a bounded moment to round the gang up to
        the next padding-bucket boundary."""
        active = sum(s is not None for s in self._slots)
        if not self.continuous and active > 0:
            return
        gang_was_empty = active == 0
        free = [i for i, s in enumerate(self._slots) if s is None]
        pending: List[tuple] = []    # joiners for one fused dispatch
        while free:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                n_have = self.max_slots - len(free)
                if not (gang_was_empty and n_have > 0
                        and self.batcher is not None):
                    break
                budget = self.batcher.linger_budget_s(
                    n_have, self._oldest_active_deadline())
                if budget <= 0:
                    break
                try:
                    req = self._queue.get(timeout=budget)
                except queue.Empty:
                    break
            self._note_dequeued(req)
            if not self._admit(req):
                continue
            slot = free.pop(0)
            if self._try_cached_join(slot, req):
                continue
            if self._wants_chunked(req):
                self._begin_chunked_join(slot, req)
                continue
            pending.append((slot, req))
        if len(pending) > 1 and \
                getattr(self.engine, "join_batch", None) is not None:
            self._join_batch(pending)
        else:
            for slot, req in pending:
                self._join(slot, req)

    def _step(self):
        feeds = {i: s.last for i, s in enumerate(self._slots)
                 if s is not None and s.finish is None
                 and s.prefill_next is None}
        if not feeds:
            return
        temps = {i: self._slots[i].req.temperature for i in feeds}
        t0 = time.perf_counter()
        self._state, out = self.engine.step(self._state, feeds, temps)
        dt = time.perf_counter() - t0
        emitted = 0
        for slot, tok in out.items():
            s = self._slots[slot]
            toks = tok if isinstance(tok, (list, tuple)) else (tok,)
            for t in toks:
                # a speculative step can emit several tokens; the
                # sequence may finish mid-list, and trailing tokens
                # past the finish are discarded
                if s.finish is not None:
                    break
                self._note_token(slot, int(t))
                emitted += 1
        if self.admission is not None:
            self.admission.observe_tokens(emitted, dt)
        telemetry.counter("zoo_generate_tokens_total").inc(emitted)
        telemetry.summary("zoo_generate_step_ms").record(dt * 1e3)
        self._publish_occupancy()

    def _publish_occupancy(self):
        active = [s for s in self._slots if s is not None]
        telemetry.gauge("zoo_generate_active_slots").set(len(active))
        if self._capacity > 0:
            used = sum(int(s.req.prompt.size) + len(s.tokens)
                       for s in active)
            telemetry.gauge("zoo_generate_cache_occupancy").set(
                used / (self.max_slots * self._capacity))

    # -- main loop -------------------------------------------------------
    def run(self):
        """Process until :meth:`stop`.  ``stop(drain=True)`` lets the
        queue and gang empty first; ``drain=False`` cancels in-flight
        sequences (committed with ``code="cancelled"``)."""
        while True:
            self._evict_finished()
            self._refill()
            self._prefill_step()
            active = sum(s is not None for s in self._slots)
            if self._stop_evt.is_set():
                if not self._drain:
                    break
                if active == 0 and self._queue.empty():
                    break
            if active == 0:
                # idle: block briefly for the next request
                try:
                    req = self._queue.get(timeout=self.idle_poll_s)
                except queue.Empty:
                    continue
                self._queue.put(req)   # re-enter through _refill
                continue
            self._step()
        if not self._drain:
            for i, s in enumerate(self._slots):
                if s is not None:
                    s.finish = FINISH_CANCELLED
                    self._state = self.engine.evict(self._state, i)
                    self._slots[i] = None
                    self._shed(s.req, FINISH_CANCELLED,
                               "generation cancelled at shutdown",
                               tokens=s.tokens)
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._note_dequeued(req)
                self._shed(req, FINISH_CANCELLED,
                           "generation cancelled at shutdown")
