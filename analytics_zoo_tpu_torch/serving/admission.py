"""Deadline-aware admission control + adaptive re-batching for serving.

A copy of ``analytics_zoo_tpu/serving/admission.py``, which imports no
JAX; its service-time estimates come from the port's own
``utils/profiling.py`` (:class:`Ewma`).

The reference's Cluster Serving queues everything and lets the tail
land where it may; at saturating offered load that makes p99 a function
of queue depth, i.e. of luck.  This module bounds the tail by policy
instead:

- every wire record may carry ``deadline_ms`` (relative to its client
  ``enqueue_ts_ms`` stamp).  At intake the serving loop asks
  :meth:`AdmissionController.admit` whether the record can still meet
  its deadline given the measured per-record service time and the
  current backlog; a record that cannot is **shed immediately** with a
  typed rejection payload (clients see
  :class:`~analytics_zoo_tpu.serving.client.ServingRejected`) instead
  of rotting in the queue and dragging the tail out;
- records whose deadline expires while queued are shed again at
  dispatch time (``shed_expired``) so the accelerator never spends a
  batch on an answer nobody is waiting for;
- :class:`AdaptiveBatcher` gives the compute stage a *linger budget*:
  under load it may wait a bounded extra moment to round a partial
  batch up to the next padding-bucket boundary (continuous
  re-batching), but never longer than the oldest queued record's
  deadline slack allows.

Service-time estimates are :class:`~analytics_zoo_tpu_torch.utils.profiling.
Ewma` so the controller adapts as traffic or the model mix shifts.
All decisions are O(1) per record — this sits on the intake hot path.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.profiling import Ewma

#: typed rejection codes carried in the shed result payload ("code")
SHED_DEADLINE = "shed_deadline"   # unmeetable at admission time
SHED_EXPIRED = "shed_expired"     # expired while queued, shed at dispatch
SHED_CAPACITY = "shed_capacity"   # shed by tenant policy under pressure


def now_ms() -> float:
    """Epoch milliseconds — the wire-timestamp clock (clients and
    workers share a host or NTP; perf_counter is not comparable across
    processes)."""
    return time.time() * 1e3


class AdmissionController:
    """Shed-or-admit decisions from measured service time + backlog.

    ``safety_ms`` is the scheduling slop added to every estimate (queue
    polling, GIL, host jitter); a record is admitted only when
    ``backlog * per_record_ms + batch_ms + safety_ms`` fits inside its
    remaining deadline slack.  Until the first batch has been observed
    both estimates are unknown and only the safety margin is applied —
    the controller never sheds on a guess it has no data for.
    """

    def __init__(self, safety_ms: float = 2.0, alpha: float = 0.25):
        self.safety_ms = float(safety_ms)
        self._record_ms = Ewma(alpha)   # per-record service time
        self._batch_ms = Ewma(alpha)    # per-dispatch wall time
        self._token_ms = Ewma(alpha)    # per-token decode step time
        self._chunk_ms = Ewma(alpha)    # per-prefill-chunk wall time
        self._lock = threading.Lock()
        self.shed_deadline = 0
        self.shed_expired = 0

    # -- estimate maintenance (fed by the writer stage) ----------------
    def observe_batch(self, n: int, seconds: float):
        """One dispatched batch of ``n`` records took ``seconds``."""
        ms = float(seconds) * 1e3
        self._batch_ms.update(ms)
        self._record_ms.update(ms / max(int(n), 1))

    def observe_tokens(self, n_tokens: int, seconds: float):
        """One continuous-batching decode step emitted ``n_tokens``
        (one per in-flight sequence) in ``seconds`` — maintains the
        per-token service estimate the generate admission path uses."""
        if n_tokens > 0:
            self._token_ms.update(float(seconds) * 1e3)

    def observe_prefill_chunk(self, seconds: float):
        """One chunked-prefill step (a fixed-size prompt slice fed
        between decode steps) took ``seconds`` — maintains the per-chunk
        estimate that lets ``admit_generate`` budget a long prompt as N
        interleaved chunk-steps instead of one monolithic stall."""
        self._chunk_ms.update(float(seconds) * 1e3)

    @property
    def record_ms(self) -> float:
        return self._record_ms.value or 0.0

    @property
    def batch_ms(self) -> float:
        return self._batch_ms.value or 0.0

    @property
    def token_ms(self) -> float:
        """EWMA wall time of one decode step (every in-flight sequence
        advances one token per step, so this is also per-sequence)."""
        return self._token_ms.value or 0.0

    @property
    def chunk_ms(self) -> float:
        """EWMA wall time of one prefill chunk; falls back to the batch
        estimate before the first chunk has been observed (a monolithic
        prefill is the degenerate one-chunk case)."""
        return self._chunk_ms.value or self.batch_ms

    # -- decisions ------------------------------------------------------
    def estimate_wait_ms(self, backlog: int) -> float:
        """Expected time for a record arriving now to finish: drain the
        backlog ahead of it plus its own batch."""
        return max(int(backlog), 0) * self.record_ms + self.batch_ms

    def admit(self, slack_ms: Optional[float],
              backlog: int) -> Tuple[bool, Optional[str]]:
        """(admitted, shed_code).  ``slack_ms`` is the record's remaining
        deadline budget (``None`` = no deadline, always admitted)."""
        if slack_ms is None:
            return True, None
        if self.estimate_wait_ms(backlog) + self.safety_ms > slack_ms:
            with self._lock:
                self.shed_deadline += 1
            return False, SHED_DEADLINE
        return True, None

    def admit_generate(self, slack_ms: Optional[float], max_new_tokens: int,
                       queue_depth: int = 0, prefill_chunks: int = 1,
                       tokens_per_step: float = 1.0
                       ) -> Tuple[bool, Optional[str]]:
        """Admission for a generate request: the EWMA deadline shed
        extended with the per-token service estimate. The request is
        admitted only when prefill plus its decode steps plus the wait
        for a free cache slot (``queue_depth`` requests ahead, each
        worth one more token-stream in front of us) fits its slack.

        ``prefill_chunks`` budgets a chunked prompt as N *interleaved*
        chunk-steps — each chunk shares a token boundary with one gang
        decode step, so the request's own prefill timeline is
        ``N * (chunk_ms + token_ms)``, not one monolithic stall.
        ``tokens_per_step`` (> 1 under speculative decoding: accepted
        drafts + 1 per verify step) divides the decode-step count — the
        shed must reflect the real token timeline, or speculation's
        speedup would be invisible to deadline admission.  With no
        observations yet only the batch/safety terms apply — never shed
        on a guess with no data behind it.
        """
        if slack_ms is None:
            return True, None
        chunks = max(int(prefill_chunks), 1)
        if chunks > 1:
            prefill_est = chunks * (self.chunk_ms + self.token_ms)
        else:
            prefill_est = self.batch_ms
        steps = math.ceil(max(int(max_new_tokens), 1) /
                          max(float(tokens_per_step), 1.0))
        est = (prefill_est + self.safety_ms + steps * self.token_ms +
               max(int(queue_depth), 0) * self.token_ms)
        if est > slack_ms:
            with self._lock:
                self.shed_deadline += 1
            return False, SHED_DEADLINE
        return True, None

    def stream_expired(self, deadline_at_ms: Optional[float],
                       at_ms: Optional[float] = None) -> bool:
        """Mid-generation deadline check, one call per emitted token:
        True when even one more decode step lands past the deadline.
        The scheduler evicts the sequence and commits a typed
        ``shed_deadline`` payload carrying the partial tokens."""
        if deadline_at_ms is None:
            return False
        at = now_ms() if at_ms is None else at_ms
        if at + self.token_ms + self.safety_ms > deadline_at_ms:
            with self._lock:
                self.shed_deadline += 1
            return True
        return False

    def expired(self, deadline_at_ms: Optional[float],
                at_ms: Optional[float] = None) -> bool:
        """True when a queued record can no longer produce a useful
        answer: its deadline lands before even an immediate dispatch
        would complete."""
        if deadline_at_ms is None:
            return False
        at = now_ms() if at_ms is None else at_ms
        if at + self.batch_ms + self.safety_ms > deadline_at_ms:
            with self._lock:
                self.shed_expired += 1
            return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {"shed_deadline": self.shed_deadline,
                    "shed_expired": self.shed_expired,
                    "est_record_ms": round(self.record_ms, 3),
                    "est_batch_ms": round(self.batch_ms, 3),
                    "est_token_ms": round(self.token_ms, 3),
                    "est_chunk_ms": round(self.chunk_ms, 3),
                    "safety_ms": self.safety_ms}


#: implicit tenant for traffic no SLO class binds (weight 1, priority 0,
#: never pressure-shed — it declared no wait bound)
DEFAULT_TENANT = "_default"


class TenantScheduler:
    """Weighted-fair intake + priority sheds across SLO classes.

    The single-tenant intake path admits records in stream order, so one
    tenant's burst monopolizes the pipeline and burns every other
    tenant's error budget.  This scheduler puts a per-tenant queue
    between stream intake and the decode stage
    (docs/multi-tenancy.md#scheduling):

    - **classify**: route each record to the most-specific SLO class for
      its (model, version) — exact match > model-only > catch-all —
      falling back to the implicit ``_default`` tenant;
    - **weighted-fair drain**: deficit round-robin — each pass a class
      earns ``weight * quantum`` credit and drains whole records while
      credit lasts, so a weight-3 class gets 3 of every 4 slots while
      both have backlog, yet an idle class's share flows to the others
      (work-conserving; an empty class's deficit resets so it cannot
      hoard credit for a later burst);
    - **priority sheds**: under predicted-wait pressure the scheduler
      sheds the *oldest* queued record of the least-important violating
      class (highest ``priority`` number; lower = more important) until
      every remaining class's predicted wait fits its ``shed_wait_ms``
      bound — so a low-priority burst absorbs the typed
      ``shed_capacity`` rejections while the high-priority tenant keeps
      its latency objective.

    Classes are any objects with ``name``/``weight``/``priority``/
    ``model``/``version``/``shed_wait_ms`` attributes —
    :class:`~analytics_zoo_tpu.utils.slo.SloClass` in production.
    """

    def __init__(self, classes: Sequence = (), quantum: float = 1.0):
        self.classes = list(classes)
        self.quantum = float(quantum)
        self.class_of: Dict[str, object] = {c.name: c
                                            for c in self.classes}
        self._order = [c.name for c in self.classes]
        if DEFAULT_TENANT not in self.class_of:
            self._order.append(DEFAULT_TENANT)
        self._queues: Dict[str, deque] = {n: deque() for n in self._order}
        self._deficit: Dict[str, float] = {n: 0.0 for n in self._order}
        self._lock = threading.Lock()
        self.offered: Dict[str, int] = {n: 0 for n in self._order}
        self.drained: Dict[str, int] = {n: 0 for n in self._order}
        self.shed: Dict[str, int] = {n: 0 for n in self._order}

    # -- class attributes with _default fallbacks ----------------------
    def _weight(self, name: str) -> float:
        cls = self.class_of.get(name)
        return float(getattr(cls, "weight", 1.0)) if cls else 1.0

    def _priority(self, name: str) -> int:
        cls = self.class_of.get(name)
        return int(getattr(cls, "priority", 0)) if cls else 0

    def _shed_wait_ms(self, name: str) -> Optional[float]:
        cls = self.class_of.get(name)
        return getattr(cls, "shed_wait_ms", None) if cls else None

    # -- routing --------------------------------------------------------
    def classify(self, model: Optional[str],
                 version: Optional[str]) -> str:
        """Tenant name for a record's (model, version): exact match >
        model-only > catch-all > implicit ``_default``."""
        best, best_rank = DEFAULT_TENANT, -1
        for cls in self.classes:
            if cls.model is None:
                rank = 0
            elif cls.model == model:
                rank = 2 if cls.version is not None else 1
                if cls.version is not None and cls.version != version:
                    continue
            else:
                continue
            if rank > best_rank:
                best, best_rank = cls.name, rank
        return best

    # -- intake ---------------------------------------------------------
    def offer(self, tenant: str, item) -> None:
        """Queue one intake item (whatever the serving loop carries —
        (meta, record) tuples) under its tenant."""
        with self._lock:
            if tenant not in self._queues:
                tenant = DEFAULT_TENANT
            self._queues[tenant].append(item)
            self.offered[tenant] += 1

    def drain(self, max_items: int) -> List:
        """Up to ``max_items`` items in weighted-fair (DRR) order."""
        out: List = []
        with self._lock:
            while (len(out) < max_items
                   and any(self._queues[n] for n in self._order)):
                for name in self._order:
                    q = self._queues[name]
                    if not q:
                        self._deficit[name] = 0.0
                        continue
                    self._deficit[name] += self._weight(name) * self.quantum
                    while (q and self._deficit[name] >= 1.0
                           and len(out) < max_items):
                        out.append(q.popleft())
                        self._deficit[name] -= 1.0
                        self.drained[name] += 1
                    if not q:
                        self._deficit[name] = 0.0
        return out

    # -- pressure sheds -------------------------------------------------
    def shed_under_pressure(self, controller: AdmissionController,
                            extra_backlog: int = 0) -> List[Tuple[str, object]]:
        """Shed queued items until every class's predicted wait fits its
        ``shed_wait_ms`` bound.  Returns [(tenant, item), ...] oldest
        first; the caller commits the typed ``shed_capacity`` payloads.

        ``extra_backlog`` is the pipeline's already-admitted depth (the
        records queued ahead of every tenant queue).  Victim order: the
        highest priority *number* (least important) among violating
        classes, largest backlog as tie-break — so a low class's burst
        is shed away before a high class loses anything."""
        out: List[Tuple[str, object]] = []
        with self._lock:
            while True:
                backlog = (max(int(extra_backlog), 0)
                           + sum(len(q) for q in self._queues.values()))
                wait = (controller.estimate_wait_ms(backlog)
                        + controller.safety_ms)
                victims = [
                    n for n in self._order
                    if self._queues[n]
                    and self._shed_wait_ms(n) is not None
                    and wait > self._shed_wait_ms(n)]
                if not victims:
                    return out
                name = max(victims, key=lambda n: (self._priority(n),
                                                   len(self._queues[n])))
                out.append((name, self._queues[name].popleft()))
                self.shed[name] += 1

    # -- observability --------------------------------------------------
    def queued_total(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"queued": len(self._queues[n]),
                        "offered": self.offered[n],
                        "drained": self.drained[n],
                        "shed_capacity": self.shed[n],
                        "weight": self._weight(n),
                        "priority": self._priority(n),
                        "shed_wait_ms": self._shed_wait_ms(n)}
                    for n in self._order
                    if self.offered[n] or n != DEFAULT_TENANT}


class BacklogAutoscaler:
    """Backlog-driven worker-count policy for the serving fleet.

    Pure decision logic (no process management — ServingFleet owns
    that): the supervisor feeds it the shared stream's backlog plus the
    workers' EWMA service estimates and the current worker count; it
    answers with the desired count and a reason string for the
    autoscale trace (docs/serving-network.md#autoscaling).

    - **scale up** when the predicted wait for a record arriving now —
      backlog drained across the current workers plus one batch —
      exceeds ``scale_up_fraction`` of ``target_ms`` (the deadline-slack
      budget scaling defends).  The jump is sized to bring the wait
      back under the threshold in one step rather than one worker per
      poll.
    - **scale down** one worker at a time after ``idle_s`` of
      sustained-empty backlog (a momentary gap between bursts must not
      flap the fleet).
    - ``cooldown_s`` separates consecutive actions so a decision is
      judged on post-change evidence, not on the backlog it inherited.

    Until the first batch has been observed ``record_ms`` is 0 and the
    predicted wait is just ``batch_ms`` — the policy never grows the
    fleet on a guess it has no data for.
    """

    def __init__(self, min_workers: int, max_workers: int,
                 target_ms: float = 250.0,
                 scale_up_fraction: float = 0.5,
                 idle_s: float = 3.0, cooldown_s: float = 2.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}")
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.target_ms = float(target_ms)
        self.scale_up_fraction = float(scale_up_fraction)
        self.idle_s = float(idle_s)
        self.cooldown_s = float(cooldown_s)
        self._idle_since: Optional[float] = None
        self._last_change: float = -1e12

    def predicted_wait_ms(self, backlog: int, record_ms: float,
                          batch_ms: float, workers: int, *,
                          gen_steps: float = 0.0,
                          token_ms: float = 0.0) -> float:
        """Expected finish time for a record arriving now, with the
        backlog drained in parallel across ``workers``.  ``gen_steps``
        weighs the generate backlog in queued *decode steps* times the
        EWMA per-token cost — one queued 512-token generation is 512
        steps of work, not one record."""
        return (max(int(backlog), 0) * max(record_ms, 0.0)
                / max(int(workers), 1)
                + max(gen_steps, 0.0) * max(token_ms, 0.0)
                / max(int(workers), 1)
                + max(batch_ms, 0.0))

    def desired(self, backlog: int, record_ms: float, batch_ms: float,
                workers: int, now: Optional[float] = None, *,
                gen_steps: float = 0.0, token_ms: float = 0.0
                ) -> Tuple[int, Optional[str]]:
        """(desired_workers, reason) — reason is None when no change."""
        now = time.time() if now is None else now
        workers = max(int(workers), 1)
        wait = self.predicted_wait_ms(backlog, record_ms, batch_ms,
                                      workers, gen_steps=gen_steps,
                                      token_ms=token_ms)
        threshold = self.scale_up_fraction * self.target_ms
        if backlog > 0 or gen_steps > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        if now - self._last_change < self.cooldown_s:
            return workers, None
        if wait > threshold and workers < self.max_workers:
            # size the jump: workers needed so the drain term (predict
            # records + generate decode steps) fits the slack left
            # after one batch (>= +1, <= max)
            slack = max(threshold - batch_ms, 1.0)
            work_ms = (max(int(backlog), 0) * max(record_ms, 0.0)
                       + max(gen_steps, 0.0) * max(token_ms, 0.0))
            need = math.ceil(work_ms / slack) \
                if work_ms > 0 else workers + 1
            target = min(self.max_workers, max(workers + 1, need))
            self._last_change = now
            self._idle_since = None
            detail = f" + {gen_steps:.0f} decode steps" \
                if gen_steps > 0 else ""
            return target, (f"predicted wait {wait:.0f}ms > "
                            f"{threshold:.0f}ms at backlog "
                            f"{backlog}{detail}")
        if (workers > self.min_workers and self._idle_since is not None
                and now - self._idle_since >= self.idle_s):
            self._last_change = now
            return workers - 1, (f"idle {now - self._idle_since:.1f}s "
                                 f">= {self.idle_s:.1f}s")
        return workers, None


class AdaptiveBatcher:
    """Linger budget for the compute stage's batch assembly.

    The greedy assembler takes whatever is already decoded; with a
    linger budget it may additionally block a bounded moment for more
    records so partial batches round up to the next padding-bucket
    boundary — amortizing MXU time under load without ever spending a
    queued record's deadline slack.  ``linger_ms = 0`` (the default)
    disables lingering and preserves the latency-first behavior.
    """

    def __init__(self, buckets: Sequence[int],
                 controller: Optional[AdmissionController] = None,
                 linger_ms: float = 0.0):
        self.buckets = sorted(buckets)
        self.controller = controller
        self.linger_ms = max(float(linger_ms), 0.0)

    def next_boundary(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def linger_budget_s(self, n_have: int,
                        oldest_deadline_at_ms: Optional[float],
                        at_ms: Optional[float] = None) -> float:
        """Seconds the assembler may block waiting for record number
        ``n_have + 1``; 0.0 means dispatch now."""
        if self.linger_ms <= 0.0 or n_have >= self.buckets[-1]:
            return 0.0
        if n_have in self.buckets:
            # already exactly on a bucket boundary: lingering would only
            # trade latency for a *larger* signature — dispatch
            return 0.0
        budget = self.linger_ms
        if oldest_deadline_at_ms is not None:
            at = now_ms() if at_ms is None else at_ms
            cost = (self.controller.batch_ms + self.controller.safety_ms
                    if self.controller is not None else 0.0)
            budget = min(budget, oldest_deadline_at_ms - at - cost)
        return max(budget, 0.0) / 1e3
