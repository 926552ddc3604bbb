"""Length- and cache-aware placement for generative fleet traffic.

Counterpart of ``analytics_zoo_tpu/serving/routing.py``, copied: the
same reports give the same decisions, and a re-driven record is written
through the port's msgpack codec (``wire.py``), so its file is the JAX
package's.

Fleet placement used to be blind: every worker claims any record off
the shared stream, so one worker's long generations head-of-line-block
another's short ones, and a warm :class:`PrefixCache` entry is wasted
whenever the repeat prompt lands on a cold worker.  This module places
them instead:

- **load reports** piggyback on the existing fleet heartbeats
  (``health/worker-N.json``): free cache slots, queued decode steps,
  the admission EWMA token/prefill-chunk costs, and a bounded digest
  of resident prefix-cache keys — no new RPC, no coordinator;
- :class:`GenerateRouter` scores candidate workers by **estimated
  completion cost** — prefill chunks x chunk_ms + expected decode
  steps x token_ms + predicted queue wait — with a strong affinity
  bonus for workers already holding the request's prefix hash warm
  (a warm worker also skips the prefill term entirely).  With no EWMA
  observations yet it falls back to least-loaded; with no fresh report
  at all it returns None and the caller degrades to today's any-claim
  behavior;
- **per-worker substreams**: a routed record lands in the target
  worker's own FIFO stream (``<root>/gen-wN/`` next to the shared
  stream).  Claims stay atomic renames, so exactly-once holds per
  substream exactly as it does fleet-wide, and placement ties break on
  the shard fabric's rendezvous ranking so equal-cost prompts spread
  deterministically;
- **redelivery**: :meth:`RoutedGenerateQueue.sweep_worker` atomically
  moves a dead worker's unclaimed substream records back onto the
  shared any-claim stream (a rename exists in exactly one stream at a
  time — nothing is lost, nothing is duplicated), and
  :meth:`RoutedGenerateQueue.reenqueue_missing` re-drives records a
  SIGKILLed worker claimed-but-never-committed from a bounded pending
  ledger, rewriting the ORIGINAL rid so a consumer that did serve it
  drops the duplicate through its delivery ledger — the shard fabric's
  dedup-token move over files.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import telemetry
from . import wire
from .generation import prompt_key
from .queue_backend import FileStreamQueue, StreamQueue, get_queue_backend
from .shard_fabric import rendezvous_rank

__all__ = ["WorkerReport", "RouteDecision", "GenerateRouter",
           "RoutedGenerateQueue", "WorkerIntakeQueue", "gen_substream",
           "load_reports", "substream_backlog", "sweep_substream",
           "file_root"]

#: reports older than this are not trusted for placement
STALE_AFTER_S = 5.0
#: bounded producer-side (uri -> record) re-drive ammunition
PENDING_WINDOW = 8192
#: prefix-key digest: how many resident keys ride a heartbeat, and how
#: many hex chars of each (sha1 truncation; 12 nibbles ~ no collisions
#: at any plausible cache size)
PREFIX_DIGEST_KEYS = 32
PREFIX_KEY_WIDTH = 12


def gen_substream(worker_id: int) -> str:
    """Stream name of worker N's private generate substream."""
    return f"gen-w{int(worker_id)}"


def file_root(src: Optional[str]) -> Optional[str]:
    """Directory root of a ``file:`` transport spec; None for any other
    transport (no substream support — routing degrades to any-claim)."""
    if src and src.startswith("file:"):
        return src[len("file:"):]
    return None


# ---------------------------------------------------------------------------
# load reports
# ---------------------------------------------------------------------------

@dataclass
class WorkerReport:
    """One worker's heartbeat-borne routing snapshot."""

    worker_id: int
    ts: float
    free_slots: int = 0
    active_slots: int = 0
    queue_depth: int = 0
    queued_steps: float = 0.0
    token_ms: float = 0.0
    chunk_ms: float = 0.0
    prefix_keys: Tuple[str, ...] = ()
    routed_in: int = 0
    affinity_hits: int = 0

    def age_s(self, now: Optional[float] = None) -> float:
        return max((time.time() if now is None else now) - self.ts, 0.0)

    def holds_prefix(self, key: str) -> bool:
        """True when this worker's cache digest covers ``key`` (digest
        entries are truncated hashes, so match on the prefix)."""
        return any(key.startswith(k) for k in self.prefix_keys if k)

    @classmethod
    def from_health(cls, worker_id: int, payload: dict) -> "WorkerReport":
        routing = payload.get("routing") or {}
        adm = payload.get("admission") or {}
        return cls(
            worker_id=int(worker_id),
            ts=float(payload.get("ts") or 0.0),
            free_slots=int(routing.get("free_slots") or 0),
            active_slots=int(routing.get("active_slots") or 0),
            queue_depth=int(routing.get("queue_depth") or 0),
            queued_steps=float(routing.get("queued_steps") or 0.0),
            token_ms=float(adm.get("est_token_ms") or 0.0),
            chunk_ms=float(adm.get("est_chunk_ms") or 0.0),
            prefix_keys=tuple(routing.get("prefix_keys") or ()),
            routed_in=int(routing.get("routed_in") or 0),
            affinity_hits=int(routing.get("affinity_hits") or 0))


def load_reports(workdir: str) -> Dict[int, WorkerReport]:
    """Parse every heartbeat under ``<workdir>/health`` that carries a
    routing section (workers without a generate engine publish none)."""
    from .fleet import HEALTH_DIR, read_health

    out: Dict[int, WorkerReport] = {}
    hdir = os.path.join(workdir, HEALTH_DIR)
    try:
        names = os.listdir(hdir)
    except OSError:
        return out
    for n in names:
        if not (n.startswith("worker-") and n.endswith(".json")):
            continue
        try:
            wid = int(n[len("worker-"):-len(".json")])
        except ValueError:
            continue
        payload = read_health(workdir, wid)
        if payload and payload.get("routing") is not None:
            out[wid] = WorkerReport.from_health(wid, payload)
    return out


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclass
class RouteDecision:
    worker_id: int
    reason: str              # "affinity" | "cost" | "least_loaded"
    est_cost_ms: float
    affinity: bool


class GenerateRouter:
    """Cost-model placement policy over worker load reports.

    Pure decision logic (no I/O): callers feed it the parsed reports
    and a request's prompt + token budget; it answers with the target
    worker or None when every report is stale — the signal to degrade
    to the shared any-claim stream.
    """

    def __init__(self, stale_after_s: float = STALE_AFTER_S,
                 affinity_bonus_ms: float = 50.0,
                 default_steps: int = 32):
        self.stale_after_s = float(stale_after_s)
        self.affinity_bonus_ms = float(affinity_bonus_ms)
        self.default_steps = max(int(default_steps), 1)
        self.counts = {"decisions": 0, "affinity": 0, "cost": 0,
                       "least_loaded": 0, "stale_fallback": 0}

    def decide(self, prompt, max_new_tokens: int,
               reports, prefill_chunks: int = 1,
               now: Optional[float] = None) -> Optional[RouteDecision]:
        """Pick the worker with the lowest estimated completion cost.

        - fresh reports + EWMA costs: prefill + decode + queue-wait
          scoring with the affinity bonus (a warm worker skips the
          prefill term AND gets ``affinity_bonus_ms`` off);
        - fresh reports, no cost observations yet: least-loaded
          (queued steps, then free slots);
        - no fresh report: None (caller uses the shared stream).

        Ties break on the shard fabric's rendezvous ranking of the
        prompt key, so equal-cost placement is deterministic and
        spreads across the fleet instead of pinning worker 0.
        """
        now = time.time() if now is None else now
        rows = list(reports.values()) if isinstance(reports, dict) \
            else list(reports)
        fresh = [r for r in rows if r.age_s(now) <= self.stale_after_s]
        telemetry.gauge("zoo_route_fresh_workers").set(len(fresh))
        if not fresh:
            self.counts["stale_fallback"] += 1
            telemetry.counter("zoo_route_stale_fallback_total").inc()
            return None
        key = prompt_key(np.asarray(prompt, np.int64))
        order = rendezvous_rank(key, [str(r.worker_id) for r in fresh])
        hrw_pos = {fresh[i].worker_id: pos for pos, i in enumerate(order)}
        steps = max(int(max_new_tokens or self.default_steps), 1)
        chunks = max(int(prefill_chunks), 1)
        toks = [r.token_ms for r in fresh if r.token_ms > 0]
        mean_token_ms = sum(toks) / len(toks) if toks else 0.0
        have_costs = mean_token_ms > 0
        best: Optional[Tuple[float, int, WorkerReport, bool]] = None
        for r in fresh:
            warm = r.holds_prefix(key)
            if have_costs:
                token_ms = r.token_ms or mean_token_ms
                chunk_ms = r.chunk_ms or token_ms
                prefill = 0.0 if warm else chunks * chunk_ms
                queue_wait = (r.queued_steps * token_ms
                              / max(r.free_slots, 1))
                cost = prefill + steps * token_ms + queue_wait
            else:
                # least-loaded: pending decode steps dominate, queued
                # records weigh their full budget, free slots credit
                cost = (r.queued_steps + r.queue_depth * steps
                        - r.free_slots)
            if warm:
                cost -= self.affinity_bonus_ms
            cand = (cost, hrw_pos[r.worker_id], r, warm)
            if best is None or cand[:2] < best[:2]:
                best = cand
        cost, _pos, row, warm = best
        self.counts["decisions"] += 1
        telemetry.counter("zoo_route_decisions_total").inc()
        if warm:
            reason = "affinity"
            self.counts["affinity"] += 1
            telemetry.counter("zoo_route_affinity_total").inc()
        elif have_costs:
            reason = "cost"
            self.counts["cost"] += 1
        else:
            reason = "least_loaded"
            self.counts["least_loaded"] += 1
            telemetry.counter("zoo_route_least_loaded_total").inc()
        return RouteDecision(worker_id=row.worker_id, reason=reason,
                             est_cost_ms=float(cost), affinity=warm)

    def stats(self) -> dict:
        return dict(self.counts)


# ---------------------------------------------------------------------------
# substream plumbing (file transport)
# ---------------------------------------------------------------------------

def _stream_files(dirpath: str) -> List[str]:
    try:
        return sorted(n for n in os.listdir(dirpath)
                      if n.endswith(".msgpack"))
    except OSError:
        return []


def substream_backlog(root: str) -> int:
    """Unclaimed records across every ``gen-w*`` substream — the part
    of the fleet backlog the shared stream's ``stream_len`` can't see."""
    total = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for n in names:
        if n.startswith("gen-w"):
            total += len(_stream_files(os.path.join(root, n)))
    return total


def sweep_substream(root: str, worker_id: int,
                    shared_name: str = "image_stream") -> int:
    """Atomically move worker N's unclaimed substream records onto the
    shared any-claim stream (dead/retired worker re-drive).  Filenames
    (rids) are preserved, so FIFO order and consumer-ledger dedup both
    survive the move; a rename lives in exactly one stream at a time,
    so nothing is lost or double-claimed."""
    sdir = os.path.join(root, gen_substream(worker_id))
    shared = os.path.join(root, shared_name)
    os.makedirs(shared, exist_ok=True)
    n = 0
    for name in _stream_files(sdir):
        try:
            os.rename(os.path.join(sdir, name),
                      os.path.join(shared, name))
            n += 1
        except OSError:
            continue   # claimed (or swept) by someone else mid-walk
    if n:
        telemetry.counter("zoo_route_swept_total").inc(n)
    return n


def _write_with_rid(dirpath: str, rid: str, record: dict):
    """Atomic stream write under a caller-chosen rid — the re-drive
    path reuses the ORIGINAL rid so a consumer that already served the
    record drops the redelivery via its DeliveryLedger (the shard
    fabric's reused-dedup-token move, in files)."""
    payload = wire.packb(record)
    os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirpath, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    os.rename(tmp, os.path.join(dirpath, rid + ".msgpack"))


class RoutedGenerateQueue:
    """Producer-side routed placement over per-worker substreams.

    Wraps the shared transport handle: generate records are placed on
    the routed worker's private substream when a fresh load report
    says so, and on the shared any-claim stream otherwise (stale
    reports, non-file transports, non-generate records) — so the worst
    case is exactly today's behavior.  Result access delegates to the
    shared handle (results are per-root, substreams share them).
    """

    def __init__(self, workdir: str, src: Optional[str] = None,
                 base: Optional[StreamQueue] = None,
                 router: Optional[GenerateRouter] = None):
        self.workdir = workdir
        self.src = src or f"file:{workdir}"
        self.base = base if base is not None else \
            get_queue_backend(self.src)
        self.root = file_root(self.src)
        self.router = router or GenerateRouter()
        self._subs: Dict[int, FileStreamQueue] = {}
        self._pending: "OrderedDict[str, Tuple[dict, str]]" = OrderedDict()
        self._lock = threading.Lock()
        self.routed = 0
        self.unrouted = 0
        self.swept = 0
        self.reenqueued = 0

    # -- placement ------------------------------------------------------
    def _substream(self, wid: int) -> FileStreamQueue:
        q = self._subs.get(wid)
        if q is None:
            q = self._subs[wid] = FileStreamQueue(
                self.root, name=gen_substream(wid))
        return q

    def reports(self) -> Dict[int, WorkerReport]:
        return load_reports(self.workdir)

    def enqueue(self, record: dict) -> str:
        rid, _decision = self.enqueue_routed(record)
        return rid

    def enqueue_routed(self, record: dict
                       ) -> Tuple[str, Optional[RouteDecision]]:
        """Place one wire record; returns (rid, decision) where a None
        decision means the shared any-claim stream took it."""
        gen = record.get("generate") if isinstance(record, dict) else None
        decision = None
        if gen is not None and self.root is not None:
            decision = self.router.decide(
                gen.get("prompt") or [],
                int(gen.get("max_new_tokens") or 0),
                self.reports())
        if decision is None:
            rid = self.base.enqueue(record)
            self.unrouted += 1
        else:
            record = dict(record, routed_to=decision.worker_id)
            rid = self._substream(decision.worker_id).enqueue(record)
            self.routed += 1
        self._note_pending(record, rid)
        return rid, decision

    def _note_pending(self, record: dict, rid: str):
        uri = record.get("uri") if isinstance(record, dict) else None
        if uri is None:
            return
        with self._lock:
            self._pending[uri] = (record, rid)
            self._pending.move_to_end(uri)
            while len(self._pending) > PENDING_WINDOW:
                self._pending.popitem(last=False)

    def _forget_pending(self, uris: Iterable[str]):
        with self._lock:
            for uri in uris:
                self._pending.pop(uri, None)

    # -- redelivery -----------------------------------------------------
    def sweep_worker(self, worker_id: int) -> int:
        """Move a dead worker's unclaimed substream records back onto
        the shared stream (see :func:`sweep_substream`)."""
        if self.root is None:
            return 0
        shared_name = getattr(self.base, "stream_dir", None)
        name = os.path.basename(shared_name) if shared_name \
            else "image_stream"
        n = sweep_substream(self.root, worker_id, shared_name=name)
        self.swept += n
        return n

    def _rid_still_queued(self, record: dict, rid: str) -> bool:
        """True while the original enqueue file is still unclaimed on
        the shared stream or its routed substream — re-driving such a
        record would put TWO claimable copies in flight (a restarted
        worker serves one, a survivor the other: double delivery)."""
        fname = rid + ".msgpack"
        dirs = [getattr(self.base, "stream_dir", None) or
                os.path.join(self.root, "image_stream")]
        wid = record.get("routed_to")
        if wid is not None:
            dirs.append(os.path.join(self.root, gen_substream(wid)))
        return any(os.path.exists(os.path.join(d, fname)) for d in dirs)

    def reenqueue_missing(self, uris: Iterable[str]) -> int:
        """Re-drive records whose results never arrived (claimed by a
        SIGKILLed worker that died before committing).  Rewrites each
        record onto the shared stream under its original rid, so a
        consumer that did serve it skips the duplicate.  Records still
        queued (unclaimed file on disk) are skipped — they will be
        served or swept, and a second copy would double-deliver.
        Returns how many were re-sent; uris outside the pending window
        are skipped."""
        if self.root is None:
            return 0
        shared_dir = getattr(self.base, "stream_dir", None) or \
            os.path.join(self.root, "image_stream")
        n = 0
        for uri in uris:
            with self._lock:
                entry = self._pending.get(uri)
            if entry is None:
                continue
            record, rid = entry
            if self._rid_still_queued(record, rid):
                continue
            _write_with_rid(shared_dir, rid, record)
            n += 1
        if n:
            self.reenqueued += n
            telemetry.counter("zoo_route_reenqueued_total").inc(n)
        return n

    # -- result access (delegated; results are shared per root) ---------
    def get_result(self, uri: str, pop: bool = True):
        v = self.base.get_result(uri, pop=pop)
        if v is not None and pop:
            self._forget_pending([uri])
        return v

    def all_results(self, pop: bool = True) -> Dict[str, bytes]:
        out = self.base.all_results(pop=pop)
        if pop and out:
            self._forget_pending(out.keys())
        return out

    def put_results(self, results: Dict[str, bytes]):
        self.base.put_results(results)

    def stream_len(self) -> int:
        n = self.base.stream_len()
        if self.root is not None:
            n += substream_backlog(self.root)
        return n

    def stats(self) -> dict:
        return {"routed": self.routed, "unrouted": self.unrouted,
                "swept": self.swept, "reenqueued": self.reenqueued,
                "router": self.router.stats()}


class WorkerIntakeQueue(StreamQueue):
    """Worker-side intake over (own substream, shared stream).

    ``read_batch`` drains the worker's private substream first (routed
    records keep FIFO within their substream), then tops up from the
    shared any-claim stream — so a routed fleet still serves unrouted
    traffic, and a fleet with no router behaves exactly as before
    (the substream is simply empty).  Everything else — results,
    trim, enqueue — delegates to the shared handle, which owns the
    per-root results map.
    """

    def __init__(self, root: str, worker_id: int,
                 shared: Optional[FileStreamQueue] = None):
        self.worker_id = int(worker_id)
        self.shared = shared if shared is not None \
            else FileStreamQueue(root)
        self.sub = FileStreamQueue(root, name=gen_substream(worker_id))

    def enqueue(self, record: dict) -> str:
        return self.shared.enqueue(record)

    def read_batch(self, max_items: int, timeout: float = 1.0):
        out = self.sub.read_batch(max_items, timeout=0.0)
        want = int(max_items) - len(out)
        if want > 0:
            out.extend(self.shared.read_batch(
                want, timeout=0.0 if out else timeout))
        return out

    def put_result(self, uri: str, value: bytes):
        self.shared.put_result(uri, value)

    def put_results(self, results: Dict[str, bytes]):
        self.shared.put_results(results)

    def get_result(self, uri: str, pop: bool = True):
        return self.shared.get_result(uri, pop=pop)

    def all_results(self, pop: bool = True):
        return self.shared.all_results(pop=pop)

    def stream_len(self) -> int:
        return self.shared.stream_len() + self.sub.stream_len()

    def trim(self, keep_last: int):
        self.shared.trim(keep_last)

    def consumer_stats(self) -> dict:
        agg = dict(self.shared.consumer_stats())
        for k, v in self.sub.consumer_stats().items():
            if isinstance(v, (int, float)):
                agg[k] = agg.get(k, 0) + v
        return agg
