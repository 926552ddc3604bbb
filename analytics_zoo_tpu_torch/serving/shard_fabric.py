"""ShardedStreamQueue: client-sharded broker fabric for Cluster Serving.

Counterpart of ``analytics_zoo_tpu/serving/shard_fabric.py``, copied:
the same hash puts the same key on the same shard in both packages, and
:func:`spawn_broker_proc` starts the port's own broker module.

One :class:`~analytics_zoo_tpu_torch.serving.socket_queue.StreamQueueBroker`
is a SPOF and a throughput ceiling (its stream lives under one lock in
one process).  This module breaks that ceiling without adding any
coordination service: N independent brokers plus **client-side
rendezvous (HRW) hashing** on the record key, so every producer and
consumer computes the same record→shard placement from nothing but the
shard list.

- ``data.src: shard://host:p1,host:p2,...`` behind the existing
  :func:`~analytics_zoo_tpu_torch.serving.queue_backend.get_queue_backend`
  seam — serving loops, fleets, and clients are unchanged;
- **placement**: a record's uri is ranked against every shard with a
  stable hash; the top-ranked *healthy* shard gets the enqueue.  HRW's
  minimal-disruption property means a shard death only moves the keys
  it owned — every other key keeps its placement;
- **health**: a failed shard op marks the shard dead and starts a
  probe clock; probes (a cheap ``stream_len``) run at most every
  ``probe_interval_s`` and resurrect the shard when it answers again;
- **failover**: enqueue walks the HRW ranking past dead shards,
  reusing one dedup token across attempts so a retry that raced the
  original insert cannot double-insert on the same broker.  A bounded
  client-side pending ledger keeps (record, token) per uri until its
  result is seen, so :meth:`reenqueue_missing` can re-drive records a
  SIGKILLed broker swallowed — combined with per-uri idempotent
  results and each consumer's DeliveryLedger this preserves
  exactly-once *results* under at-least-once delivery;
- **consumption**: ``read_batch`` drains all healthy shards round-robin
  (FIFO holds *per shard*); redelivery-on-EOF and claim-timeout sweeps
  keep working unchanged per shard, because each shard is simply a
  broker.  ``put_results`` routes each result to the shard whose claim
  it releases (tracked at delivery), so the piggybacked ack still costs
  no extra round trip.

The fabric is thread-safe: the per-shard clients already keep one
connection per calling thread, and all fabric-level state (health,
claims, pending ledger) sits under one lock off the wire path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time
import threading
import uuid
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..launcher.supervisor import inject_pythonpath
from .queue_backend import StreamQueue
from .socket_queue import SocketStreamQueue, StreamQueueBroker

__all__ = ["ShardedStreamQueue", "LocalShardFabric", "parse_shard_spec",
           "rendezvous_rank", "spawn_broker_proc", "wait_broker_up"]

#: bounded client-side memories (uri -> claim shard / pending record)
CLAIM_WINDOW = 65536
PENDING_WINDOW = 8192

#: blocking slice per shard when polling more than one (read/wait loops)
POLL_SLICE_S = 0.05


def parse_shard_spec(spec: str) -> List[Tuple[str, int]]:
    """``shard://host:p1,host:p2,...`` -> [(host, port), ...].  An entry
    without a ``:`` is a bare port inheriting the previous entry's host
    (``shard://127.0.0.1:7001,7002``)."""
    rest = spec[len("shard://"):] if spec.startswith("shard://") else spec
    endpoints: List[Tuple[str, int]] = []
    host = None
    for entry in rest.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            host, _, port = entry.rpartition(":")
        else:
            port = entry
        if not host:
            raise ValueError(f"bad shard spec {spec!r} "
                             "(want shard://host:p1[,host:p2|,p3...])")
        endpoints.append((host, int(port)))
    if not endpoints:
        raise ValueError(f"bad shard spec {spec!r}: no endpoints")
    return endpoints


def _score(key: str, shard_id: str) -> int:
    # stable across processes and runs (python hash() is salted), cheap
    # enough for the enqueue hot path
    h = hashlib.blake2b(f"{key}|{shard_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


def rendezvous_rank(key: str, shard_ids: Sequence[str]) -> List[int]:
    """Shard indices ordered by HRW score (winner first).  Removing one
    id never reorders the survivors — the minimal-movement property the
    failover path relies on."""
    return sorted(range(len(shard_ids)),
                  key=lambda i: _score(key, shard_ids[i]), reverse=True)


class _Shard:
    """One broker endpoint: its client handle + health state."""

    def __init__(self, host: str, port: int, connect_timeout: float):
        self.host, self.port = host, int(port)
        self.id = f"{host}:{port}"
        self.queue = SocketStreamQueue(host, port,
                                       connect_timeout=connect_timeout)
        self.alive = True
        self.next_probe = 0.0
        self.failures = 0

    @property
    def address(self) -> str:
        return f"socket://{self.host}:{self.port}"


class ShardedStreamQueue(StreamQueue):
    """The full StreamQueue contract over N broker shards (see module
    docstring for placement/health/failover semantics)."""

    #: wait_any() exists (polls shards with broker-side long-poll
    #: slices), so OutputQueue.wait_all uses it
    supports_long_poll = True

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 name: str = "image_stream",
                 probe_interval_s: float = 1.0,
                 connect_timeout: float = 5.0):
        if not endpoints:
            raise ValueError("ShardedStreamQueue needs >= 1 endpoint")
        self.name = name
        self.probe_interval_s = float(probe_interval_s)
        self._shards = [_Shard(h, p, connect_timeout)
                        for h, p in endpoints]
        self._ids = [s.id for s in self._shards]
        self._lock = threading.Lock()
        self._rr = 0
        # uri -> shard index whose claim a put_results must release
        self._claim_shard: "OrderedDict[str, int]" = OrderedDict()
        # uri -> (record, token): re-drive ammunition for broker death
        self._pending: "OrderedDict[str, Tuple[dict, str]]" = OrderedDict()
        # counters (under _lock)
        self.failovers = 0
        self.reenqueued = 0
        self.probes = 0

    # -- placement ------------------------------------------------------
    def rank(self, key: str) -> List[int]:
        return rendezvous_rank(key, self._ids)

    def shard_for(self, key: str) -> int:
        """HRW winner for ``key`` ignoring health — the placement every
        peer agrees on while the fabric is whole."""
        return self.rank(key)[0]

    # -- health ---------------------------------------------------------
    def _mark_dead(self, i: int):
        s = self._shards[i]
        with self._lock:
            s.alive = False
            s.failures += 1
            s.next_probe = time.time() + self.probe_interval_s
        s.queue.close()

    def _usable(self, i: int, now: float) -> bool:
        s = self._shards[i]
        if s.alive:
            return True
        with self._lock:
            if now < s.next_probe:
                return False
            s.next_probe = now + self.probe_interval_s
            self.probes += 1
        try:
            s.queue.stream_len()
        except (ConnectionError, OSError):
            return False
        with self._lock:
            s.alive = True
        return True

    def _usable_order(self, now: float) -> List[int]:
        """Healthy shard indices, rotated so consecutive polls spread
        across the fabric instead of pinning shard 0."""
        order = [i for i in range(len(self._shards))
                 if self._usable(i, now)]
        if len(order) > 1:
            with self._lock:
                start = self._rr % len(order)
                self._rr += 1
            order = order[start:] + order[:start]
        return order

    def healthy(self) -> int:
        now = time.time()
        return sum(1 for i in range(len(self._shards))
                   if self._usable(i, now))

    # -- pending ledger -------------------------------------------------
    def _note_pending(self, uri: Optional[str], record: dict, token: str):
        if uri is None:
            return
        with self._lock:
            self._pending[uri] = (record, token)
            self._pending.move_to_end(uri)
            while len(self._pending) > PENDING_WINDOW:
                self._pending.popitem(last=False)

    def _forget_pending(self, uris: Iterable[str]):
        with self._lock:
            for uri in uris:
                self._pending.pop(uri, None)

    # -- StreamQueue contract -------------------------------------------
    def enqueue(self, record: dict) -> str:
        uri = record.get("uri") if isinstance(record, dict) else None
        key = uri if uri is not None else uuid.uuid4().hex
        token = uuid.uuid4().hex
        rid = self._enqueue_ranked(key, record, token)
        self._note_pending(uri, record, token)
        return rid

    def _enqueue_ranked(self, key: str, record: dict, token: str) -> str:
        now = time.time()
        last: Optional[Exception] = None
        for attempt, i in enumerate(self.rank(key)):
            if not self._usable(i, now):
                continue
            try:
                rid = self._shards[i].queue.enqueue(record, token=token)
            except (ConnectionError, OSError) as e:
                self._mark_dead(i)
                last = e
                continue
            if attempt:
                with self._lock:
                    self.failovers += 1
            return rid
        raise ConnectionError(
            f"no shard of {len(self._shards)} accepted enqueue: {last}")

    def reenqueue_missing(self, uris: Iterable[str]) -> int:
        """Re-drive records whose results never arrived (a dead broker
        took its stream with it).  Each re-send reuses the original
        dedup token, so a record that actually survived on a live broker
        is not double-inserted there; a record served twice across
        brokers collapses in the per-uri results map.  Returns how many
        were re-sent (uris outside the pending window are skipped)."""
        n = 0
        for uri in uris:
            with self._lock:
                entry = self._pending.get(uri)
            if entry is None:
                continue
            record, token = entry
            self._enqueue_ranked(uri, record, token)
            n += 1
        if n:
            with self._lock:
                self.reenqueued += n
        return n

    def _note_claims(self, i: int, items):
        with self._lock:
            for _rid, rec in items:
                uri = rec.get("uri") if isinstance(rec, dict) else None
                if uri is None:
                    continue
                self._claim_shard[uri] = i
                self._claim_shard.move_to_end(uri)
                while len(self._claim_shard) > CLAIM_WINDOW:
                    self._claim_shard.popitem(last=False)

    def read_batch(self, max_items: int, timeout: float = 1.0
                   ) -> List[Tuple[str, dict]]:
        """Drain healthy shards round-robin (FIFO per shard).  The first
        shard of a sweep may block a bounded slice broker-side; the rest
        are polled non-blocking, so one empty shard never starves a full
        one.  Records arrive already stamped/deduped by the per-shard
        client."""
        deadline = time.time() + float(timeout)
        out: List[Tuple[str, dict]] = []
        while True:
            now = time.time()
            order = self._usable_order(now)
            if not order:
                if now >= deadline:
                    return out
                time.sleep(min(POLL_SLICE_S, deadline - now))
                continue
            for k, i in enumerate(order):
                want = int(max_items) - len(out)
                if want <= 0:
                    break
                remaining = deadline - time.time()
                if k == 0 and not out:
                    per = max(remaining if len(order) == 1
                              else min(remaining, POLL_SLICE_S), 0.0)
                else:
                    per = 0.0
                try:
                    items = self._shards[i].queue.read_batch(
                        want, timeout=per)
                except (ConnectionError, OSError):
                    self._mark_dead(i)
                    continue
                if items:
                    self._note_claims(i, items)
                    out.extend(items)
            if out or time.time() >= deadline:
                return out

    def put_result(self, uri: str, value: bytes):
        self.put_results({uri: value})

    def put_results(self, results: Dict[str, bytes]):
        # group by the shard whose claim each commit releases (falling
        # back to the HRW winner for uris this instance never claimed),
        # so the piggybacked ack lands where the claim lives
        groups: Dict[int, Dict[str, bytes]] = {}
        with self._lock:
            claim = {u: self._claim_shard.pop(u, None) for u in results}
        for uri, value in results.items():
            i = claim.get(uri)
            if i is None:
                i = self.shard_for(uri)
            groups.setdefault(i, {})[uri] = value
        for i, chunk in groups.items():
            self._put_chunk(i, chunk)

    def _put_chunk(self, preferred: int, chunk: Dict[str, bytes]):
        first = next(iter(chunk))
        candidates = [preferred] + [j for j in self.rank(first)
                                    if j != preferred]
        now = time.time()
        last: Optional[Exception] = None
        for j in candidates:
            if not self._usable(j, now):
                continue
            try:
                self._shards[j].queue.put_results(chunk)
                return
            except (ConnectionError, OSError) as e:
                self._mark_dead(j)
                last = e
        raise ConnectionError(
            f"no shard accepted {len(chunk)} result(s): {last}")

    def get_result(self, uri: str, pop: bool = True) -> Optional[bytes]:
        # HRW winner first; failover may have landed the result (or its
        # claim) elsewhere, so walk the full ranking
        now = time.time()
        for i in self.rank(uri):
            if not self._usable(i, now):
                continue
            try:
                v = self._shards[i].queue.get_result(uri, pop=pop)
            except (ConnectionError, OSError):
                self._mark_dead(i)
                continue
            if v is not None:
                if pop:
                    self._forget_pending([uri])
                return v
        return None

    def all_results(self, pop: bool = True) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        now = time.time()
        for i in range(len(self._shards)):
            if not self._usable(i, now):
                continue
            try:
                out.update(self._shards[i].queue.all_results(pop=pop))
            except (ConnectionError, OSError):
                self._mark_dead(i)
        if pop and out:
            self._forget_pending(out.keys())
        return out

    def wait_any(self, uris, timeout: float = 1.0,
                 pop: bool = True) -> Dict[str, bytes]:
        """Result long-poll across shards: each healthy shard is polled
        with a bounded broker-side wait slice until any wanted uri lands
        (a uri's result lives on exactly one shard, so the first hit is
        the answer)."""
        uris = list(uris)
        deadline = time.time() + float(timeout)
        while True:
            now = time.time()
            order = self._usable_order(now)
            if not order:
                if now >= deadline:
                    return {}
                time.sleep(min(POLL_SLICE_S, deadline - now))
                continue
            for i in order:
                remaining = deadline - time.time()
                per = max(remaining if len(order) == 1
                          else min(remaining, POLL_SLICE_S), 0.0)
                try:
                    found = self._shards[i].queue.wait_any(
                        uris, timeout=per, pop=pop)
                except (ConnectionError, OSError):
                    self._mark_dead(i)
                    continue
                if found:
                    if pop:
                        self._forget_pending(found.keys())
                    return found
                if time.time() >= deadline:
                    return {}

    def stream_len(self) -> int:
        """Backlog summed across healthy shards — what the fleet
        autoscaler sizes by behind ``shard://`` (a dead shard
        contributes 0 until its probe resurrects it)."""
        total = 0
        now = time.time()
        for i in range(len(self._shards)):
            if not self._usable(i, now):
                continue
            try:
                total += self._shards[i].queue.stream_len()
            except (ConnectionError, OSError):
                self._mark_dead(i)
        return total

    def trim(self, keep_last: int):
        """Watermark trim, fanned out proportionally to shard depth
        (largest-remainder, so exactly ``keep_last`` survive) — each
        shard keeps its newest, matching per-shard FIFO."""
        keep_last = max(int(keep_last), 0)
        now = time.time()
        live: List[Tuple[int, int]] = []
        for i in range(len(self._shards)):
            if not self._usable(i, now):
                continue
            try:
                live.append((i, self._shards[i].queue.stream_len()))
            except (ConnectionError, OSError):
                self._mark_dead(i)
        total = sum(d for _i, d in live)
        if total <= keep_last:
            return
        quotas = []
        for i, d in live:
            exact = keep_last * d / total
            quotas.append([i, d, int(exact), exact - int(exact)])
        short = keep_last - sum(q[2] for q in quotas)
        for q in sorted(quotas, key=lambda q: q[3], reverse=True)[:short]:
            q[2] += 1
        for i, d, keep, _frac in quotas:
            keep = min(keep, d)
            if keep < d:
                try:
                    self._shards[i].queue.trim(keep)
                except (ConnectionError, OSError):
                    self._mark_dead(i)

    def close(self):
        for s in self._shards:
            s.queue.close()

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        """Per-shard broker stats plus fabric counters — `zoo-serving
        status` renders one row per shard from this."""
        rows = []
        now = time.time()
        for i, s in enumerate(self._shards):
            row = {"address": s.address, "alive": False,
                   "failures": s.failures}
            if self._usable(i, now):
                try:
                    row.update(s.queue.stats())
                    row["alive"] = True
                except (ConnectionError, OSError):
                    self._mark_dead(i)
            rows.append(row)
        with self._lock:
            return {"shards": rows,
                    "healthy": sum(1 for r in rows if r["alive"]),
                    "failovers": self.failovers,
                    "reenqueued": self.reenqueued,
                    "probes": self.probes}

    def consumer_stats(self) -> dict:
        """Delivery-integrity counters summed over the per-shard
        ledgers (same keys as the file/socket transports)."""
        agg = {"duplicates": 0, "seq_gaps": 0, "producers_seen": 0}
        for s in self._shards:
            st = s.queue.consumer_stats()
            for k in agg:
                agg[k] += int(st.get(k, 0))
        agg["shards"] = len(self._shards)
        return agg


class LocalShardFabric:
    """N in-process brokers on one host — `zoo-serving broker --shards
    N`, tests, and bench arms.  ``base_port=0`` binds ephemeral ports."""

    def __init__(self, n: int, host: str = "127.0.0.1", base_port: int = 0,
                 claim_timeout_s: float = 60.0, op_cost_ms: float = 0.0):
        if n < 1:
            raise ValueError("need >= 1 shard")
        self.brokers = [
            StreamQueueBroker(
                host=host,
                port=0 if base_port == 0 else base_port + k,
                claim_timeout_s=claim_timeout_s, op_cost_ms=op_cost_ms)
            for k in range(int(n))]

    @property
    def spec(self) -> str:
        return "shard://" + ",".join(f"{b.host}:{b.port}"
                                     for b in self.brokers)

    @property
    def endpoints(self) -> List[Tuple[str, int]]:
        return [(b.host, b.port) for b in self.brokers]

    def start(self) -> "LocalShardFabric":
        for b in self.brokers:
            b.start()
        return self

    def queue(self, **kw) -> ShardedStreamQueue:
        return ShardedStreamQueue(self.endpoints, **kw)

    def shutdown(self):
        for b in self.brokers:
            b.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def spawn_broker_proc(port: int, host: str = "127.0.0.1",
                      claim_timeout_s: float = 60.0,
                      op_cost_ms: float = 0.0) -> subprocess.Popen:
    """A broker in its OWN process (``python -m ...socket_queue``) so
    chaos legs can SIGKILL it — an in-process broker thread cannot model
    losing the stream.  The child imports the package tree this module
    came from, whatever the caller's cwd."""
    return subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.socket_queue",
         "--host", host, "--port", str(int(port)),
         "--claim-timeout-s", str(float(claim_timeout_s)),
         "--op-cost-ms", str(float(op_cost_ms))],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=inject_pythonpath(dict(os.environ)))


def wait_broker_up(host: str, port: int, timeout: float = 15.0):
    """Block until a broker answers on (host, port); raises on timeout."""
    deadline = time.time() + timeout
    last: Optional[Exception] = None
    while time.time() < deadline:
        q = SocketStreamQueue(host, port, connect_timeout=1.0)
        try:
            q.stream_len()
            return
        except (ConnectionError, OSError) as e:
            last = e
            time.sleep(0.05)
        finally:
            q.close()
    raise ConnectionError(f"broker {host}:{port} not up in {timeout}s: "
                          f"{last}")
