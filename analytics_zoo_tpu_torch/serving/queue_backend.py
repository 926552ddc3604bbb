"""Stream-queue transports for Cluster Serving.

Counterpart of ``analytics_zoo_tpu/serving/queue_backend.py``, copied,
with msgpack's wire format from the port's own codec (``wire.py``): the
file transport's records are byte for byte the JAX package's, so either
package's loop serves the other's records.

The reference's transport is a Redis stream (``image_stream`` XADD/XREAD,
ClusterServing.scala:105-116) plus a results hash.  The rebuild keeps that
wire model behind a small interface so the serving loop and clients are
transport-agnostic:

- :class:`InProcessStreamQueue` — threading-based, for tests and
  single-process serving;
- :class:`FileStreamQueue` — directory-backed, multi-process on one host
  (each record one msgpack file, atomic rename), no external service;
- :class:`RedisStreamQueue` — the reference transport, used when the
  ``redis`` client package is importable and a server address is given.

The network transports (``socket://``, ``shard://``) are not ported yet
(ROADMAP A14): :func:`get_queue_backend` raises for them.

All implement XADD-like ``enqueue``, XREAD-like ``read_batch``, a
results hash (``put_result``/``get_result``), and the memory-watermark trim
(ClusterServing.scala:130-136).

Latency decomposition: ``read_batch`` stamps every delivered record with
``dequeue_ts_ms`` (epoch ms) so the serving loop can split wire/transport
time (``dequeue_ts_ms - enqueue_ts_ms``, the client stamps the latter)
from device time.

Delivery contract: :class:`FileStreamQueue` claims records by atomic
rename, so N consumer processes reading one stream directory never
double-serve a record; each consumer additionally tracks delivered
record ids (duplicate redelivery is detected and skipped) and
per-producer sequence gaps — see :meth:`FileStreamQueue.consumer_stats`.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..utils import telemetry
from . import wire


class StreamQueue:
    """Interface: a named input stream + a results map."""

    def enqueue(self, record: dict) -> str:
        raise NotImplementedError

    def read_batch(self, max_items: int, timeout: float = 1.0
                   ) -> List[Tuple[str, dict]]:
        raise NotImplementedError

    def put_result(self, uri: str, value: bytes):
        raise NotImplementedError

    def put_results(self, results: Dict[str, bytes]):
        """Commit a batch of results (the serving writer stage drains a
        whole batch at once); transports may override to amortize their
        per-result cost."""
        for uri, value in results.items():
            self.put_result(uri, value)

    def get_result(self, uri: str, pop: bool = True) -> Optional[bytes]:
        raise NotImplementedError

    def all_results(self, pop: bool = True) -> Dict[str, bytes]:
        raise NotImplementedError

    def stream_len(self) -> int:
        raise NotImplementedError

    def trim(self, keep_last: int):
        """Watermark trim (xtrim parity)."""
        raise NotImplementedError

    @staticmethod
    def _stamp_dequeue(items: List[Tuple[str, dict]]
                       ) -> List[Tuple[str, dict]]:
        """Stamp delivery time (epoch ms) on every record so the server
        can report transport vs device latency per row; with telemetry
        on, each delivery is an instant event tagged with the record's
        trace id — the queue hop in the merged request tree."""
        ts = time.time() * 1e3
        traced = telemetry.enabled()
        for _rid, rec in items:
            if isinstance(rec, dict):
                rec.setdefault("dequeue_ts_ms", ts)
                if traced:
                    tid = rec.get("trace_id") or rec.get(b"trace_id")
                    if tid:
                        if isinstance(tid, (bytes, bytearray)):
                            tid = tid.decode()
                        telemetry.event("queue/deliver", trace_id=tid,
                                        uri=rec.get("uri"))
        return items


class DeliveryLedger:
    """Bounded consumer-side delivery ledger (shared by the file and
    socket transports): duplicate-redelivery detection over a sliding
    rid window plus per-producer sequence-gap accounting.

    Both memories are **bounded**: delivered rids beyond ``window`` are
    evicted oldest-first (duplicate counters stay exact within the
    window — older redeliveries are indistinguishable from fresh rids,
    the documented trade), and the per-producer last-seen-seq map is an
    LRU capped at ``producer_cap`` so a long-lived consumer fed by an
    endless churn of short-lived producers (every client restart mints a
    new producer id) cannot leak."""

    def __init__(self, window: int = 65536, producer_cap: int = 4096):
        self.window = int(window)
        self.producer_cap = int(producer_cap)
        self._delivered: set = set()
        self._ring: deque = deque()
        self._producer_seq: "OrderedDict[str, int]" = OrderedDict()
        self.duplicates = 0
        self.seq_gaps = 0

    def note(self, rid: str) -> bool:
        """Record one delivery; False when ``rid`` was already served
        within the window (duplicate redelivery — skip it)."""
        if rid in self._delivered:
            self.duplicates += 1
            return False
        self._delivered.add(rid)
        self._ring.append(rid)
        while len(self._ring) > self.window:
            self._delivered.discard(self._ring.popleft())
        # per-producer sequence continuity (advisory: a gap means a
        # record this consumer never saw — lost, trimmed, or claimed by
        # another fleet worker; per-worker gaps are expected in a fleet,
        # a gap with ONE consumer means loss)
        parts = rid.rsplit("-", 2)
        if len(parts) == 3:
            try:
                seq = int(parts[2])
            except ValueError:
                return True
            producer = parts[1]
            last = self._producer_seq.get(producer)
            if last is not None and seq > last + 1:
                self.seq_gaps += seq - last - 1
            if last is None or seq > last:
                self._producer_seq[producer] = seq
            self._producer_seq.move_to_end(producer)
            while len(self._producer_seq) > self.producer_cap:
                self._producer_seq.popitem(last=False)
        return True

    def stats(self) -> dict:
        return {"duplicates": self.duplicates,
                "seq_gaps": self.seq_gaps,
                "producers_seen": len(self._producer_seq)}


class InProcessStreamQueue(StreamQueue):
    def __init__(self, name: str = "image_stream"):
        self.name = name
        self._stream: "OrderedDict[str, dict]" = OrderedDict()
        self._results: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def enqueue(self, record: dict) -> str:
        rid = uuid.uuid4().hex
        with self._cv:
            self._stream[rid] = record
            self._cv.notify_all()
        return rid

    def read_batch(self, max_items, timeout=1.0):
        deadline = time.time() + timeout
        with self._cv:
            while not self._stream and time.time() < deadline:
                self._cv.wait(timeout=max(deadline - time.time(), 0.01))
            out = []
            while self._stream and len(out) < max_items:
                rid, rec = self._stream.popitem(last=False)
                out.append((rid, rec))
            return self._stamp_dequeue(out)

    def put_result(self, uri, value):
        with self._cv:
            self._results[uri] = value

    def put_results(self, results):
        with self._cv:   # one lock acquisition per served batch
            self._results.update(results)

    def get_result(self, uri, pop=True):
        with self._cv:
            return self._results.pop(uri, None) if pop else \
                self._results.get(uri)

    def all_results(self, pop=True):
        with self._cv:
            out = dict(self._results)
            if pop:
                self._results.clear()
            return out

    def stream_len(self):
        with self._cv:
            return len(self._stream)

    def trim(self, keep_last):
        with self._cv:
            while len(self._stream) > keep_last:
                self._stream.popitem(last=False)


class FileStreamQueue(StreamQueue):
    """Directory-backed stream: producers write ``<ts>-<id>.msgpack`` into
    ``<root>/stream`` atomically; the consumer claims files by rename.
    Results land in ``<root>/results/<safe-uri>``.  Good enough for
    multi-process single-host serving without Redis."""

    #: delivered-rid memory per consumer (duplicate detection window)
    DELIVERED_WINDOW = 65536
    #: LRU cap on the per-producer last-seen-seq map (DeliveryLedger)
    PRODUCER_CAP = 4096

    def __init__(self, root: str, name: str = "image_stream",
                 orphan_tmp_age: float = 60.0,
                 delivered_window: Optional[int] = None,
                 producer_cap: Optional[int] = None):
        self.root = root
        self.stream_dir = os.path.join(root, name)
        self.results_dir = os.path.join(root, "results")
        os.makedirs(self.stream_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        # per-producer monotonic sequence: timestamp collisions (same
        # time_ns on fast enqueues, coarse clocks) still sort FIFO
        self._seq = itertools.count()
        # producer identity baked into every rid so a consumer can track
        # per-producer sequence continuity under concurrent writers
        self._producer = uuid.uuid4().hex[:8]
        self.orphan_tmp_age = orphan_tmp_age
        self._last_gc = 0.0
        # consumer-side delivery ledger: bounded rid window + LRU-capped
        # per-producer seq map + the counters consumer_stats() reports
        self._ledger = DeliveryLedger(
            window=(self.DELIVERED_WINDOW if delivered_window is None
                    else int(delivered_window)),
            producer_cap=(self.PRODUCER_CAP if producer_cap is None
                          else int(producer_cap)))

    def enqueue(self, record):
        rid = (f"{time.time_ns():020d}-{self._producer}"
               f"-{next(self._seq):08d}")
        payload = wire.packb(record)
        fd, tmp = tempfile.mkstemp(dir=self.stream_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.rename(tmp, os.path.join(self.stream_dir, rid + ".msgpack"))
        return rid

    def _gc_orphans(self):
        """Recover droppings of crashed processes: aged ``.tmp`` files
        (enqueuer/writer died mid-write, never renamed) are deleted;
        aged ``.claimed`` files (consumer died between claim and unlink)
        are renamed back into the stream — re-serving is harmless since
        the results map is idempotent per uri."""
        now = time.time()
        if now - self._last_gc < self.orphan_tmp_age / 2:
            return
        self._last_gc = now
        for d in (self.stream_dir, self.results_dir):
            for n in os.listdir(d):
                path = os.path.join(d, n)
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    continue
                if age < self.orphan_tmp_age:
                    continue
                try:
                    if n.endswith(".tmp"):
                        os.unlink(path)
                    elif n.endswith(".msgpack.claimed"):
                        os.rename(path, path[:-len(".claimed")])
                except OSError:
                    pass

    def _note_delivery(self, rid: str) -> bool:
        """Record one delivery; False when ``rid`` was already served by
        this consumer (duplicate redelivery — e.g. an operator restoring
        ``.claimed`` orphans a second time) and must be skipped."""
        return self._ledger.note(rid)

    def consumer_stats(self) -> dict:
        """Delivery-integrity counters for THIS consumer instance."""
        return self._ledger.stats()

    def read_batch(self, max_items, timeout=1.0):
        self._gc_orphans()
        deadline = time.time() + timeout
        while True:
            names = sorted(n for n in os.listdir(self.stream_dir)
                           if n.endswith(".msgpack"))[:max_items]
            out = []
            for n in names:
                path = os.path.join(self.stream_dir, n)
                claimed = path + ".claimed"
                try:
                    os.rename(path, claimed)  # atomic claim
                except OSError:
                    continue    # another fleet worker won the claim
                with open(claimed, "rb") as f:
                    rec = wire.unpackb(f.read())
                os.unlink(claimed)
                rid = n[:-len(".msgpack")]
                if not self._note_delivery(rid):
                    continue    # duplicate redelivery: drop, don't serve
                out.append((rid, rec))
            if out or time.time() >= deadline:
                return self._stamp_dequeue(out)
            time.sleep(0.02)

    @staticmethod
    def _safe(uri: str) -> str:
        # ASCII [A-Za-z0-9._-] exactly as documented
        # (docs/inference-serving.md): non-ASCII alphanumerics must NOT
        # survive, or second-language clients (bytewise mapping) poll a
        # different result filename than the server writes
        return "".join(c if (c.isascii() and c.isalnum()) or c in "._-"
                       else "_" for c in uri)

    def put_result(self, uri, value):
        fd, tmp = tempfile.mkstemp(dir=self.results_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(value)
        os.rename(tmp, os.path.join(self.results_dir, self._safe(uri)))

    def get_result(self, uri, pop=True):
        path = os.path.join(self.results_dir, self._safe(uri))
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        if pop:
            os.unlink(path)
        return data

    def all_results(self, pop=True):
        out = {}
        for n in os.listdir(self.results_dir):
            if n.endswith(".tmp"):
                continue
            data = self.get_result(n, pop=pop)
            if data is not None:
                out[n] = data
        return out

    def stream_len(self):
        return sum(1 for n in os.listdir(self.stream_dir)
                   if n.endswith(".msgpack"))

    def trim(self, keep_last):
        names = sorted(n for n in os.listdir(self.stream_dir)
                       if n.endswith(".msgpack"))
        for n in names[:-keep_last] if keep_last else names:
            try:
                os.unlink(os.path.join(self.stream_dir, n))
            except OSError:
                pass


class RedisStreamQueue(StreamQueue):  # pragma: no cover - needs a server
    """The reference transport (Redis stream + hash), used when redis-py
    and a server are available."""

    def __init__(self, host="localhost", port=6379, name="image_stream"):
        import redis

        self.r = redis.Redis(host=host, port=port)
        self.name = name
        self._last_id = "0"

    def enqueue(self, record):
        return self.r.xadd(self.name, {
            k: v if isinstance(v, (bytes, str, int, float)) else
            wire.packb(v)
            for k, v in record.items()}).decode()

    def read_batch(self, max_items, timeout=1.0):
        resp = self.r.xread({self.name: self._last_id}, count=max_items,
                            block=int(timeout * 1000))
        out = []
        for _stream, entries in resp or []:
            for rid, fields in entries:
                self._last_id = rid
                rec = {k.decode(): v for k, v in fields.items()}
                out.append((rid.decode(), rec))
        return self._stamp_dequeue(out)

    def put_result(self, uri, value):
        self.r.hset("result:" + uri, "value", value)

    def put_results(self, results):
        pipe = self.r.pipeline()
        for uri, value in results.items():
            pipe.hset("result:" + uri, "value", value)
        pipe.execute()

    def get_result(self, uri, pop=True):
        v = self.r.hget("result:" + uri, "value")
        if pop and v is not None:
            self.r.delete("result:" + uri)
        return v

    def all_results(self, pop=True):
        # one pipelined round trip for the reads (and one for the
        # deletes) instead of 2N — the result-poll path is the client
        # hot loop, N round trips per poll is what wait_all pays
        keys = self.r.keys("result:*")
        if not keys:
            return {}
        pipe = self.r.pipeline()
        for key in keys:
            pipe.hget(key, "value")
        values = pipe.execute()
        out = {}
        hit = []
        for key, v in zip(keys, values):
            if v is None:
                continue
            out[key.decode()[len("result:"):]] = v
            hit.append(key)
        if pop and hit:
            self.r.delete(*hit)
        return out

    def stream_len(self):
        return self.r.xlen(self.name)

    def trim(self, keep_last):
        self.r.xtrim(self.name, maxlen=keep_last)


def get_queue_backend(spec: Optional[str] = None) -> StreamQueue:
    """``None``/'inproc' -> InProcessStreamQueue (also registered as the
    process-wide default so clients and server share it); 'file:<dir>' ->
    FileStreamQueue; 'host:port' -> RedisStreamQueue. 'socket://...' and
    'shard://...' (the network broker and its sharded fabric) are not
    ported yet and raise."""
    global _DEFAULT_INPROC
    if spec is None or spec == "inproc":
        if _DEFAULT_INPROC is None:
            _DEFAULT_INPROC = InProcessStreamQueue()
        return _DEFAULT_INPROC
    if spec.startswith("file:"):
        return FileStreamQueue(spec[len("file:"):])
    if spec.startswith(("socket://", "shard://")):
        raise NotImplementedError(
            f"transport {spec!r}: the socket broker and the shard fabric "
            f"are not ported yet (ROADMAP A14); use 'inproc' or 'file:'")
    host, _, port = spec.partition(":")
    return RedisStreamQueue(host, int(port or 6379))


_DEFAULT_INPROC: Optional[InProcessStreamQueue] = None
