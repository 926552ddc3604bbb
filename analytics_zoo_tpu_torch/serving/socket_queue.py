"""SocketStreamQueue: the network transport for Cluster Serving.

Counterpart of ``analytics_zoo_tpu/serving/socket_queue.py``, copied,
with msgpack's format from the port's own codec (``wire.py``): a frame
is byte for byte the JAX package's, so a client of either package talks
to a broker of the other.

The reference's front door is a Redis stream (``image_stream`` XADD /
XREAD, ClusterServing.scala:105-116).  This module is the stdlib
equivalent: a small TCP broker (:class:`StreamQueueBroker`, built on
``socketserver``) speaking length-prefixed msgpack frames, and a client
(:class:`SocketStreamQueue`) implementing the full
:class:`~analytics_zoo_tpu_torch.serving.queue_backend.StreamQueue`
contract — so N fleet workers on N hosts share one stream without
per-record file I/O.

Wire protocol
-------------
Every frame is ``4-byte big-endian length + msgpack map``; every
request map carries ``op`` and gets exactly one response map
(``{"ok": True, ...}`` or ``{"ok": False, "error": ...}``) on the same
connection.  Connections are persistent; clients keep one per thread so
a blocking long-poll never serializes behind another op.

Delivery contract (claim ledger instead of atomic rename)
---------------------------------------------------------
``read_batch`` is a **single-assignment claim**: the broker moves the
delivered records from the stream into a per-consumer claim table, so
two fleet workers can never double-serve a record.  A claim is released
by an ``ack`` — which :meth:`SocketStreamQueue.put_results` piggybacks
on the result commit, so the happy path costs no extra round trip.
Unacked claims are **redelivered** (requeued at the stream head, FIFO
preserved) when:

- the consumer's read connection drops (worker SIGKILL / host loss) —
  detected immediately at EOF, or
- a claim outlives ``claim_timeout_s`` (worker wedged while its
  connection lingers) — swept lazily on the next ``read_batch``.

Redelivery after a *successful-but-unacked* commit is harmless: the
results map is idempotent per uri, and each consumer's delivery ledger
(queue_backend.DeliveryLedger) drops duplicate rids client-side.

Result long-poll
----------------
``wait_results`` blocks server-side until any wanted uri has a result
(or the timeout lapses), so clients stop spin-polling ``all_results``
— :meth:`OutputQueue.wait_all` uses it when the transport advertises
``supports_long_poll``.

Timing decomposition survives the hop: the client stamps
``dequeue_ts_ms`` + the ``queue/deliver`` trace event at delivery
(StreamQueue._stamp_dequeue), in the worker process where the trace
spans live.

Run a standalone broker with::

    python -m analytics_zoo_tpu_torch.serving.socket_queue --port 6380
"""

from __future__ import annotations

import argparse
import itertools
import logging
import socket
import socketserver
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from . import wire
from .queue_backend import DeliveryLedger, StreamQueue

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.socket_queue")

#: frame size guard — a length prefix beyond this is a protocol error,
#: not an allocation request (a stray HTTP client must not OOM the broker)
MAX_FRAME = 64 * 1024 * 1024

#: producer-token dedup window (enqueue retried over a new connection
#: after a send error must not double-insert)
TOKEN_WINDOW = 65536


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> dict:
    n = int.from_bytes(_recv_exact(sock, 4), "big")
    if n > MAX_FRAME:
        raise ConnectionError(f"frame of {n} bytes exceeds MAX_FRAME")
    return wire.unpackb(_recv_exact(sock, n))


def write_frame(sock: socket.socket, obj: dict):
    payload = wire.packb(obj)
    sock.sendall(len(payload).to_bytes(4, "big") + payload)


class _Handler(socketserver.BaseRequestHandler):
    """One thread per connection; strictly request→response."""

    def setup(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.broker: "StreamQueueBroker" = self.server.broker
        self.conn_id = id(self)
        with self.broker._cv:
            self.broker._connections += 1

    def handle(self):
        while True:
            try:
                req = read_frame(self.request)
            except (ConnectionError, OSError):
                return
            try:
                resp = self.broker.dispatch(req, self.conn_id)
                resp.setdefault("ok", True)
            except Exception as e:  # noqa: BLE001 - report, keep serving
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                write_frame(self.request, resp)
            except (ConnectionError, OSError):
                return

    def finish(self):
        # EOF on a consumer's read connection == worker death: requeue
        # its unacked claims so another worker serves them
        self.broker.release_connection(self.conn_id)
        with self.broker._cv:
            self.broker._connections -= 1


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class StreamQueueBroker:
    """In-process TCP broker holding the stream, claims, and results.

    ``port=0`` binds an ephemeral port (see :attr:`port` /
    :attr:`address` after construction).  :meth:`start` serves on a
    daemon thread; :meth:`run_forever` serves in the foreground.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "image_stream", claim_timeout_s: float = 60.0,
                 op_cost_ms: float = 0.0):
        self.name = name
        self.claim_timeout_s = float(claim_timeout_s)
        # stubbed serialized-core cost: sleep this long INSIDE the stream
        # lock on each data-plane op, so scale-out benches on a 1-core
        # host can model N brokers on N cores (sleeping releases the GIL,
        # so two brokers' ops overlap the way two cores would, while one
        # broker's ops stay serialized on its lock).  0 = off.
        self.op_cost_ms = float(op_cost_ms)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)          # stream
        self._results_cv = threading.Condition(self._lock)  # results
        self._stream: "OrderedDict[str, dict]" = OrderedDict()
        # consumer -> rid -> (record, claim_ts); OrderedDict so a
        # requeue preserves the consumer's delivery order
        self._claims: Dict[str, "OrderedDict[str, Tuple[dict, float]]"] = {}
        self._consumer_conn: Dict[str, int] = {}
        self._results: Dict[str, bytes] = {}
        self._tokens: "OrderedDict[str, str]" = OrderedDict()
        self._seq = itertools.count()
        self._broker_id = uuid.uuid4().hex[:8]
        # counters (all under _lock)
        self._connections = 0
        self.enqueued = 0
        self.delivered = 0
        self.redelivered = 0
        self.acked = 0
        self.trimmed = 0
        self._server = _TCPServer((host, int(port)), _Handler)
        self._server.broker = self
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._shutdown_once = threading.Lock()
        self._shut_down = False

    @property
    def address(self) -> str:
        return f"socket://{self.host}:{self.port}"

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "StreamQueueBroker":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True, name="queue-broker")
        self._thread.start()
        logger.info("stream broker serving on %s", self.address)
        return self

    def run_forever(self):  # pragma: no cover - foreground CLI path
        logger.info("stream broker serving on %s", self.address)
        self._server.serve_forever(poll_interval=0.1)

    def shutdown(self):
        # Idempotent and thread-safe: the CLI's SIGTERM handler shuts
        # down from a helper thread while the foreground finally-block
        # does the same (server.shutdown() must never run on the thread
        # inside serve_forever, or it deadlocks waiting for the ack).
        with self._shutdown_once:
            if self._shut_down:
                return
            self._shut_down = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- claim bookkeeping (caller holds _lock) -------------------------
    def _requeue_locked(self, consumer: str, why: str):
        claims = self._claims.pop(consumer, None)
        if not claims:
            return
        # claimed rids predate everything still queued (they were popped
        # from the head), so re-inserting them at the front — newest of
        # the batch first — restores global FIFO order exactly
        for rid, (rec, _ts) in reversed(list(claims.items())):
            self._stream[rid] = rec
            self._stream.move_to_end(rid, last=False)
        self.redelivered += len(claims)
        logger.info("requeued %d unacked claim(s) of consumer %s (%s)",
                    len(claims), consumer, why)
        self._cv.notify_all()

    def _sweep_expired_locked(self, now: float):
        for consumer, claims in list(self._claims.items()):
            expired = [rid for rid, (_r, ts) in claims.items()
                       if now - ts > self.claim_timeout_s]
            if not expired:
                continue
            for rid in reversed(expired):
                rec, _ts = claims.pop(rid)
                self._stream[rid] = rec
                self._stream.move_to_end(rid, last=False)
            self.redelivered += len(expired)
            logger.info("requeued %d claim(s) of consumer %s past "
                        "claim_timeout", len(expired), consumer)
            if not claims:
                del self._claims[consumer]
            self._cv.notify_all()

    def release_connection(self, conn_id: int):
        """Connection closed: redeliver unacked claims of every consumer
        whose *lease* (most recent read_batch) rode this connection."""
        with self._lock:
            for consumer, cid in list(self._consumer_conn.items()):
                if cid != conn_id:
                    continue
                del self._consumer_conn[consumer]
                self._requeue_locked(consumer, "connection closed")

    # -- ops ------------------------------------------------------------
    def dispatch(self, req: dict, conn_id: int) -> dict:
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        return fn(req, conn_id)

    def _op_enqueue(self, req, conn_id):
        records = req.get("records") or []
        toks = req.get("toks") or [None] * len(records)
        rids = []
        with self._cv:
            if self.op_cost_ms:
                time.sleep(self.op_cost_ms / 1e3)
            for rec, tok in zip(records, toks):
                if tok is not None and tok in self._tokens:
                    rids.append(self._tokens[tok])   # retried send: dedup
                    continue
                rid = (f"{time.time_ns():020d}-{self._broker_id}"
                       f"-{next(self._seq):08d}")
                self._stream[rid] = rec
                self.enqueued += 1
                rids.append(rid)
                if tok is not None:
                    self._tokens[tok] = rid
                    while len(self._tokens) > TOKEN_WINDOW:
                        self._tokens.popitem(last=False)
            self._cv.notify_all()
        return {"rids": rids}

    def _op_read_batch(self, req, conn_id):
        consumer = req["consumer"]
        max_items = int(req.get("max", 1))
        deadline = time.time() + float(req.get("timeout_ms", 1000)) / 1e3
        with self._cv:
            if self.op_cost_ms:
                time.sleep(self.op_cost_ms / 1e3)
            # this connection is now the consumer's lease: its death
            # triggers redelivery of whatever this read hands out
            self._consumer_conn[consumer] = conn_id
            self._sweep_expired_locked(time.time())
            while not self._stream:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {"items": []}
                self._cv.wait(timeout=min(remaining, 0.5))
            now = time.time()
            claims = self._claims.setdefault(consumer, OrderedDict())
            items = []
            while self._stream and len(items) < max_items:
                rid, rec = self._stream.popitem(last=False)
                claims[rid] = (rec, now)
                items.append([rid, rec])
            self.delivered += len(items)
            return {"items": items}

    def _op_ack(self, req, conn_id):
        consumer = req["consumer"]
        n = 0
        with self._lock:
            claims = self._claims.get(consumer)
            if claims:
                for rid in req.get("rids") or []:
                    if claims.pop(rid, None) is not None:
                        n += 1
                if not claims:
                    self._claims.pop(consumer, None)
            self.acked += n
        return {"acked": n}

    def _op_put_results(self, req, conn_id):
        results = req.get("results") or {}
        with self._results_cv:
            self._results.update(results)
            self._results_cv.notify_all()
        # piggybacked claim release — the happy path needs no extra ack
        if req.get("consumer") and req.get("rids"):
            self._op_ack(req, conn_id)
        return {"n": len(results)}

    def _op_get_result(self, req, conn_id):
        uri = req["uri"]
        with self._lock:
            v = (self._results.pop(uri, None) if req.get("pop", True)
                 else self._results.get(uri))
        return {"value": v}

    def _op_all_results(self, req, conn_id):
        with self._lock:
            out = dict(self._results)
            if req.get("pop", True):
                self._results.clear()
        return {"results": out}

    def _op_wait_results(self, req, conn_id):
        """Result long-poll: block until any wanted uri has a result."""
        want = set(req.get("uris") or [])
        pop = req.get("pop", True)
        deadline = time.time() + float(req.get("timeout_ms", 1000)) / 1e3
        with self._results_cv:
            while True:
                found = want & self._results.keys()
                if found:
                    out = {}
                    for uri in found:
                        out[uri] = (self._results.pop(uri) if pop
                                    else self._results[uri])
                    return {"results": out}
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {"results": {}}
                self._results_cv.wait(timeout=min(remaining, 0.5))

    def _op_stream_len(self, req, conn_id):
        with self._lock:
            return {"n": len(self._stream)}

    def _op_trim(self, req, conn_id):
        keep = int(req.get("keep_last", 0))
        n = 0
        with self._lock:
            while len(self._stream) > keep:
                self._stream.popitem(last=False)
                n += 1
            self.trimmed += n
        return {"trimmed": n}

    def _op_stats(self, req, conn_id):
        with self._lock:
            return {"stats": self._stats_locked()}

    def _stats_locked(self) -> dict:
        return {
            "address": self.address,
            "connections": self._connections,
            "consumers": len(self._consumer_conn),
            "stream_len": len(self._stream),
            "claims_outstanding": sum(len(c)
                                      for c in self._claims.values()),
            "results_pending": len(self._results),
            "enqueued": self.enqueued,
            "delivered": self.delivered,
            "redelivered": self.redelivered,
            "acked": self.acked,
            "trimmed": self.trimmed,
        }

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()


def parse_socket_spec(spec: str) -> Tuple[str, int]:
    """``socket://host:port`` -> (host, port)."""
    rest = spec[len("socket://"):] if spec.startswith("socket://") else spec
    host, _, port = rest.rpartition(":")
    if not host or not port:
        raise ValueError(f"bad socket spec {spec!r} "
                         "(want socket://host:port)")
    return host, int(port)


class SocketStreamQueue(StreamQueue):
    """Client side of the broker protocol — a drop-in StreamQueue.

    One TCP connection per calling thread (``threading.local``), so the
    serving loop's intake thread can sit in a ``read_batch`` long-poll
    while the writer thread commits results concurrently.  A send/recv
    error closes the connection and retries once on a fresh one —
    enqueues carry a dedup token so the retry can't double-insert, and
    the broker requeues any claims the dead connection held.
    """

    #: OutputQueue.wait_all switches from exponential-backoff polling to
    #: wait_any() when the transport sets this
    supports_long_poll = True

    def __init__(self, host: str, port: int, name: str = "image_stream",
                 connect_timeout: float = 10.0):
        self.host, self.port = host, int(port)
        self.name = name
        self.connect_timeout = float(connect_timeout)
        self.consumer = uuid.uuid4().hex[:12]
        self._local = threading.local()
        self._lock = threading.Lock()
        self._socks: List[socket.socket] = []
        # uri -> rids claimed by this consumer and not yet committed;
        # put_results() turns the matching entries into piggybacked acks
        self._unacked: Dict[str, List[str]] = {}
        self._ledger = DeliveryLedger()

    # -- connection management ------------------------------------------
    def _conn(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
            with self._lock:
                self._socks.append(sock)
        return sock

    def _drop_conn(self):
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            self._local.sock = None
            with self._lock:
                if sock in self._socks:
                    self._socks.remove(sock)
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        with self._lock:
            socks, self._socks = self._socks[:], []
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass

    def _request(self, req: dict, timeout_s: float = 30.0) -> dict:
        for attempt in (0, 1):
            sock = self._conn()
            try:
                sock.settimeout(timeout_s)
                write_frame(sock, req)
                resp = read_frame(sock)
                break
            except (ConnectionError, OSError) as e:
                self._drop_conn()
                if attempt:
                    raise ConnectionError(
                        f"broker at {self.host}:{self.port} unreachable: "
                        f"{e}") from e
        if not resp.get("ok"):
            raise RuntimeError(f"broker error: {resp.get('error')}")
        return resp

    # -- StreamQueue contract -------------------------------------------
    def enqueue(self, record: dict, token: Optional[str] = None) -> str:
        # a caller-supplied token lets a fabric retry the SAME logical
        # send against this broker without double-inserting (shard
        # failover reuses one token across attempts)
        return self._request({"op": "enqueue", "records": [record],
                              "toks": [token or uuid.uuid4().hex]}
                             )["rids"][0]

    def read_batch(self, max_items: int, timeout: float = 1.0
                   ) -> List[Tuple[str, dict]]:
        resp = self._request(
            {"op": "read_batch", "consumer": self.consumer,
             "max": int(max_items), "timeout_ms": float(timeout) * 1e3},
            timeout_s=float(timeout) + 30.0)
        out: List[Tuple[str, dict]] = []
        for rid, rec in resp.get("items") or []:
            if not self._ledger.note(rid):
                # duplicate redelivery (claim-timeout raced an in-flight
                # batch): ack so the broker stops re-offering it
                self._request({"op": "ack", "consumer": self.consumer,
                               "rids": [rid]})
                continue
            uri = rec.get("uri") if isinstance(rec, dict) else None
            if uri is not None:
                with self._lock:
                    self._unacked.setdefault(uri, []).append(rid)
            out.append((rid, rec))
        return self._stamp_dequeue(out)

    def _take_acks(self, uris) -> List[str]:
        rids: List[str] = []
        with self._lock:
            for uri in uris:
                rids.extend(self._unacked.pop(uri, ()))
        return rids

    def put_result(self, uri: str, value: bytes):
        self.put_results({uri: value})

    def put_results(self, results: Dict[str, bytes]):
        req = {"op": "put_results",
               "results": {u: bytes(v) for u, v in results.items()}}
        rids = self._take_acks(results.keys())
        if rids:
            req["consumer"] = self.consumer
            req["rids"] = rids
        self._request(req)

    def get_result(self, uri: str, pop: bool = True) -> Optional[bytes]:
        return self._request({"op": "get_result", "uri": uri,
                              "pop": pop})["value"]

    def all_results(self, pop: bool = True) -> Dict[str, bytes]:
        return self._request({"op": "all_results",
                              "pop": pop})["results"]

    def wait_any(self, uris, timeout: float = 1.0,
                 pop: bool = True) -> Dict[str, bytes]:
        """Long-poll: block until ANY of ``uris`` has a result (returns
        the found subset, possibly empty on timeout)."""
        return self._request(
            {"op": "wait_results", "uris": list(uris),
             "timeout_ms": float(timeout) * 1e3, "pop": pop},
            timeout_s=float(timeout) + 30.0)["results"]

    def stream_len(self) -> int:
        return self._request({"op": "stream_len"})["n"]

    def trim(self, keep_last: int):
        self._request({"op": "trim", "keep_last": int(keep_last)})

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        """Broker-side transport stats (zoo-serving status renders these:
        connections, claims outstanding, redeliveries)."""
        return self._request({"op": "stats"})["stats"]

    def consumer_stats(self) -> dict:
        """Delivery-integrity counters for THIS consumer (same shape as
        FileStreamQueue.consumer_stats)."""
        return self._ledger.stats()


def main(argv=None) -> int:  # pragma: no cover - CLI entry
    ap = argparse.ArgumentParser(
        prog="zoo-stream-broker",
        description="Standalone stream broker for socket:// serving")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6380)
    ap.add_argument("--claim-timeout-s", type=float, default=60.0)
    ap.add_argument("--op-cost-ms", type=float, default=0.0,
                    help="stubbed serialized-core cost per data-plane op "
                         "(scale-out benches on few-core hosts)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s broker %(message)s")
    broker = StreamQueueBroker(host=args.host, port=args.port,
                               claim_timeout_s=args.claim_timeout_s,
                               op_cost_ms=args.op_cost_ms)
    try:
        broker.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        broker.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
