"""Serving clients: InputQueue / OutputQueue.

Counterpart of ``analytics_zoo_tpu/serving/client.py``, copied; the
routed-generate placement (``route_workdir``) waits for the port of the
fleet router (ROADMAP A14) and raises.

Parity: ``pyzoo/zoo/serving/client.py`` — ``InputQueue.enqueue_image``
(:83, base64-encoded jpg into the stream), ``OutputQueue.dequeue``/``query``
(:131,142).  The transport is pluggable (§queue_backend) instead of
hard-coded Redis.

Latency decomposition + deadlines (docs/serving-fleet.md): every enqueue
stamps ``enqueue_ts_ms`` (epoch ms) and may carry ``deadline_ms``; the
server threads its dequeue/compute timestamps into the result payload,
so a decoded result is a :class:`ServingResult` whose ``timing`` dict
splits ``transport_ms`` (wire + result-poll time) from ``device_ms``
(accelerator time) per row.  Requests the server cannot finish inside
their deadline come back as typed :class:`ServingRejected` values
instead of silent timeouts, and :meth:`OutputQueue.wait_all` raises
:class:`ServingTimeout` rather than backing off past a client deadline.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Dict, Iterable, Optional

import numpy as np

from ..utils import telemetry
from .queue_backend import StreamQueue, get_queue_backend


class ServingError(Exception):
    """A dead-lettered record: the server committed an error payload for
    this uri instead of a prediction (unknown model, failed decode,
    failed batch — docs/model-registry.md#dead-letters)."""

    def __init__(self, uri: Optional[str], message: str,
                 model: Optional[str] = None,
                 version: Optional[int] = None):
        super().__init__(f"{uri}: {message}" if uri else message)
        self.uri = uri
        self.message = message
        self.model = model
        self.version = version


class ServingRejected(ServingError):
    """Typed load-shed rejection: admission control determined the
    record could not meet its ``deadline_ms`` (``code`` is
    ``shed_deadline`` at intake, ``shed_expired`` when the deadline
    passed while queued — docs/serving-fleet.md#admission).  For a
    generate request shed *mid-stream* (deadline passed while decoding)
    ``tokens`` carries the partial token array the budget allowed —
    docs/serving-generate.md#deadlines."""

    def __init__(self, uri: Optional[str], message: str,
                 code: str = "shed_deadline",
                 model: Optional[str] = None,
                 version: Optional[int] = None,
                 tokens=None):
        super().__init__(uri, message, model, version)
        self.code = code
        self.tokens = (np.asarray(tokens, np.int64)
                       if tokens is not None else None)


class ServingTimeout(ServingError):
    """Client-side deadline expiry in :meth:`OutputQueue.wait_all`:
    results for ``missing`` uris had not landed when the deadline
    passed.  ``partial`` holds everything that did arrive."""

    def __init__(self, missing, partial: Optional[dict] = None,
                 deadline_ms: Optional[float] = None):
        self.missing = sorted(missing)
        self.partial = partial or {}
        self.deadline_ms = deadline_ms
        super().__init__(
            None,
            f"{len(self.missing)} of "
            f"{len(self.missing) + len(self.partial)} results missing "
            f"after deadline"
            + (f" of {deadline_ms:.0f}ms" if deadline_ms else "")
            + f": {self.missing[:5]}"
            + ("..." if len(self.missing) > 5 else ""))


class ServingResult(np.ndarray):
    """A prediction plus its latency decomposition: behaves exactly like
    the float32 ndarray it always was, with a ``timing`` dict attached
    (``device_ms``, ``transport_ms``, ``queue_ms``, ``rtt_ms``, raw
    timestamps) when the server reported one."""

    timing: Optional[dict]

    def __array_finalize__(self, obj):
        self.timing = getattr(obj, "timing", None)

    @classmethod
    def wrap(cls, value, timing: Optional[dict]) -> "ServingResult":
        out = np.asarray(value, np.float32).view(cls)
        out.timing = timing
        return out


class GenerationResult(np.ndarray):
    """A generated token stream: the int64 token array, plus ``finish``
    (why the sequence ended: ``stop_id`` / ``max_new_tokens``) and the
    per-sequence ``timing`` dict (``ttft_ms``, ``decode_ms``,
    ``tokens_per_s``, ``rtt_ms`` — docs/serving-generate.md)."""

    timing: Optional[dict]
    finish: Optional[str]

    def __array_finalize__(self, obj):
        self.timing = getattr(obj, "timing", None)
        self.finish = getattr(obj, "finish", None)

    @classmethod
    def wrap(cls, tokens, finish: Optional[str],
             timing: Optional[dict]) -> "GenerationResult":
        out = np.asarray(tokens, np.int64).view(cls)
        out.finish = finish
        out.timing = timing
        return out


class API:
    """Shared client base (client.py:25)."""

    def __init__(self, backend: Optional[StreamQueue] = None,
                 address: Optional[str] = None):
        self.db = backend if backend is not None else \
            get_queue_backend(address)


class InputQueue(API):
    #: trace id stamped on the most recent enqueue (the handle for
    #: `zoo-serving trace <id>` / `zoo-trace show <id>`)
    last_trace_id: Optional[str] = None

    def __init__(self, backend: Optional[StreamQueue] = None,
                 address: Optional[str] = None,
                 route_workdir: Optional[str] = None):
        """``route_workdir`` opts generate enqueues into length- and
        cache-aware fleet placement in the JAX package
        (``serving/routing.py``); the port has no fleet router yet
        (ROADMAP A14), so it raises."""
        if route_workdir is not None:
            raise NotImplementedError(
                "routed generate placement (route_workdir) needs the fleet "
                "router, which is not ported yet (ROADMAP A14)")
        super().__init__(backend=backend, address=address)

    @property
    def routing_stats(self) -> Optional[dict]:
        return None

    def _route_fields(self, rec: dict, model: Optional[str],
                      version: Optional[int],
                      deadline_ms: Optional[float] = None,
                      trace_id: Optional[str] = None) -> dict:
        # optional on the wire: absent fields route to the server's
        # default model, so pre-registry clients keep working unchanged
        if model is not None:
            rec["model"] = model
        if version is not None:
            rec["version"] = int(version)
        if deadline_ms is not None:
            rec["deadline_ms"] = float(deadline_ms)
        rec["enqueue_ts_ms"] = time.time() * 1e3
        # Dapper-style trace context: every wire record carries a
        # client-stamped trace id + the client's span name as parent;
        # each downstream hop (queue delivery, admission, pipeline
        # stages, device dispatch, write) tags its spans with the same
        # id, so one request merges into one causal tree across
        # processes (docs/observability.md#tracing)
        rec["trace_id"] = trace_id or telemetry.new_trace_id()
        rec["parent_span"] = "client/enqueue"
        self.last_trace_id = rec["trace_id"]
        return rec

    def _traced_enqueue(self, rec: dict) -> str:
        """Enqueue inside a client span tagged with the record's trace
        id, opening the flow arrow the server's intake span closes."""
        with telemetry.span("client/enqueue", trace_id=rec["trace_id"],
                            uri=rec.get("uri")):
            telemetry.flow("serving/request", rec["trace_id"], "s")
            return self.db.enqueue(rec)

    def enqueue_image(self, uri: str, img, model: Optional[str] = None,
                      version: Optional[int] = None,
                      deadline_ms: Optional[float] = None) -> str:
        """Put one image on the stream; ``img`` is an ndarray (HWC BGR
        uint8) or pre-encoded jpg/png bytes (client.py:83-122).
        ``model``/``version`` target a registry-served model;
        ``deadline_ms`` opts into deadline-aware admission control."""
        if isinstance(img, np.ndarray):
            import cv2

            ok, buf = cv2.imencode(".jpg", img.astype(np.uint8))
            if not ok:
                raise ValueError("jpg encode failed")
            data = buf.tobytes()
        else:
            data = bytes(img)
        rec = {"uri": uri, "image": self.base64_encode_image(data)}
        return self._traced_enqueue(
            self._route_fields(rec, model, version, deadline_ms))

    def enqueue(self, uri: str, model: Optional[str] = None,
                version: Optional[int] = None,
                deadline_ms: Optional[float] = None, **tensors) -> str:
        """General tensor input: each kwarg becomes a (shape, data) entry."""
        rec = {"uri": uri, "tensors": {
            k: {"shape": list(np.asarray(v).shape),
                "data": np.asarray(v, np.float32).tobytes()}
            for k, v in tensors.items()}}
        return self._traced_enqueue(
            self._route_fields(rec, model, version, deadline_ms))

    def enqueue_generate(self, uri: str, prompt,
                         max_new_tokens: Optional[int] = None,
                         stop_id: Optional[int] = None,
                         temperature: Optional[float] = None,
                         model: Optional[str] = None,
                         version: Optional[int] = None,
                         deadline_ms: Optional[float] = None) -> str:
        """Submit a generate request: ``prompt`` is a 1-D sequence of
        int token ids; the result (an int64 :class:`GenerationResult`
        of newly generated tokens) lands under ``uri`` the moment the
        sequence finishes — sequences in the same continuous batch
        complete independently (docs/serving-generate.md).  Omitted
        sampling fields fall back to the server's configured defaults."""
        gen: dict = {"prompt": [int(t) for t in np.asarray(prompt).ravel()]}
        if max_new_tokens is not None:
            gen["max_new_tokens"] = int(max_new_tokens)
        if stop_id is not None:
            gen["stop_id"] = int(stop_id)
        if temperature is not None:
            gen["temperature"] = float(temperature)
        rec = {"uri": uri, "generate": gen}
        return self._traced_enqueue(
            self._route_fields(rec, model, version, deadline_ms))

    @staticmethod
    def base64_encode_image(data: bytes) -> str:
        return base64.b64encode(data).decode("utf-8")


class OutputQueue(API):
    def dequeue(self):
        """Fetch-and-clear all results: {uri: ndarray} (client.py:131)."""
        return {uri: self._decode(v, uri)
                for uri, v in self.db.all_results(pop=True).items()}

    def query(self, uri: str):
        """Result for one uri or None (client.py:142)."""
        v = self.db.get_result(uri, pop=False)
        return self._decode(v, uri) if v is not None else None

    def wait_all(self, uris: Iterable[str], timeout: float = 30.0,
                 poll: float = 0.01, max_poll: float = 0.5,
                 raise_on_error: bool = False,
                 deadline_ms: Optional[float] = None
                 ) -> Dict[str, np.ndarray]:
        """Poll until every uri has a result (popping as they land) or
        the deadline passes; returns whatever arrived.  The interval
        backs off exponentially from ``poll`` to ``max_poll`` while
        nothing lands and snaps back to ``poll`` on progress — but never
        sleeps past the deadline, so the budget is honored, not merely
        approximated.

        ``deadline_ms`` is the typed-deadline form: it bounds the wait
        (overriding ``timeout``) and raises :class:`ServingTimeout`
        listing the missing uris when it expires, instead of silently
        returning a partial dict.

        Dead-lettered uris come back as :class:`ServingError` values and
        load-shed uris as :class:`ServingRejected` (structured errors
        instead of a silent timeout); with ``raise_on_error`` the first
        one raises.

        On a transport advertising ``supports_long_poll`` (the socket
        broker) the wait is server-side — ``wait_any`` blocks until a
        wanted result lands, popping only *those* uris, so there is no
        spin-polling and no stealing of other clients' results; every
        other transport keeps the exponential-backoff poll above."""
        want = set(uris)
        got: Dict[str, np.ndarray] = {}
        budget_s = deadline_ms / 1e3 if deadline_ms is not None else timeout
        deadline = time.time() + budget_s
        interval = poll
        long_poll = bool(getattr(self.db, "supports_long_poll", False))
        while want and time.time() < deadline:
            progressed = False
            if long_poll:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                landed = self.db.wait_any(sorted(want),
                                          timeout=min(remaining, 5.0),
                                          pop=True)
            else:
                landed = self.db.all_results(pop=True)
            for uri, v in landed.items():
                got[uri] = self._decode(v, uri)
                want.discard(uri)
                progressed = True
            if raise_on_error:
                for v in got.values():
                    if isinstance(v, ServingError):
                        raise v
            if want and not long_poll:
                if progressed:
                    interval = poll
                else:
                    interval = min(interval * 2, max_poll)
                # honor the deadline: never back off past it
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                time.sleep(min(interval, remaining))
        if want and deadline_ms is not None:
            raise ServingTimeout(want, partial=got, deadline_ms=deadline_ms)
        return got

    @staticmethod
    def _decode(value: bytes, uri: Optional[str] = None):
        obj = json.loads(value.decode("utf-8"))
        if isinstance(obj, dict) and "error" in obj:
            code = obj.get("code")
            if code in ("shed_deadline", "shed_expired",
                        "shed_capacity", "cancelled"):
                return ServingRejected(uri, obj["error"], code,
                                       obj.get("model"),
                                       obj.get("version"),
                                       tokens=obj.get("tokens"))
            return ServingError(uri, obj["error"], obj.get("model"),
                                obj.get("version"))
        timing = obj.get("timing")
        if timing:
            # complete the round trip client-side: total wall from the
            # enqueue stamp, minus time inside the server = wire +
            # result-poll transport
            recv_ms = time.time() * 1e3
            enq = timing.get("enqueue_ts_ms")
            if enq is not None:
                timing["rtt_ms"] = round(recv_ms - enq, 3)
                server_ms = timing.get("server_ms")
                if server_ms is not None:
                    timing["transport_ms"] = round(
                        max(timing["rtt_ms"] - server_ms, 0.0), 3)
            if timing.get("trace_id"):
                telemetry.event("client/result", uri=uri,
                                trace_id=timing["trace_id"],
                                rtt_ms=timing.get("rtt_ms"))
        if "tokens" in obj and "value" not in obj:
            return GenerationResult.wrap(obj["tokens"],
                                         obj.get("finish"), timing)
        return ServingResult.wrap(obj["value"], timing)
