"""Unified telemetry spine: metrics registry, span tracer, flight recorder.

A copy of ``analytics_zoo_tpu/utils/telemetry.py`` (standard library
only); the port's generation scheduler records its counters, summaries,
events and spans here.

The repo runs as a real distributed system — process infeed pools, a
supervised serving fleet, gang-restarted training — and before this
module each subsystem kept its own books (`InfeedMonitor` windows,
`InferenceSummary` reservoirs, `stats.json`, health files).  This is the
one shared layer underneath all of them (docs/observability.md):

- **MetricsRegistry** — labeled counters, gauges, fixed-bucket
  histograms and bounded-reservoir summaries.  Lock per metric, dict
  lookup per fetch; cheap enough to stay live even when tracing is off
  (`InfeedMonitor` and `InferenceSummary` store their numbers here and
  nowhere else).
- **Span tracer** — ``with span("train/step", step=n):`` records
  structured begin/end events.  When telemetry is disabled ``span()``
  returns a shared no-op context manager: the cost is one global check
  plus an attribute-free ``with`` (guarded by the overhead test).
- **Flight recorder** — every event also lands in a bounded ring
  buffer; :func:`dump_flight` writes the last-N spans plus a metrics
  snapshot to ``debug/flight-<pid>-<ts>.json``.  Fault paths (SIGTERM
  drain, ``TrainingPreempted``, ``ZOO_TPU_FAULT`` sites) call it before
  dying, so a chaos run leaves evidence of what each worker was doing.
- **Exporters** — Chrome-trace/Perfetto JSON (open in
  ``chrome://tracing`` or https://ui.perfetto.dev), a periodic atomic
  ``metrics.json`` per process (same tmp+rename discipline as
  ``stats.json``), and Prometheus text format.

Import-light by design: stdlib only (no jax, no numpy) so the process
infeed workers — which must never import jax — can span directly and
ship their events to the parent over the existing result queue
(:func:`drain_events` / :func:`ingest_events`).

Enabled via ``ZooConfig.telemetry`` / ``ZOO_TPU_TELEMETRY=1``; trace
output lands under ``ZOO_TPU_TRACE_DIR`` (``--trace-dir`` on
``zoo-launch`` and ``zoo-serving``).
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Summary",
    "get_registry", "counter", "gauge", "histogram", "summary",
    "span", "event", "flow", "new_trace_id",
    "enabled", "set_enabled", "configure",
    "enable_forwarding", "drain_events", "ingest_events",
    "write_trace", "dump_flight", "flight_events",
    "snapshot_metrics", "render_prometheus",
    "start_metrics_exporter", "stop_metrics_exporter",
    "reset_for_tests",
]

# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

# Prometheus-style default latency buckets, in seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def _prom_labels(self) -> str:
        if not self.labels:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in self.labels) + "}"


class Counter(_Metric):
    """Monotonic labeled counter."""

    kind = "counter"

    def __init__(self, name, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, v: float = 1.0):
        with self._lock:
            self._value += v

    add = inc

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": self.label_dict, "value": self._value}


class Gauge(_Metric):
    """Last-write-wins labeled gauge."""

    kind = "gauge"

    def __init__(self, name, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def add(self, v: float = 1.0):
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": self.label_dict, "value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative counts on render, Prometheus
    style). Bucket upper bounds are in whatever unit you observe in."""

    kind = "histogram"

    def __init__(self, name, labels=(), buckets: Sequence[float] = None):
        super().__init__(name, labels)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float):
        idx = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, []
        for le, c in zip(self.buckets, counts):
            cum += c
            out.append([le, cum])
        return {"name": self.name, "type": self.kind,
                "labels": self.label_dict, "count": total,
                "sum": s, "buckets": out}


class Summary(_Metric):
    """Bounded reservoir of recent observations with percentile queries.

    Keeps the last ``maxlen`` observations in a ring so long-running
    processes report *recent* tail latency, not the all-time
    distribution.  This is the storage behind serving's per-stage
    ``LatencyStats`` (pipeline/inference/inference_summary.py), which
    now subclasses it — per-stage latencies live in the registry and
    nowhere else.
    """

    kind = "summary"

    def __init__(self, name: str = "", labels=(), maxlen: int = 4096):
        super().__init__(name, labels)
        self._buf: deque = deque(maxlen=maxlen)
        self.count = 0          # total observations (not capped)
        self.total = 0.0        # running sum of all observations

    def record(self, v: float):
        with self._lock:
            self._buf.append(float(v))
            self.count += 1
            self.total += float(v)

    observe = record

    def percentile(self, pct: float) -> float:
        """Linear-interpolated percentile (numpy 'linear' method) over
        the current reservoir. 0.0 when empty."""
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return 0.0
        if len(data) == 1:
            return data[0]
        rank = (pct / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def percentiles(self, pcts: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        """{'p50': ..., 'p95': ..., 'p99': ...} in **milliseconds**
        (observations are recorded in seconds)."""
        return {f"p{int(p) if float(p).is_integer() else p}":
                self.percentile(p) * 1e3 for p in pcts}

    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": self.label_dict, "count": self.count,
                "sum": self.total,
                "quantiles": {"p50": self.percentile(50),
                              "p95": self.percentile(95),
                              "p99": self.percentile(99)}}


class MetricsRegistry:
    """Process-wide metric store. Fetching a metric is one dict lookup
    (creation takes the registry lock once); recording takes only the
    metric's own lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw) -> _Metric:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Sequence[float] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def summary(self, name: str, maxlen: int = 4096, **labels) -> Summary:
        return self._get(Summary, name, labels, maxlen=maxlen)

    def register(self, cls, name: str, labels: Dict[str, str] = None,
                 **kw) -> _Metric:
        """Fetch-or-create a metric of a custom subclass (serving's
        ``LatencyStats`` rides :class:`Summary` this way, so per-stage
        latencies live in the registry and nowhere else)."""
        return self._get(cls, name, labels or {}, **kw)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-ready snapshot of every metric — the payload of the
        periodic ``metrics.json`` exporter and the flight dump."""
        return {"ts": time.time(), "pid": os.getpid(),
                "service": _SERVICE,
                "metrics": [m.to_dict() for m in self.metrics()]}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {group[0].kind}")
            for m in group:
                lbl = m._prom_labels()
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{pname}{lbl} {m.value:.10g}")
                elif isinstance(m, Histogram):
                    d = m.to_dict()
                    base = dict(m.labels)
                    for le, cum in d["buckets"]:
                        items = {**base, "le": f"{le:g}"}
                        ls = ",".join(f'{k}="{v}"'
                                      for k, v in items.items())
                        lines.append(f"{pname}_bucket{{{ls}}} {cum}")
                    items = {**base, "le": "+Inf"}
                    ls = ",".join(f'{k}="{v}"' for k, v in items.items())
                    lines.append(f"{pname}_bucket{{{ls}}} {d['count']}")
                    lines.append(f"{pname}_sum{lbl} {d['sum']:.10g}")
                    lines.append(f"{pname}_count{lbl} {d['count']}")
                elif isinstance(m, Summary):
                    d = m.to_dict()
                    base = dict(m.labels)
                    for q, v in (("0.5", d["quantiles"]["p50"]),
                                 ("0.95", d["quantiles"]["p95"]),
                                 ("0.99", d["quantiles"]["p99"])):
                        items = {**base, "quantile": q}
                        ls = ",".join(f'{k}="{v}"'
                                      for k, v in items.items())
                        lines.append(f"{pname}{{{ls}}} {v:.10g}")
                    lines.append(f"{pname}_sum{lbl} {d['sum']:.10g}")
                    lines.append(f"{pname}_count{lbl} {d['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self):
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: Sequence[float] = None,
              **labels) -> Histogram:
    return _REGISTRY.histogram(name, buckets=buckets, **labels)


def summary(name: str, maxlen: int = 4096, **labels) -> Summary:
    return _REGISTRY.summary(name, maxlen=maxlen, **labels)


def snapshot_metrics() -> dict:
    return _REGISTRY.snapshot()


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


# ---------------------------------------------------------------------------
# span tracer + flight recorder
# ---------------------------------------------------------------------------

def _env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


_ENABLED = _env_bool("ZOO_TPU_TELEMETRY")
_TRACE_DIR: Optional[str] = os.environ.get("ZOO_TPU_TRACE_DIR") or None
_SERVICE = os.environ.get("ZOO_TPU_TELEMETRY_SERVICE", "")
_PID = os.getpid()
_RING_SIZE = int(os.environ.get("ZOO_TPU_FLIGHT_RING", "2048"))
_TRACE_CAP = int(os.environ.get("ZOO_TPU_TRACE_CAP", "500000"))

_rec_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_SIZE)      # flight recorder (last N)
_trace: List[tuple] = []                     # full trace (when dir set)
_outbox: deque = deque(maxlen=8192)          # worker->parent forwarding
_forwarding = False
_tid_names: Dict[int, str] = {}
_foreign: List[dict] = []                    # ingested worker timelines
_atexit_armed = False

# Event wire format (tuple keeps the hot path + pickling cheap):
#   (ph, name, ts_us, tid, args_or_None)
# ph: "B" span begin, "E" span end, "i" instant event,
#     "s"/"t"/"f" flow start/step/finish (args carries the flow "id" —
#     cross-process arrows in the merged trace, docs/observability.md).


def _now_us() -> int:
    return int(time.time() * 1e6)


def _record(ev: tuple):
    tid = ev[3]
    with _rec_lock:
        _ring.append(ev)
        if _TRACE_DIR is not None and len(_trace) < _TRACE_CAP:
            _trace.append(ev)
        if _forwarding:
            _outbox.append(ev)
        if tid not in _tid_names:
            _tid_names[tid] = threading.current_thread().name


class _NoopSpan:
    """Shared do-nothing context manager returned when telemetry is
    off — the disabled hot path is one global check + this object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        self.args = args

    def __enter__(self):
        _record(("B", self.name, _now_us(), threading.get_ident(),
                 self.args))
        return self

    def __exit__(self, etype, exc, tb):
        args = {"error": repr(exc)} if exc is not None else None
        _record(("E", self.name, _now_us(), threading.get_ident(), args))
        return False


def span(name: str, **args):
    """``with span("train/step", step=n):`` — record a begin/end pair
    into the flight-recorder ring (and trace buffer when a trace dir is
    configured). Returns a shared no-op when telemetry is disabled."""
    if not _ENABLED:
        return _NOOP
    return _Span(name, args or None)


def event(name: str, **args):
    """Record an instant event (sheds, restarts, lifecycle marks)."""
    if not _ENABLED:
        return
    _record(("i", name, _now_us(), threading.get_ident(), args or None))


def new_trace_id() -> str:
    """A fresh 16-hex trace id (Dapper-style request identity —
    clients stamp it onto wire records, every downstream span carries
    it in its args, docs/observability.md#tracing)."""
    return os.urandom(8).hex()


def flow(name: str, flow_id: str, phase: str = "s", **args):
    """Record a Chrome-trace flow event: ``phase`` is ``"s"`` (start),
    ``"t"`` (step) or ``"f"`` (finish).  Events sharing ``flow_id``
    render as arrows across pids in the merged timeline — emit the
    start inside the producer's span and the finish inside the
    consumer's, and the request becomes one connected tree even when
    the hops cross processes."""
    if not _ENABLED:
        return
    if phase not in ("s", "t", "f"):
        raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
    a = dict(args)
    a["id"] = str(flow_id)
    _record((phase, name, _now_us(), threading.get_ident(), a))


def enabled() -> bool:
    return _ENABLED


def set_enabled(value: bool):
    global _ENABLED
    _ENABLED = bool(value)


# -- worker event forwarding -------------------------------------------------

def enable_forwarding():
    """Infeed workers call this: recorded events are also queued in an
    outbox, drained per task and shipped to the parent over the result
    queue so the parent's trace shows per-worker timelines."""
    global _forwarding
    _forwarding = True


def drain_events() -> List[tuple]:
    """Pop all forwarded events (worker side)."""
    with _rec_lock:
        out = list(_outbox)
        _outbox.clear()
    return out


def ingest_events(events: Sequence[tuple], *, pid, process_name: str = "",
                  thread_name: str = ""):
    """Parent side: attach a batch of foreign (worker) events under
    their own pid row in the exported trace."""
    if not events:
        return
    with _rec_lock:
        _foreign.append({"pid": pid, "process_name": process_name,
                         "thread_name": thread_name,
                         "events": list(events)})


# -- export ------------------------------------------------------------------

def _ev_json(ev: tuple, pid) -> dict:
    ph, name, ts, tid, args = ev
    out = {"name": name, "ph": "i" if ph == "i" else ph,
           "ts": ts, "pid": pid, "tid": tid,
           "cat": name.split("/", 1)[0]}
    if ph == "i":
        out["s"] = "t"
    if ph in ("s", "t", "f"):
        # flow events carry their binding id at the top level; finishes
        # bind to the enclosing slice ("bp":"e") so the arrow lands on
        # the consumer span, not the next slice on the thread
        out["id"] = (args or {}).get("id", "")
        if ph == "f":
            out["bp"] = "e"
    if args:
        out["args"] = args
    return out


def _meta_ev(name: str, pid, tid, value: str) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": value}}


def trace_events_json() -> List[dict]:
    """All collected events (own + ingested) as Chrome-trace dicts."""
    with _rec_lock:
        own = list(_trace) if _TRACE_DIR is not None else list(_ring)
        foreign = list(_foreign)
        tid_names = dict(_tid_names)
    out: List[dict] = []
    out.append(_meta_ev("process_name", _PID, 0,
                        _SERVICE or f"pid-{_PID}"))
    for tid, tname in tid_names.items():
        out.append(_meta_ev("thread_name", _PID, tid, tname))
    for ev in own:
        out.append(_ev_json(ev, _PID))
    for batch in foreign:
        pid = batch["pid"]
        if batch["process_name"]:
            out.append(_meta_ev("process_name", pid, 0,
                                batch["process_name"]))
        seen_tids = {ev[3] for ev in batch["events"]}
        if batch["thread_name"]:
            for tid in seen_tids:
                out.append(_meta_ev("thread_name", pid, tid,
                                    batch["thread_name"]))
        for ev in batch["events"]:
            out.append(_ev_json(ev, pid))
    return out


def _atomic_write_json(path: str, payload: dict):
    """tmp + rename, same discipline as stats.json — but direct (not via
    file_io) so a flight dump triggered by an injected file-io fault
    cannot recurse into the fault checker."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_trace(path: str = None) -> Optional[str]:
    """Write the Chrome-trace JSON. Default path:
    ``<trace_dir>/trace-<pid>.json``. Returns the path (None when there
    is nowhere to write)."""
    if path is None:
        if _TRACE_DIR is None:
            return None
        path = os.path.join(_TRACE_DIR, f"trace-{_PID}.json")
    payload = {"traceEvents": trace_events_json(),
               "displayTimeUnit": "ms",
               "otherData": {"service": _SERVICE, "pid": _PID}}
    _atomic_write_json(path, payload)
    return path


def flight_events() -> List[dict]:
    """The flight-recorder ring as Chrome-trace dicts (last N events)."""
    with _rec_lock:
        ring = list(_ring)
    return [_ev_json(ev, _PID) for ev in ring]


def dump_flight(reason: str, out_dir: str = None) -> Optional[str]:
    """Dump the last-N spans + a metrics snapshot to
    ``<dir>/debug/flight-<pid>-<ts>.json``. Called on every fault path
    (SIGTERM drain, TrainingPreempted, unhandled step exceptions, every
    ``ZOO_TPU_FAULT`` site) *before* the process dies. Never raises."""
    if not _ENABLED:
        return None
    try:
        base = out_dir or _TRACE_DIR or "."
        ts = int(time.time() * 1e3)
        path = os.path.join(base, "debug", f"flight-{_PID}-{ts}.json")
        payload = {
            "reason": reason,
            "pid": _PID,
            "service": _SERVICE,
            "ts": time.time(),
            "spans": flight_events(),
            "metrics": _REGISTRY.snapshot(),
        }
        _atomic_write_json(path, payload)
        return path
    except Exception:  # noqa: BLE001 - a dump must never mask the fault
        return None


# -- periodic metrics.json exporter ------------------------------------------

class _MetricsExporter(threading.Thread):
    def __init__(self, path: str, interval_s: float):
        super().__init__(daemon=True, name="telemetry-metrics")
        self.path = path
        self.interval_s = interval_s
        self.stop_event = threading.Event()

    def run(self):
        while not self.stop_event.wait(self.interval_s):
            self.flush()
        self.flush()

    def flush(self):
        try:
            _atomic_write_json(self.path, _REGISTRY.snapshot())
        except OSError:
            pass


_exporter: Optional[_MetricsExporter] = None


def start_metrics_exporter(path: str = None,
                           interval_s: float = None) -> Optional[str]:
    """Start (or retarget) the periodic atomic ``metrics.json`` writer.
    Default path ``<trace_dir>/metrics-<pid>.json``."""
    global _exporter
    if path is None:
        if _TRACE_DIR is None:
            return None
        path = os.path.join(_TRACE_DIR, f"metrics-{_PID}.json")
    if interval_s is None:
        interval_s = float(
            os.environ.get("ZOO_TPU_METRICS_INTERVAL_S", "2.0"))
    if _exporter is not None and _exporter.is_alive():
        _exporter.path = path
        _exporter.interval_s = interval_s
        return path
    _exporter = _MetricsExporter(path, interval_s)
    _exporter.start()
    return path


def stop_metrics_exporter(flush: bool = True):
    global _exporter
    ex = _exporter
    _exporter = None
    if ex is not None:
        ex.stop_event.set()
        if flush:
            ex.flush()


# -- configuration -----------------------------------------------------------

def _at_exit():
    try:
        stop_metrics_exporter()
        write_trace()
    except Exception:  # noqa: BLE001 - never fail interpreter shutdown
        pass


def configure(enabled: bool = None, trace_dir: str = None,
              service: str = None, export_metrics: bool = True):
    """Process entry points (init_nncontext, zoo-serving, zoo-launch
    workers) call this once. ``trace_dir`` arms full-trace collection,
    the periodic metrics exporter, and an atexit trace flush; child
    processes inherit the settings via ``ZOO_TPU_TELEMETRY`` /
    ``ZOO_TPU_TRACE_DIR`` / ``ZOO_TPU_TELEMETRY_SERVICE``."""
    global _ENABLED, _TRACE_DIR, _SERVICE, _atexit_armed
    if enabled is not None:
        _ENABLED = bool(enabled)
    if service is not None:
        _SERVICE = service
    if trace_dir is not None:
        _TRACE_DIR = os.path.abspath(trace_dir)
        os.environ["ZOO_TPU_TRACE_DIR"] = _TRACE_DIR
    if _ENABLED:
        os.environ["ZOO_TPU_TELEMETRY"] = "1"
        if _SERVICE:
            os.environ["ZOO_TPU_TELEMETRY_SERVICE"] = _SERVICE
    if _ENABLED and _TRACE_DIR is not None:
        os.makedirs(_TRACE_DIR, exist_ok=True)
        if export_metrics:
            start_metrics_exporter()
        if not _atexit_armed:
            atexit.register(_at_exit)
            _atexit_armed = True


def reset_for_tests():
    """Full reset: registry, ring, trace buffer, forwarding, enable
    flag (re-read from the environment). Test isolation only."""
    global _ENABLED, _TRACE_DIR, _SERVICE, _forwarding
    stop_metrics_exporter(flush=False)
    with _rec_lock:
        _ring.clear()
        _trace.clear()
        _outbox.clear()
        _foreign.clear()
        _tid_names.clear()
    _REGISTRY.clear()
    _forwarding = False
    _ENABLED = _env_bool("ZOO_TPU_TELEMETRY")
    _TRACE_DIR = os.environ.get("ZOO_TPU_TRACE_DIR") or None
    _SERVICE = os.environ.get("ZOO_TPU_TELEMETRY_SERVICE", "")
