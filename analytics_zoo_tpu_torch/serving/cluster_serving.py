"""ClusterServing: the streaming inference service loop.

Counterpart of ``analytics_zoo_tpu/serving/cluster_serving.py``. The
loop, its stages, admission, SLOs and the generate path are the JAX
package's; what differs is where the device is met:

- the dispatch starts each batch's copy to the host as a
  :class:`~analytics_zoo_tpu_torch.pipeline.inference.inference_model.
  HostCopy` (pinned memory and a CUDA event on the card), and the writer
  waits on that copy alone, so a batch's ``device_ms`` runs from its
  dispatch to its own outputs on the host, as ``np.asarray`` of a JAX
  array does;
- the generate engine is the port's ``TransformerDecodeEngine``, whose
  layer holds its weights (``build_transformer_engine`` takes
  ``params=None``, or a JAX tree it copies in);
- a ``generate`` field that arrives packed (Redis) is read by the port's
  msgpack codec (``wire.py``).

Parity: ``zoo/.../serving/ClusterServing.scala:44-392`` — read a micro-batch
from the input stream (:105-116), base64-decode images, predict with a
shared InferenceModel, write results to the results map, apply the memory
watermark trim (:130-136); config comes from ``config.yaml``
(``ClusterServingHelper.initArgs``, serving/utils/ClusterServingHelper.scala
:104) and throughput/latency land in the InferenceSummary (:96-97).

Spark Structured Streaming becomes a host-driven pipeline feeding the
model on one device.  The hot path is three overlapped stages connected
by bounded queues (backpressure propagates to the stream read):

1. **decode** — a pool of ``decode_workers`` threads pulls records off
   the :class:`StreamQueue` and produces ready tensors concurrently with
   compute (base64 and image decode is host work the accelerator should
   never wait on);
2. **compute** — a single thread assembles ready tensors into
   power-of-two **padding buckets** (a small fixed set of batch shapes,
   each run once by :meth:`ClusterServing.warmup` so the kernels and
   cuDNN's algorithms are loaded before traffic), so a half-full batch
   no longer pays full-batch device time, and dispatches
   **asynchronously** — batch *k+1* is submitted before batch *k*'s host
   transfer completes;
3. **write** — a thread drains predictions (waiting on each batch's
   :class:`HostCopy` is its synchronization point) and commits results
   to the queue backend.

The original single-thread loop survives as ``pipelined=False`` (config
``params.pipelined``) and is the baseline the pipelined loop is
measured against.  Per-stage latency
percentiles, queue depths, and bucket usage are recorded in
:class:`InferenceSummary` so the overlap is observable.

Deadline-aware admission + latency decomposition (docs/serving-fleet.md):
records carrying ``deadline_ms`` pass through an
:class:`~analytics_zoo_tpu_torch.serving.admission.AdmissionController` at
intake (unmeetable → typed ``shed_deadline`` rejection) and again at
dispatch (``shed_expired``); the compute stage may *linger* a bounded
moment (``params.linger_ms``) to round partial batches up to the next
padding bucket.  Each record's ``enqueue_ts_ms`` (client) and
``dequeue_ts_ms`` (backend) stamps travel in a :class:`RecordMeta`
through the stages, and the writer emits a per-row ``timing`` payload
splitting ``transport_in_ms`` / ``queue_ms`` / ``device_ms`` /
``server_ms`` — so a fat tail is attributable to the wire or the
accelerator, not guessed at.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue
import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..feature.image import codec
from ..feature.image.resize import resize as resize_image
from ..pipeline.inference import InferenceModel
from ..pipeline.inference.inference_model import AbstractModel, HostCopy
from ..pipeline.inference.inference_summary import InferenceSummary
from ..utils import telemetry, yaml_subset
from ..utils.slo import SloEngine, parse_slo_class_config, parse_slo_config
from ..utils.telemetry import span
from .admission import (AdaptiveBatcher, AdmissionController, SHED_CAPACITY,
                        SHED_DEADLINE, SHED_EXPIRED, TenantScheduler, now_ms)
from .queue_backend import StreamQueue, get_queue_backend

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: shutdown marker passed through the stage queues
_SENTINEL = object()


class RecordMeta(NamedTuple):
    """Per-record identity + timestamps threaded through the pipeline
    stages (all ``*_ms`` are epoch milliseconds; ``t_in`` is the server's
    perf_counter at intake, for the e2e stage percentile)."""

    t_in: float
    uri: str
    enqueue_ts_ms: Optional[float]   # stamped by the client
    dequeue_ts_ms: Optional[float]   # stamped by the queue backend
    deadline_at_ms: Optional[float]  # absolute deadline; None = no deadline
    trace_id: Optional[str] = None   # client-stamped request trace context
    tenant: Optional[str] = None     # SLO class name (multi-tenancy)


class _RequestLog:
    """Append-only jsonl of committed request timings keyed by trace id
    — the data source `zoo-serving trace <id>` renders its waterfall
    from.  Size-rotated (one ``.1`` generation) so a long-running worker
    cannot fill the disk; writes never raise into the serve path."""

    def __init__(self, path: str, max_bytes: int = 16 << 20):
        self.path = os.path.abspath(path)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._f = None
        self._written = 0

    def append(self, obj: dict):
        try:
            line = json.dumps(obj) + "\n"
            with self._lock:
                if self._f is None:
                    os.makedirs(os.path.dirname(self.path), exist_ok=True)
                    self._f = open(self.path, "a")
                    self._written = self._f.tell()
                self._f.write(line)
                self._f.flush()
                self._written += len(line)
                if self._written > self.max_bytes:
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                    self._f = open(self.path, "a")
                    self._written = 0
        except OSError:
            pass

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class EchoStubModel(AbstractModel):
    """Deterministic stand-in for a real model: sleeps a fixed
    ``ms_per_batch`` (a perfectly flat "device" time) and echoes each
    row's mean.  Lets fleet workers, smoke tests, and bench legs exercise
    the full wire path in subprocesses without a saved model — enabled
    via config ``model.stub_ms_per_batch``."""

    def __init__(self, ms_per_batch: float = 5.0):
        self.ms_per_batch = float(ms_per_batch)

    def predict(self, batch):
        batch = np.asarray(batch, np.float32)
        if self.ms_per_batch > 0:
            time.sleep(self.ms_per_batch / 1e3)
        return batch.reshape(batch.shape[0], -1).mean(axis=1, keepdims=True)

    def predict_async(self, batch):
        return self.predict(batch)


def power_of_two_buckets(batch_size: int) -> List[int]:
    """Padding buckets 1, 2, 4, ... capped by (and always including)
    ``batch_size`` — each bucket is one batch shape."""
    batch_size = max(int(batch_size), 1)
    buckets, b = [], 1
    while b < batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(batch_size)
    return sorted(set(buckets))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (``buckets`` sorted ascending); the largest
    bucket when n exceeds them all (callers chunk at batch_size)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _parse_bool(value, default: bool) -> bool:
    if value is None:
        return default
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return bool(value)


class ClusterServingHelper:
    """Parses the serving yaml (ClusterServingHelper.initArgs parity)."""

    def __init__(self, config_path: Optional[str] = None,
                 config: Optional[dict] = None):
        if config is None:
            # the port's reader of the config's YAML subset (PyYAML's
            # safe_load results, without PyYAML)
            with open(config_path) as f:
                config = yaml_subset.safe_load(f) or {}
        model = config.get("model") or {}
        data = config.get("data") or {}
        params = config.get("params") or {}
        self.model_path = model.get("path")
        # deterministic echo stub (EchoStubModel) instead of a saved
        # model — fleet smoke / bench workers (docs/serving-fleet.md)
        raw_stub = model.get("stub_ms_per_batch")
        self.stub_ms_per_batch = None if raw_stub is None else float(raw_stub)
        # transport spec; ZOO_SERVING_TRANSPORT (the CLI's --transport
        # flag) overrides the config so one yaml serves every wire —
        # fleet workers inherit the override through their environment
        self.src = os.environ.get("ZOO_SERVING_TRANSPORT") or \
            data.get("src")
        shape = data.get("image_shape") or "3, 224, 224"
        if isinstance(shape, str):
            shape = [int(s) for s in shape.split(",")]
        self.image_shape = tuple(shape)
        self.batch_size = int(params.get("batch_size") or 4)
        # explicit 0 means raw output (no top-n formatting), so the
        # falsy-default idiom would silently re-enable it
        raw_top = params.get("top_n")
        self.top_n = 1 if raw_top is None else int(raw_top)
        # watermark: trim stream when it exceeds maxlen (60%*80% parity)
        self.stream_maxlen = int(params.get("stream_maxlen") or 10000)
        # -- pipeline knobs (docs/serving-pipeline.md) ------------------
        self.pipelined = _parse_bool(params.get("pipelined"), True)
        self.decode_workers = int(params.get("decode_workers") or 2)
        self.queue_depth = int(params.get("queue_depth") or
                               max(2 * self.batch_size, 16))
        raw = params.get("bucket_sizes")
        if isinstance(raw, str):
            raw = [int(s) for s in raw.split(",") if s.strip()]
        self.bucket_sizes = sorted({int(b) for b in raw}) if raw else None
        self.warmup = _parse_bool(params.get("warmup"), False)
        # periodic pipeline_stats() JSON dump for `zoo-serving status`
        # (the CLI start path defaults this to <workdir>/stats.json)
        self.stats_path = params.get("stats_path")
        # -- admission / adaptive batching (docs/serving-fleet.md) ------
        self.linger_ms = float(params.get("linger_ms") or 0.0)
        raw_dl = params.get("default_deadline_ms")
        self.default_deadline_ms = None if raw_dl is None else float(raw_dl)
        self.admission_safety_ms = float(
            params.get("admission_safety_ms") or 2.0)
        # -- fleet (serving/fleet.py) -----------------------------------
        self.workers = int(params.get("workers") or 1)
        self.health_interval = float(params.get("health_interval") or 1.0)
        self.health_timeout = float(params.get("health_timeout") or 10.0)
        # fleet crash-loop protection (docs/fault-tolerance.md): cap on
        # consecutive restarts per worker, and the initial backoff the
        # supervise loop doubles per restart
        self.max_restarts = int(params.get("max_restarts") or 10)
        self.restart_backoff_s = float(
            params.get("restart_backoff_s") or 0.5)
        # backlog-driven autoscaling (serving/admission.BacklogAutoscaler,
        # docs/serving-network.md#autoscaling): enabled when the
        # min..max band is wider than a point; the band defaults to the
        # fixed worker count, i.e. autoscaling off
        self.min_workers = int(params.get("min_workers") or self.workers)
        self.max_workers = int(params.get("max_workers") or self.workers)
        self.autoscale_target_ms = float(
            params.get("autoscale_target_ms") or
            (self.default_deadline_ms or 250.0))
        self.autoscale_interval = float(
            params.get("autoscale_interval") or 0.5)
        self.scale_up_fraction = float(
            params.get("scale_up_fraction") or 0.5)
        self.scale_down_idle_s = float(
            params.get("scale_down_idle_s") or 3.0)
        self.autoscale_cooldown_s = float(
            params.get("autoscale_cooldown_s") or 2.0)
        # -- telemetry (docs/observability.md): span tracing + per-process
        # metrics.json; the CLI --trace-dir flag overrides trace_dir
        self.telemetry = _parse_bool(params.get("telemetry"), False)
        self.trace_dir = params.get("trace_dir")
        # committed request timings (jsonl) for `zoo-serving trace <id>`;
        # the CLI/fleet default this under the workdir when telemetry is on
        self.request_log = params.get("request_log")
        # -- SLO objectives (utils/slo.py, docs/observability.md#slo) ----
        self.slo_config = config.get("slo") or {}
        self.slo_objectives = parse_slo_config(self.slo_config)
        # named SLO classes bound to (model, version) with weights and
        # shed priorities (docs/multi-tenancy.md)
        self.slo_classes = parse_slo_class_config(self.slo_config)
        # -- generative serving (docs/serving-generate.md) --------------
        gen = config.get("generate") or {}
        self.generate_slots = int(gen.get("slots") or 4)
        self.generate_continuous = _parse_bool(gen.get("continuous"), True)
        self.generate_max_len = int(gen.get("max_len") or 1024)
        self.generate_max_new_tokens = int(gen.get("max_new_tokens") or 32)
        raw_gstop = gen.get("stop_id")
        self.generate_stop_id = None if raw_gstop is None else int(raw_gstop)
        # deterministic stub decode engine (StubDecodeEngine) — fleet
        # smoke / bench workers, mirrors model.stub_ms_per_batch
        raw_gstub = gen.get("stub_ms_per_step")
        self.generate_stub_ms_per_step = \
            None if raw_gstub is None else float(raw_gstub)
        # -- generative fast path (docs/serving-generate.md#fast-path) --
        # chunked prefill width in tokens; 0 disables interleaving
        self.generate_prefill_chunk = int(gen.get("prefill_chunk") or 0)
        # KV slab dtype: "f32" (default) or "int8" (Int8KVSlab storage)
        self.generate_kv_dtype = str(gen.get("kv_cache") or "f32").lower()
        # shared-prefix cache budget in MiB; 0 disables the cache
        self.generate_prefix_cache_mb = float(
            gen.get("prefix_cache_mb") or 0)
        # speculative decoding: {"k": 3, "draft_ms_per_step": 0.1}; the
        # stub path builds a draft stub, the device path needs a draft
        # engine injected via set_generate_engine
        spec = gen.get("speculative") or {}
        self.generate_speculative_k = int(spec.get("k") or 0)
        raw_draft = spec.get("draft_ms_per_step")
        self.generate_draft_ms_per_step = \
            None if raw_draft is None else float(raw_draft)
        # -- model registry (docs/model-registry.md) --------------------
        reg = config.get("registry") or {}
        self.registry_root = reg.get("root")
        self.default_model = reg.get("default_model") or "default"
        self.canary_error_threshold = float(
            reg.get("canary_error_threshold") or 0.5)
        self.canary_min_requests = int(reg.get("canary_min_requests") or 20)
        self.drain_timeout = float(reg.get("drain_timeout") or 10.0)

    def load_inference_model(self, concurrent_num: int = 1) -> InferenceModel:
        model = InferenceModel(supported_concurrent_num=concurrent_num)
        model.load(self.model_path)
        return model


class ClusterServing:
    """The serving loop.  ``serve_forever`` blocks; ``start``/``stop`` run
    it on a daemon thread (tests, notebooks)."""

    def __init__(self, model: Optional[InferenceModel] = None,
                 helper: Optional[ClusterServingHelper] = None,
                 backend: Optional[StreamQueue] = None,
                 config_path: Optional[str] = None,
                 summary: Optional[InferenceSummary] = None,
                 preprocessing=None):
        self.helper = helper or ClusterServingHelper(config_path=config_path)
        self.model = model if model is not None else self._default_model()
        self.db = backend if backend is not None else \
            get_queue_backend(self.helper.src)
        # always keep a summary: log_dir=None is stats-only (percentiles
        # + queue depths without event files)
        self.summary = summary if summary is not None else InferenceSummary()
        self.preprocessing = preprocessing
        h = self.helper
        self.pipelined = bool(getattr(h, "pipelined", True))
        self.decode_workers = max(1, int(getattr(h, "decode_workers", 2)))
        self.queue_depth = max(2, int(getattr(h, "queue_depth", 0) or
                                      max(2 * h.batch_size, 16)))
        self.buckets = list(getattr(h, "bucket_sizes", None) or
                            power_of_two_buckets(h.batch_size))
        if self.buckets[-1] < h.batch_size:
            self.buckets.append(int(h.batch_size))
        # pipeline counters (guarded by _ctr_lock; read via pipeline_stats)
        self._ctr_lock = threading.Lock()
        self.records_in = 0
        self.results_out = 0
        self.dropped = 0
        self.dead_letters = 0
        self.shed = 0
        self.batches = 0
        # routed-placement intake accounting (serving/routing.py):
        # routed_in counts records stamped `routed_to` us; affinity_hits
        # counts those whose prompt was warm in our prefix cache
        self.routed_in = 0
        self.affinity_hits = 0
        self.bucket_counts: Counter = Counter()
        self.stats_path = getattr(h, "stats_path", None)
        # deadline-aware admission + bounded linger (serving/admission.py)
        self.admission = AdmissionController(
            safety_ms=float(getattr(h, "admission_safety_ms", 2.0)))
        self.batcher = AdaptiveBatcher(
            self.buckets, self.admission,
            linger_ms=float(getattr(h, "linger_ms", 0.0)))
        self.default_deadline_ms = getattr(h, "default_deadline_ms", None)
        # SLO engine (utils/slo.py): armed when the config declares
        # objectives; evaluated live by the stats loop, fed by the
        # writer/shed/dead-letter paths through _count/_record_row_timing
        self.slo: Optional[SloEngine] = None
        if getattr(h, "slo_objectives", None):
            self.slo = SloEngine(h.slo_objectives)
        # multi-tenant intake (serving/admission.TenantScheduler,
        # docs/multi-tenancy.md): armed when the config declares SLO
        # classes; one SloEngine per class with objectives, so burn
        # rates are evaluated per tenant
        self.tenants: Optional[TenantScheduler] = None
        self._class_slo: Dict[str, SloEngine] = {}
        if getattr(h, "slo_classes", None):
            self.tenants = TenantScheduler(h.slo_classes)
            self._class_slo = {c.name: SloEngine(c.objectives,
                                                 service=c.name)
                               for c in h.slo_classes if c.objectives}
        # committed-timing jsonl for `zoo-serving trace <id>`
        self._request_log: Optional[_RequestLog] = None
        if getattr(h, "request_log", None):
            self._request_log = _RequestLog(h.request_log)
        # intake backlog sources, populated by _serve_pipelined (admission
        # reads live queue depths instead of guessing from counters)
        self._backlog_queues: List[queue.Queue] = []
        # generative serving (serving/generation.py): engine injected via
        # set_generate_engine or built from config; scheduler starts
        # lazily on the first generate record
        self._gen_engine = None
        self._gen_sched = None
        self._gen_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_model(self):
        """Model used when none is injected; the registry router
        overrides this (models come from the ModelRegistry instead)."""
        if getattr(self.helper, "stub_ms_per_batch", None) is not None:
            return EchoStubModel(self.helper.stub_ms_per_batch)
        if self.helper.model_path:
            return self.helper.load_inference_model()
        return None

    # -- record decode (the foreachBatch mapPartitions body) -----------
    def _decode_record(self, rec: dict) -> np.ndarray:
        if "image" in rec:
            raw = base64.b64decode(rec["image"])
            try:
                img = codec.decode(raw, rec.get("uri"))
            except ValueError as e:
                raise ValueError(f"undecodable image for {rec.get('uri')}: "
                                 f"{e}") from None
            c, h, w = self.helper.image_shape
            # uint8 LINEAR, OpenCV's default resize
            img = resize_image(img, (w, h)).astype(np.float32)
            if self.preprocessing is not None:
                img = self.preprocessing(img)
            return np.transpose(img, (2, 0, 1))  # NCHW like the reference
        tensors = rec["tensors"]
        arrays = [np.frombuffer(t["data"], np.float32).reshape(t["shape"])
                  for t in tensors.values()]
        out = arrays[0] if len(arrays) == 1 else arrays
        if self.preprocessing is not None and len(arrays) == 1:
            out = self.preprocessing(out)
        return out

    def _format_result(self, p: np.ndarray) -> dict:
        if self.helper.top_n and p.ndim == 1 and \
                p.shape[0] > self.helper.top_n:
            top = np.argsort(p)[::-1][:self.helper.top_n]
            return {"value": [[int(i), float(p[i])] for i in top]}
        return {"value": p.tolist()}

    def _count(self, **deltas):
        with self._ctr_lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)
        # every shed / dead letter is one bad event in the SLO stream
        # (served rows enter through _record_row_timing with a latency)
        if self.slo is not None:
            for _ in range(int(deltas.get("shed", 0))):
                self.slo.record(shed=True)
            for _ in range(int(deltas.get("dead_letters", 0))):
                self.slo.record(error=True)

    def pipeline_stats(self) -> dict:
        """Counters + per-stage percentiles + queue depths — the payload
        the bench leg, smoke entry, and tests assert on."""
        with self._ctr_lock:
            out = {"records_in": self.records_in,
                   "results_out": self.results_out,
                   "dropped": self.dropped,
                   "dead_letters": self.dead_letters,
                   "shed": self.shed,
                   "batches": self.batches,
                   "buckets": dict(self.bucket_counts)}
        out["admission"] = self.admission.stats()
        if self.slo is not None:
            out["slo"] = self.slo.status()
        if self.tenants is not None:
            out["tenants"] = self.tenants.stats()
        if self._class_slo:
            out["slo_classes"] = {n: e.status()
                                  for n, e in self._class_slo.items()}
        if self._gen_sched is not None:
            out["generation"] = self._gen_sched.stats()
        report = self.generate_load_report()
        if report is not None:
            out["routing"] = report
        if hasattr(self.db, "consumer_stats"):
            out["queue"] = self.db.consumer_stats()
        out.update(self.summary.snapshot())
        return out

    def generate_load_report(self, max_keys: int = 32) -> Optional[dict]:
        """Heartbeat payload section for the fleet router
        (serving/routing.py); None when this server has no generate
        engine configured.  Before the scheduler lazily starts, an
        all-free report advertises the configured capacity so routing
        works from the first request."""
        sched = self._gen_sched
        if sched is None:
            h = self.helper
            if self._gen_engine is None and \
                    getattr(h, "generate_stub_ms_per_step", None) is None:
                return None
            slots = max(int(getattr(h, "generate_slots", 4) or 4), 1)
            report = {"slots": slots, "active_slots": 0,
                      "free_slots": slots, "queue_depth": 0,
                      "queued_steps": 0, "prefix_keys": []}
        else:
            report = sched.load_report(max_keys=max_keys)
        with self._ctr_lock:
            report["routed_in"] = self.routed_in
            report["affinity_hits"] = self.affinity_hits
        return report

    # -- deadline admission + timing decomposition ----------------------
    def _meta_for(self, rid: str, rec: dict, t_in: float) -> RecordMeta:
        enq = rec.get("enqueue_ts_ms")
        deadline_ms = rec.get("deadline_ms", self.default_deadline_ms)
        deadline_at = None
        if deadline_ms is not None:
            # relative to the client stamp when present, else to arrival
            deadline_at = (enq if enq is not None else now_ms()) \
                + float(deadline_ms)
        trace_id = rec.get("trace_id") or rec.get(b"trace_id")
        if isinstance(trace_id, (bytes, bytearray)):
            trace_id = trace_id.decode()
        tenant = None
        if self.tenants is not None:
            model = rec.get("model") or rec.get(b"model")
            version = rec.get("version") or rec.get(b"version")
            if isinstance(model, (bytes, bytearray)):
                model = model.decode()
            if isinstance(version, (bytes, bytearray)):
                version = version.decode()
            tenant = self.tenants.classify(
                None if model is None else str(model),
                None if version is None else str(version))
        return RecordMeta(t_in, rec.get("uri", rid), enq,
                          rec.get("dequeue_ts_ms"), deadline_at, trace_id,
                          tenant)

    def _backlog(self) -> int:
        n = sum(q.qsize() for q in self._backlog_queues)
        if self.tenants is not None:
            n += self.tenants.queued_total()
        return n

    def _shed(self, metas: Sequence[RecordMeta], code: str):
        """Commit typed rejection payloads for records that cannot meet
        their deadline (clients decode these as ServingRejected)."""
        if not metas:
            return
        msg = {SHED_DEADLINE: "deadline unmeetable at admission",
               SHED_EXPIRED: "deadline expired in queue",
               SHED_CAPACITY: "shed by tenant policy under pressure",
               }.get(code, code)
        payload = {}
        for m in metas:
            payload[m.uri] = json.dumps(
                {"error": msg, "code": code}).encode()
            # typed shed tagged with the request's trace context, so a
            # rejected request still shows its (truncated) causal tree
            telemetry.event("serving/shed", code=code, uri=m.uri,
                            trace_id=m.trace_id)
            # a shed is one bad event in the tenant's own SLO stream too
            eng = self._class_slo.get(m.tenant) if m.tenant else None
            if eng is not None:
                eng.record(shed=True)
        self.db.put_results(payload)
        self._count(shed=len(metas))
        telemetry.counter("zoo_serving_shed_total", code=code).inc(len(metas))

    @staticmethod
    def _timing_payload(meta: RecordMeta, disp_ts_ms: float,
                        device_ms: float, done_ms: float) -> dict:
        """Per-row latency decomposition committed with the result:
        transport_in_ms (client enqueue → backend dequeue), queue_ms
        (dequeue → dispatch), device_ms (dispatch → host transfer done),
        server_ms (dequeue → result committed).  The client adds
        rtt_ms/transport_ms from its own receive stamp."""
        t = {"device_ms": round(device_ms, 3), "done_ts_ms": round(done_ms, 3),
             "uri": meta.uri}
        if meta.trace_id:
            t["trace_id"] = meta.trace_id
        if meta.tenant:
            t["tenant"] = meta.tenant
        if meta.enqueue_ts_ms is not None:
            t["enqueue_ts_ms"] = meta.enqueue_ts_ms
        if meta.dequeue_ts_ms is not None:
            t["dequeue_ts_ms"] = meta.dequeue_ts_ms
            t["queue_ms"] = round(max(disp_ts_ms - meta.dequeue_ts_ms,
                                      0.0), 3)
            t["server_ms"] = round(max(done_ms - meta.dequeue_ts_ms,
                                       0.0), 3)
            if meta.enqueue_ts_ms is not None:
                t["transport_in_ms"] = round(
                    max(meta.dequeue_ts_ms - meta.enqueue_ts_ms, 0.0), 3)
        return t

    def _record_row_timing(self, timing: dict):
        """Feed the decomposition into the summary so percentiles for
        the new stages ride the existing snapshot machinery — plus the
        SLO stream (one good/bad event per served row) and the
        committed-timing request log (`zoo-serving trace <id>`)."""
        self.summary.record_stage("device", timing["device_ms"] / 1e3)
        if "transport_in_ms" in timing:
            self.summary.record_stage("transport",
                                      timing["transport_in_ms"] / 1e3)
        if "queue_ms" in timing:
            self.summary.record_stage("queue_wait", timing["queue_ms"] / 1e3)
        if self.slo is not None or self._class_slo:
            if timing.get("enqueue_ts_ms") is not None:
                lat = timing["done_ts_ms"] - timing["enqueue_ts_ms"]
            else:
                lat = timing.get("server_ms", timing["device_ms"])
            if self.slo is not None:
                self.slo.record(latency_ms=lat)
            eng = self._class_slo.get(timing.get("tenant"))
            if eng is not None:
                eng.record(latency_ms=lat)
        if self._request_log is not None:
            self._request_log.append(dict(timing, kind="predict"))

    # ------------------------------------------------------------------
    # generative serving (docs/serving-generate.md)
    # ------------------------------------------------------------------
    def set_generate_engine(self, engine):
        """Inject a gang-decode engine (TransformerDecodeEngine or any
        object with the alloc/grow/join/step/evict protocol) before the
        first generate record arrives."""
        self._gen_engine = engine
        return self

    def build_transformer_engine(self, layer, params=None, max_len=None):
        """Construct and inject a ``TransformerDecodeEngine`` honouring
        the ``generate`` config block: ``kv_cache: int8`` selects
        ``Int8KVSlab`` storage, ``prefix_cache_mb`` attaches a
        shared-prefix cache, ``speculative.k`` is NOT applied here (a
        device draft model must be paired explicitly — wrap with
        ``SpeculativeDecodeEngine`` before injecting).

        The port's layer holds its weights: ``params`` is None, or the
        JAX package's params tree of this layer, copied into it first
        (``utils.jax_weights.load_jax_params``). The engine runs on the
        context's device."""
        from .generation import TransformerDecodeEngine

        if params is not None:
            from ..utils.jax_weights import load_jax_params

            load_jax_params(layer, {layer.name: params})
        kv = str(getattr(self.helper, "generate_kv_dtype", "f32")).lower()
        engine = TransformerDecodeEngine(
            layer,
            max_len=max_len or getattr(self.helper, "generate_max_len",
                                       None),
            kv_dtype="int8" if kv == "int8" else None,
            prefix_cache=self._prefix_cache())
        return self.set_generate_engine(engine)

    def _prefix_cache(self):
        mb = float(getattr(self.helper, "generate_prefix_cache_mb", 0))
        if mb <= 0:
            return None
        from .generation import PrefixCache

        return PrefixCache(max_bytes=int(mb * (1 << 20)))

    def _generate_engine(self):
        if self._gen_engine is None and \
                getattr(self.helper, "generate_stub_ms_per_step",
                        None) is not None:
            from .generation import StubDecodeEngine
            from ..ops.kv_cache import cache_length_buckets

            buckets = cache_length_buckets(self.helper.generate_max_len)
            self._gen_engine = StubDecodeEngine(
                ms_per_step=self.helper.generate_stub_ms_per_step,
                stop_id=self.helper.generate_stop_id or 0,
                capacity_buckets=buckets,
                prefix_cache=self._prefix_cache())
            k = int(getattr(self.helper, "generate_speculative_k", 0))
            if k > 0:
                from .generation import SpeculativeDecodeEngine

                draft_ms = getattr(self.helper,
                                   "generate_draft_ms_per_step", None)
                if draft_ms is None:
                    draft_ms = self.helper.generate_stub_ms_per_step / 10.0
                draft = StubDecodeEngine(
                    ms_per_step=draft_ms,
                    stop_id=self.helper.generate_stop_id or 0,
                    capacity_buckets=buckets)
                self._gen_engine = SpeculativeDecodeEngine(
                    self._gen_engine, draft, k=k)
        return self._gen_engine

    def _gen_scheduler(self):
        """The continuous-batching scheduler, started on first use (its
        loop thread only exists when the workload includes generation)."""
        with self._gen_lock:
            if self._gen_sched is None:
                engine = self._generate_engine()
                if engine is None:
                    return None
                from .generation import ContinuousBatchScheduler

                slots = int(getattr(self.helper, "generate_slots", 4))
                batcher = AdaptiveBatcher(
                    power_of_two_buckets(slots), self.admission,
                    linger_ms=float(getattr(self.helper, "linger_ms", 0.0)))
                self._gen_sched = ContinuousBatchScheduler(
                    engine, commit=self._gen_commit, max_slots=slots,
                    continuous=bool(getattr(self.helper,
                                            "generate_continuous", True)),
                    admission=self.admission, batcher=batcher,
                    prefill_chunk=int(getattr(
                        self.helper, "generate_prefill_chunk", 0))).start()
            return self._gen_sched

    def _gen_commit(self, uri: str, payload: dict):
        """Scheduler results land in the same results map as
        predictions; sequences finish at different steps, so each commit
        is a single-uri write the moment its sequence evicts."""
        timing = payload.get("timing") or {}
        if "error" in payload:
            self._count(shed=1)
            if self.slo is not None:
                self.slo.record(shed=True)
        else:
            self._count(results_out=1)
            if self.slo is not None:
                lat = timing.get("server_ms")
                if timing.get("enqueue_ts_ms") is not None and \
                        timing.get("done_ts_ms") is not None:
                    lat = timing["done_ts_ms"] - timing["enqueue_ts_ms"]
                self.slo.record(latency_ms=lat)
        if self._request_log is not None:
            row = dict(timing, kind="generate", uri=uri)
            if "error" in payload:
                row["error"] = payload.get("code") or payload["error"]
            self._request_log.append(row)
        self.db.put_results({uri: json.dumps(payload).encode()})

    def _maybe_generate(self, rid: str, rec: dict,
                        t_in: float) -> bool:
        """Divert a generate record to the continuous-batching
        scheduler; True when the record was one (handled), False when
        it belongs to the predict pipeline."""
        gen = rec.get("generate") or rec.get(b"generate")
        if gen is None:
            return False
        meta = self._meta_for(rid, rec, t_in)
        if meta.trace_id:
            # step the client's flow arrow at the intake hop; the
            # scheduler's prefill span finishes it (same trace_id)
            telemetry.flow("serving/request", meta.trace_id, "t")
            telemetry.event("generate/intake", uri=meta.uri,
                            trace_id=meta.trace_id)
        if isinstance(gen, (bytes, bytearray)):
            # redis transports msgpack non-scalar fields
            from . import wire

            gen = wire.unpackb(gen)
        sched = self._gen_scheduler()
        if sched is None:
            self.db.put_results({meta.uri: json.dumps(
                {"error": "no generate engine configured",
                 "code": "no_engine"}).encode()})
            self._count(dead_letters=1)
            return True
        from .generation import GenRequest

        prompt = np.asarray(gen.get("prompt") or [], np.int64)
        routed_to = rec.get("routed_to", rec.get(b"routed_to"))
        if routed_to is not None:
            # router placed this record on our substream; count whether
            # the affinity bet paid off (warm membership probe only —
            # the real hit/miss counters move in the engine's lookup)
            pc = sched._engine_prefix_cache()
            warm = bool(pc is not None and pc.contains(prompt))
            self._count(routed_in=1, affinity_hits=1 if warm else 0)
            telemetry.counter("zoo_route_landed_total").inc()
            if warm:
                telemetry.counter("zoo_route_landed_warm_total").inc()
        stop_id = gen.get("stop_id")
        if stop_id is None:
            stop_id = getattr(self.helper, "generate_stop_id", None)
        sched.submit(GenRequest(
            uri=meta.uri,
            prompt=prompt,
            max_new_tokens=int(gen.get("max_new_tokens") or
                               getattr(self.helper,
                                       "generate_max_new_tokens", 32)),
            stop_id=None if stop_id is None else int(stop_id),
            temperature=float(gen.get("temperature") or 0.0),
            deadline_at_ms=meta.deadline_at_ms,
            enqueue_ts_ms=meta.enqueue_ts_ms,
            t_in=t_in,
            trace_id=meta.trace_id))
        return True

    # ------------------------------------------------------------------
    # synchronous loop (the pre-pipeline baseline, pipelined=False)
    # ------------------------------------------------------------------
    def _process_batch(self, items, t_in: Optional[float] = None):
        # never trust a StreamQueue backend to cap read_batch: chunk
        # oversized reads instead of compiling a giant signature
        bs = self.helper.batch_size
        for i in range(0, len(items), bs):
            self._process_chunk(items[i:i + bs], t_in)

    def _process_chunk(self, items, t_in: Optional[float] = None):
        metas, arrays = [], []
        for rid, rec in items:
            if self._maybe_generate(rid, rec,
                                    t_in or time.perf_counter()):
                continue
            try:
                meta = self._meta_for(rid, rec,
                                      t_in or time.perf_counter())
                with span("serving/decode", trace_id=meta.trace_id,
                          uri=meta.uri):
                    if meta.trace_id:
                        telemetry.flow("serving/request", meta.trace_id, "f")
                    arrays.append(self._decode_record(rec))
                metas.append(meta)
            except Exception as e:  # bad record: report, keep serving
                logger.warning("skipping record %s: %s", rid, e)
                self._count(dropped=1)
        if not arrays:
            return
        n = len(arrays)
        batch = np.stack(arrays)
        # pad to the configured batch size: one batch shape on the device
        # (skipped when the batch is exactly full)
        if n < self.helper.batch_size:
            pad = np.repeat(batch[-1:], self.helper.batch_size - n, axis=0)
            batch = np.concatenate([batch, pad])
        disp_ts_ms = now_ms()
        t0 = time.perf_counter()
        preds = np.asarray(self.model.predict(batch))[:n]
        dt = time.perf_counter() - t0
        self.summary.record_batch(n, dt)
        self.admission.observe_batch(n, dt)
        self._count(batches=1, records_in=n)
        self.bucket_counts[batch.shape[0]] += 1
        done_ms = now_ms()
        results = {}
        for meta, p in zip(metas, preds):
            obj = self._format_result(p)
            obj["timing"] = self._timing_payload(
                meta, disp_ts_ms, dt * 1e3, done_ms)
            self._record_row_timing(obj["timing"])
            results[meta.uri] = json.dumps(obj).encode()
        self.db.put_results(results)
        self._count(results_out=n)
        if t_in is not None:
            now = time.perf_counter()
            for _ in range(n):
                self.summary.record_stage("e2e", now - t_in)

    def _serve_sync(self, poll_timeout: float = 0.5):
        while not self._stop.is_set():
            items = self.db.read_batch(self.helper.batch_size,
                                       timeout=poll_timeout)
            if items:
                self._process_batch(items, t_in=time.perf_counter())
            # watermark trim (ClusterServing.scala:130-136)
            if self.db.stream_len() > self.helper.stream_maxlen:
                self.db.trim(int(self.helper.stream_maxlen * 0.6 * 0.8))

    # ------------------------------------------------------------------
    # pipelined loop (decode pool -> bucketed async compute -> writer)
    # ------------------------------------------------------------------
    def _ready_item(self, meta: RecordMeta, rec: dict, arr):
        """Tuple pushed onto the ready queue for one decoded record; the
        registry router appends the record's routing fields."""
        return (meta, arr)

    def _on_decode_error(self, rid: str, rec: dict, exc: Exception):
        """Undecodable record; the router dead-letters instead."""
        logger.warning("skipping record %s: %s", rid, exc)
        self._count(dropped=1)

    def _decode_worker(self, decode_in: queue.Queue, ready: queue.Queue):
        while True:
            item = decode_in.get()
            if item is _SENTINEL:
                return
            meta, rid, rec = item
            t0 = time.perf_counter()
            try:
                with span("serving/decode", trace_id=meta.trace_id,
                          uri=meta.uri):
                    if meta.trace_id:
                        # bind the client's flow arrow to this slice
                        telemetry.flow("serving/request", meta.trace_id, "f")
                    arr = self._decode_record(rec)
            except Exception as e:  # bad record: report, keep serving
                self._on_decode_error(rid, rec, e)
                continue
            self.summary.record_stage("decode", time.perf_counter() - t0)
            ready.put(self._ready_item(meta, rec, arr))

    @staticmethod
    def _oldest_deadline(batch_items) -> Optional[float]:
        deadlines = [it[0].deadline_at_ms for it in batch_items
                     if it[0].deadline_at_ms is not None]
        return min(deadlines) if deadlines else None

    def _compute_loop(self, ready: queue.Queue, write_q: queue.Queue):
        bs = self.helper.batch_size
        while True:
            item = ready.get()
            if item is _SENTINEL:
                return
            batch_items, saw_sentinel = [item], False
            # greedy assembly: take whatever is already decoded, up to
            # batch_size; with a linger budget (params.linger_ms) the
            # assembler may additionally block a bounded moment to round
            # a partial batch up to the next padding bucket — never past
            # the oldest queued record's deadline slack
            while len(batch_items) < bs:
                try:
                    nxt = ready.get_nowait()
                except queue.Empty:
                    budget = self.batcher.linger_budget_s(
                        len(batch_items),
                        self._oldest_deadline(batch_items))
                    if budget <= 0.0:
                        break
                    telemetry.event("serving/linger", n=len(batch_items),
                                    budget_ms=round(budget * 1e3, 3))
                    try:
                        with span("serving/linger_wait", n=len(batch_items)):
                            nxt = ready.get(timeout=budget)
                    except queue.Empty:
                        break
                if nxt is _SENTINEL:
                    saw_sentinel = True
                    break
                batch_items.append(nxt)
            self._dispatch_batch(batch_items, write_q)
            if saw_sentinel:
                return

    def _dispatch_batch(self, batch_items, write_q: queue.Queue):
        # second shed point: a record whose deadline expired while it
        # sat decoded in the ready queue gets a typed rejection instead
        # of a batch slot nobody is waiting on
        at = now_ms()
        live, expired = [], []
        for it in batch_items:
            if self.admission.expired(it[0].deadline_at_ms, at):
                expired.append(it[0])
            else:
                live.append(it)
        self._shed(expired, SHED_EXPIRED)
        if not live:
            return
        metas = [it[0] for it in live]
        arrays = [it[1] for it in live]
        n = len(arrays)
        bucket = pick_bucket(n, self.buckets)
        trace_ids = [m.trace_id for m in metas if m.trace_id]
        try:
            with span("serving/dispatch", n=n, bucket=bucket,
                      trace_ids=trace_ids):
                batch = np.stack(arrays)
                if n < bucket:
                    pad = np.repeat(batch[-1:], bucket - n, axis=0)
                    batch = np.concatenate([batch, pad])
                disp_ts_ms = now_ms()
                t0 = time.perf_counter()
                # async dispatch: don't block on the host transfer of
                # batch k before submitting k+1 — the writer stage
                # synchronizes on this batch's copy alone
                out = HostCopy(self.model.predict_async(batch))
        except Exception as e:
            logger.warning("dropping batch of %d (%s)", n, e)
            self._count(dropped=n)
            return
        self.summary.record_stage("dispatch", time.perf_counter() - t0)
        self._count(batches=1)
        with self._ctr_lock:
            self.bucket_counts[bucket] += 1
        write_q.put((metas, n, t0, disp_ts_ms, out))

    def _writer_loop(self, write_q: queue.Queue):
        while True:
            item = write_q.get()
            if item is _SENTINEL:
                return
            metas, n, t_disp, disp_ts_ms, out = item
            trace_ids = [m.trace_id for m in metas if m.trace_id]
            try:
                with span("serving/device_sync", n=n, trace_ids=trace_ids):
                    preds = np.asarray(out.wait())[:n]  # host sync point
            except Exception as e:
                logger.warning("dropping results for %d records (%s)",
                               n, e)
                self._count(dropped=n)
                continue
            dt = time.perf_counter() - t_disp
            self.summary.record_batch(n, dt)   # Throughput/LatencyMs parity
            self.summary.record_stage("compute", dt, batch_size=n)
            # feed the admission controller's service-time estimates
            self.admission.observe_batch(n, dt)
            done_ms = now_ms()
            t0 = time.perf_counter()
            with span("serving/write", n=n, trace_ids=trace_ids):
                results = {}
                for meta, p in zip(metas, preds):
                    obj = self._format_result(p)
                    obj["timing"] = self._timing_payload(
                        meta, disp_ts_ms, dt * 1e3, done_ms)
                    self._record_row_timing(obj["timing"])
                    results[meta.uri] = json.dumps(obj).encode()
                self.db.put_results(results)
            now = time.perf_counter()
            self.summary.record_stage("write", now - t0, batch_size=n)
            for meta in metas:
                self.summary.record_stage("e2e", now - meta.t_in)
            self._count(results_out=n)

    def _serve_pipelined(self, poll_timeout: float = 0.5):
        decode_in: queue.Queue = queue.Queue(self.queue_depth)
        ready: queue.Queue = queue.Queue(self.queue_depth)
        write_q: queue.Queue = queue.Queue(self.queue_depth)
        self._backlog_queues = [decode_in, ready]
        decoders = [threading.Thread(target=self._decode_worker,
                                     args=(decode_in, ready), daemon=True,
                                     name=f"serving-decode-{i}")
                    for i in range(self.decode_workers)]
        compute = threading.Thread(target=self._compute_loop,
                                   args=(ready, write_q), daemon=True,
                                   name="serving-compute")
        writer = threading.Thread(target=self._writer_loop,
                                  args=(write_q,), daemon=True,
                                  name="serving-write")
        for t in decoders + [compute, writer]:
            t.start()
        try:
            while not self._stop.is_set():
                # bound the per-tenant staging queues: past the cap, stop
                # pulling from the stream (it has its own watermark trim)
                # and let the pressure sheds / drain catch up
                if (self.tenants is not None and
                        self.tenants.queued_total() >= 4 * self.queue_depth):
                    items = []
                    time.sleep(min(poll_timeout, 0.05))
                else:
                    items = self.db.read_batch(self.helper.batch_size,
                                               timeout=poll_timeout)
                if items:
                    now = time.perf_counter()
                    for rid, rec in items:
                        # generate records divert to the continuous-
                        # batching scheduler (their admission happens at
                        # slot-refill time, with the per-token estimate)
                        if self._maybe_generate(rid, rec, now):
                            continue
                        meta = self._meta_for(rid, rec, now)
                        # first shed point: admission control against the
                        # measured service time + live backlog
                        if meta.deadline_at_ms is not None:
                            slack = meta.deadline_at_ms - now_ms()
                            ok, code = self.admission.admit(
                                slack, self._backlog())
                            if not ok:
                                self._shed([meta], code)
                                continue
                        if self.tenants is not None:
                            # stage per tenant; the DRR drain below picks
                            # the weighted-fair order into the pipeline
                            self.tenants.offer(meta.tenant,
                                               (meta, rid, rec))
                        else:
                            decode_in.put((meta, rid, rec))  # backpressure
                    self._count(records_in=len(items))
                if self.tenants is not None:
                    # second shed point: capacity policy — the least
                    # important class gives up its oldest queued records
                    # while any class's predicted wait overruns its bound
                    pipe_backlog = sum(q.qsize()
                                       for q in self._backlog_queues)
                    victims = self.tenants.shed_under_pressure(
                        self.admission, pipe_backlog)
                    if victims:
                        self._shed([item[0] for _t, item in victims],
                                   SHED_CAPACITY)
                    for item in self.tenants.drain(self.queue_depth):
                        decode_in.put(item)  # backpressure here
                if items or self.tenants is not None:
                    self.summary.record_queue_depth("decode",
                                                    decode_in.qsize())
                    self.summary.record_queue_depth("ready", ready.qsize())
                    self.summary.record_queue_depth("write", write_q.qsize())
                # watermark trim (ClusterServing.scala:130-136)
                if self.db.stream_len() > self.helper.stream_maxlen:
                    self.db.trim(int(self.helper.stream_maxlen * 0.6 * 0.8))
        finally:
            # orderly drain: each stage fully flushes before the next
            # stage sees its sentinel, so no in-flight record is lost
            if self.tenants is not None:
                for item in self.tenants.drain(1 << 30):
                    decode_in.put(item)
            for _ in decoders:
                decode_in.put(_SENTINEL)
            for t in decoders:
                t.join()
            ready.put(_SENTINEL)
            compute.join()
            write_q.put(_SENTINEL)
            writer.join()

    # ------------------------------------------------------------------
    def warmup(self, shape: Optional[Sequence[int]] = None) -> dict:
        """Run every padding bucket's batch shape once before the
        loop accepts traffic.  ``shape`` is the per-record tensor shape
        (defaults to the configured ``image_shape``).  Returns
        {bucket: seconds}; failures are logged and skipped (foreign
        backends may reject the synthetic input)."""
        shape = tuple(shape if shape is not None else
                      self.helper.image_shape)
        times = {}
        for b in self.buckets:
            try:
                times.update(self.model.warm(shape, [b]))
            except Exception as e:  # noqa: BLE001 - warmup is best-effort
                logger.warning("warmup: bucket %d failed: %s", b, e)
                continue
            logger.info("warmup: bucket %d compiled in %.3fs", b, times[b])
        return times

    def _stats_dump_loop(self, interval: float = 2.0):
        """Periodically snapshot pipeline_stats() to ``stats_path`` (atomic
        rename) so `zoo-serving status` can report live percentiles from
        outside the process — and, when SLO objectives are armed, run one
        burn-rate evaluation pass per tick (gauges + edge-triggered
        alerts; utils/slo.py)."""
        from ..utils import file_io

        while True:
            engines = ([self.slo] if self.slo is not None else []) \
                + list(self._class_slo.values())
            for eng in engines:
                try:
                    eng.evaluate()
                except Exception as e:  # noqa: BLE001 - observability only
                    logger.debug("slo evaluate failed: %s", e)
            if self.stats_path:
                try:
                    file_io.write_bytes_atomic(
                        self.stats_path,
                        json.dumps(self.pipeline_stats()).encode())
                except Exception as e:  # noqa: BLE001 - observability only
                    logger.debug("stats dump failed: %s", e)
            if self._stop.wait(interval):
                return

    def serve_forever(self, poll_timeout: float = 0.5):
        logger.info("cluster serving started (batch=%d, %s, buckets=%s)",
                    self.helper.batch_size,
                    "pipelined" if self.pipelined else "synchronous",
                    self.buckets if self.pipelined else "n/a")
        if self.stats_path or self.slo is not None or self._class_slo:
            threading.Thread(target=self._stats_dump_loop, daemon=True,
                             name="serving-stats").start()
        if self.pipelined:
            self._serve_pipelined(poll_timeout)
        else:
            self._serve_sync(poll_timeout)
        # drain the generation gang last: in-flight sequences finish (or
        # shed) and every submitted request gets exactly one result
        with self._gen_lock:
            sched = self._gen_sched
        if sched is not None:
            sched.stop(drain=True, timeout=30)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._request_log is not None:
            self._request_log.close()
