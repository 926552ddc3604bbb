"""InferenceSummary: throughput/latency scalars for serving.

A copy of ``analytics_zoo_tpu/pipeline/inference/inference_summary.py``
over the port's ``utils/telemetry.py`` and ``utils/tensorboard.py``.

Parity: ``zoo/.../pipeline/inference/InferenceSummary.scala:46`` (wired by
``ClusterServing.scala:96-97``) — TensorBoard scalars via the event-writer
in ``utils.tensorboard``.

Pipeline extension: the serving engine is a three-stage pipeline
(decode -> compute -> write), so the summary now tracks *per-stage*
latency reservoirs with p50/p95/p99, plus queue depths, in addition to
the original per-batch Throughput/LatencyMs scalars.  A summary built
with ``log_dir=None`` keeps the in-memory statistics without writing
TensorBoard events (the serving bench and smoke entry use this).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, Optional, Sequence

from ...utils import telemetry


class LatencyStats(telemetry.Summary):
    """Bounded reservoir of recent latencies with percentile queries.

    Keeps the last ``maxlen`` observations (seconds) in a ring buffer so
    a long-running serving loop reports *recent* tail latency, not the
    all-time distribution.  Thread-safe: stages record concurrently.

    Storage is :class:`telemetry.Summary` — stage reservoirs are
    registered in the process metrics registry, so ``metrics.json`` /
    Prometheus render the same numbers ``stats.json`` does (the
    summary is an exporter, not a second bookkeeping system).
    """

    def __init__(self, name: str = "", labels=(), maxlen: int = 4096):
        super().__init__(name=name, labels=labels, maxlen=maxlen)


# distinct serving instances in one process (tests build several) must
# not share stage reservoirs — each summary labels its metrics with a
# process-unique instance id
_INSTANCE_IDS = itertools.count()


class InferenceSummary:
    """Scalars + per-stage latency reservoirs.

    ``log_dir=None`` builds a stats-only summary (no event files) — the
    pipelined serving loop always keeps one so queue overlap is
    observable even when TensorBoard logging is off.
    """

    def __init__(self, log_dir: Optional[str] = None,
                 app_name: str = "serving"):
        self.writer = None
        if log_dir is not None:
            from ...utils import tensorboard

            self.writer = tensorboard.FileWriter(
                os.path.join(log_dir, app_name, "inference"))
        self._step = 0
        self._lock = threading.Lock()
        self._app = app_name
        self._inst = str(next(_INSTANCE_IDS))
        self._stages: Dict[str, LatencyStats] = {}
        self._queue_depths: Dict[str, int] = {}

    def _next_step(self) -> int:
        # serving predicts run concurrently (permits > 1); the step
        # counter must not interleave
        with self._lock:
            self._step += 1
            return self._step

    def add_scalar(self, tag: str, value: float, step: int = None):
        if step is None:
            step = self._next_step()
        else:
            # keep the shared auto-step counter monotonic past explicit
            # steps, so mixing both never emits duplicate/out-of-order
            # steps for one tag
            with self._lock:
                self._step = max(self._step, step)
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def record_batch(self, batch_size: int, latency_s: float):
        step = self._next_step()
        if self.writer is not None:
            self.writer.add_scalar("Throughput",
                                   batch_size / max(latency_s, 1e-9), step)
            self.writer.add_scalar("LatencyMs", latency_s * 1e3, step)
        self._stage("predict").record(latency_s)

    # -- pipeline stages ----------------------------------------------
    def _stage(self, stage: str) -> LatencyStats:
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = telemetry.get_registry().register(
                    LatencyStats, "zoo_serving_stage_seconds",
                    {"stage": stage, "app": self._app,
                     "inst": self._inst})
                self._stages[stage] = st
            return st

    def record_stage(self, stage: str, latency_s: float,
                     batch_size: Optional[int] = None):
        """One observation for a pipeline stage ('decode', 'compute',
        'write', 'e2e', ...); ``batch_size`` also emits a per-stage
        throughput scalar."""
        self._stage(stage).record(latency_s)
        if self.writer is not None:
            step = self._next_step()
            self.writer.add_scalar(f"{stage}/LatencyMs", latency_s * 1e3,
                                   step)
            if batch_size:
                self.writer.add_scalar(
                    f"{stage}/Throughput",
                    batch_size / max(latency_s, 1e-9), step)

    def record_queue_depth(self, name: str, depth: int):
        with self._lock:
            self._queue_depths[name] = int(depth)
        telemetry.gauge("zoo_serving_queue_depth", queue=name,
                        app=self._app, inst=self._inst).set(depth)
        if self.writer is not None:
            self.add_scalar(f"Queue/{name}", depth)

    def stage_percentiles(self, stage: str,
                          pcts: Sequence[float] = (50, 95, 99)
                          ) -> Dict[str, float]:
        """Percentiles (ms) for one stage; zeros when unobserved."""
        return self._stage(stage).percentiles(pcts)

    def stage_count(self, stage: str) -> int:
        return self._stage(stage).count

    def snapshot(self) -> dict:
        """Everything at once: per-stage {count, mean_ms, p50/p95/p99}
        plus the latest queue depths — the observability payload for the
        bench leg and the smoke entry."""
        with self._lock:
            stages = dict(self._stages)
            depths = dict(self._queue_depths)
        out = {"queues": depths, "stages": {}}
        for name, st in stages.items():
            entry = {"count": st.count,
                     "mean_ms": round(st.mean() * 1e3, 3)}
            entry.update({k: round(v, 3)
                          for k, v in st.percentiles().items()})
            out["stages"][name] = entry
        return out

    def close(self):
        if self.writer is not None:
            self.writer.close()


class Timer:
    """``InferenceSupportive.timing`` parity: context manager measuring a
    predict call for the summary."""

    def __init__(self, summary: InferenceSummary = None,
                 batch_size: int = 1):
        self.summary = summary
        self.batch_size = batch_size
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.summary is not None:
            self.summary.record_batch(self.batch_size, self.elapsed)
        return False
