"""RoutedClusterServing: the multi-model data plane over ModelRegistry.

Counterpart of ``analytics_zoo_tpu/serving/router.py``, copied; as in the
port's base loop, each dispatch starts its batch's
:class:`~analytics_zoo_tpu_torch.pipeline.inference.inference_model.
HostCopy` and the writer waits on it alone.

Extends the pipelined engine (docs/serving-pipeline.md) so one
serving process carries many named models: wire records gain optional
``model``/``version`` fields (absent fields route to the registry's
default model, so single-model clients keep working unchanged), the
compute stage resolves each record through :meth:`ModelRegistry.route`
at dispatch time — a hot-swap therefore takes effect for every record
not yet dispatched, even ones already decoded — and groups dispatch by
``(model, version, bucket)``.  Records that resolve to an unknown model
or whose batch fails are **dead-lettered**: an error payload lands in
the results map under the record uri (``{"error": ..., "model": ...,
"version": ...}``), so clients see a structured failure instead of a
silent timeout (:meth:`OutputQueue.wait_all` surfaces these as
:class:`~analytics_zoo_tpu_torch.serving.client.ServingError`).

Each dispatched batch holds an in-flight ref on its
:class:`ModelVersion` until the writer commits its results, which is
what :meth:`ModelRegistry.promote`'s drain waits on — the old version
is not released while any of its batches is still in the pipe.
"""

from __future__ import annotations

import json
import logging
import queue
import time
from typing import Optional

import numpy as np

from ..pipeline.inference.inference_model import HostCopy
from .admission import SHED_EXPIRED, now_ms
from .cluster_serving import (ClusterServing, ClusterServingHelper,
                              _SENTINEL, pick_bucket)
from .registry import ModelRegistry

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.router")


def _as_text(v):
    return v.decode() if isinstance(v, (bytes, bytearray)) else v


def _as_version(v) -> Optional[int]:
    if v is None or v == "" or v == b"":
        return None
    return int(_as_text(v))


class RoutedClusterServing(ClusterServing):
    """Pipelined serving with per-record model/version routing."""

    def __init__(self, registry: ModelRegistry,
                 helper: Optional[ClusterServingHelper] = None,
                 backend=None, config_path: Optional[str] = None,
                 summary=None, preprocessing=None):
        self.registry = registry
        super().__init__(model=None, helper=helper, backend=backend,
                         config_path=config_path, summary=summary,
                         preprocessing=preprocessing)
        if not self.pipelined:
            logger.warning("registry routing requires the pipelined "
                           "engine; ignoring params.pipelined=false")
        self.pipelined = True

    def _default_model(self):
        # models live in the registry, not on the serving instance
        return None

    # -- decode stage: carry the routing fields ------------------------
    def _ready_item(self, meta, rec, arr):
        # Redis transports hand back bytes keys *and* values; normalize
        # here so routing compares strings/ints everywhere downstream
        model = _as_text(rec.get("model") or rec.get(b"model"))
        try:
            version = _as_version(rec.get("version") or rec.get(b"version"))
        except (TypeError, ValueError):
            version = None
        return (meta, arr, (model, version))

    def _on_decode_error(self, rid, rec, exc):
        uri = rec.get("uri", rid)
        model = _as_text(rec.get("model") or rec.get(b"model"))
        self._dead_letter([(uri, f"decode failed: {exc}", model, None)])

    # -- compute stage: resolve routes, group, dispatch per version ----
    def _dispatch_batch(self, batch_items, write_q: queue.Queue):
        # shed deadline-expired records before routing (same policy as
        # the base engine's dispatch shed point)
        at = now_ms()
        live, expired = [], []
        for it in batch_items:
            if self.admission.expired(it[0].deadline_at_ms, at):
                expired.append(it[0])
            else:
                live.append(it)
        self._shed(expired, SHED_EXPIRED)
        groups, dead = {}, []
        for meta, arr, (model, version) in live:
            try:
                mv = self.registry.route(model, version, uri=meta.uri)
            except Exception as e:  # unknown model/version -> dead-letter
                dead.append((meta.uri, str(e) or repr(e), model, version))
                continue
            # (model, version, dtype) + the bucket picked per group is
            # the full dispatch key: an int8 canary version never shares
            # a batch (or a compile-cache entry) with its f32 baseline
            groups.setdefault((mv.name, mv.version, mv.dtype),
                              (mv, []))[1].append((meta, arr))
        if dead:
            self._dead_letter(dead)
        for mv, items in groups.values():
            self._dispatch_to_version(mv, items, write_q)

    def _dispatch_to_version(self, mv, items, write_q: queue.Queue):
        metas = [it[0] for it in items]
        arrays = [it[1] for it in items]
        n = len(arrays)
        bucket = pick_bucket(n, self.buckets)
        mv.acquire()  # held until the writer commits (promote drains it)
        try:
            batch = np.stack(arrays)
            if n < bucket:
                pad = np.repeat(batch[-1:], bucket - n, axis=0)
                batch = np.concatenate([batch, pad])
            disp_ts_ms = now_ms()
            t0 = time.perf_counter()
            out = HostCopy(mv.model.predict_async(batch))
        except Exception as e:
            mv.release()
            self.registry.record_result(mv, error=True, n=n)
            self._dead_letter([(m.uri, f"dispatch failed: {e}",
                                mv.name, mv.version) for m in metas])
            return
        self.summary.record_stage("dispatch", time.perf_counter() - t0)
        self._count(batches=1)
        with self._ctr_lock:
            self.bucket_counts[f"{mv.key}:{bucket}:{mv.dtype}"] += 1
        write_q.put((metas, n, t0, disp_ts_ms, out, mv))

    # -- write stage: per-version accounting + refcount release --------
    def _writer_loop(self, write_q: queue.Queue):
        while True:
            item = write_q.get()
            if item is _SENTINEL:
                return
            metas, n, t_disp, disp_ts_ms, out, mv = item
            try:
                preds = np.asarray(out.wait())[:n]  # host sync point
            except Exception as e:
                self.registry.record_result(mv, error=True, n=n)
                mv.release()
                self._dead_letter([(m.uri, f"predict failed: {e}",
                                    mv.name, mv.version) for m in metas])
                continue
            dt = time.perf_counter() - t_disp
            self.summary.record_batch(n, dt)
            self.summary.record_stage("compute", dt, batch_size=n)
            self.admission.observe_batch(n, dt)
            mv.summary.record_batch(n, dt)
            done_ms = now_ms()
            t0 = time.perf_counter()
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
                mv.summary.record_stage("e2e", now - meta.t_in)
            self._count(results_out=n)
            self.registry.record_result(mv, error=False, n=n)
            mv.release()

    # -- dead letters: error payloads in the results map ---------------
    def _dead_letter(self, entries):
        """entries: [(uri, message, model, version)] — committed to the
        results map so clients get a structured error, never a silent
        drop."""
        results = {}
        for uri, msg, model, version in entries:
            results[uri] = json.dumps(
                {"error": msg, "model": model, "version": version}).encode()
        try:
            self.db.put_results(results)
        except Exception as e:  # noqa: BLE001 - keep the stage alive
            logger.warning("dead-letter write failed for %d records: %s",
                           len(entries), e)
        self._count(dead_letters=len(entries))

    # -- registry-aware warmup + stats ---------------------------------
    def registry_warmup(self):
        """``warmup(model)`` callable for registry deploys: run every
        padding bucket off the serve path; raises on failure so
        deploy rolls back rather than swapping onto a broken version."""
        shape, buckets = tuple(self.helper.image_shape), list(self.buckets)
        return lambda inf: inf.warm(shape, buckets)

    def deploy(self, name: Optional[str] = None, model=None,
               path: Optional[str] = None, activate: bool = True,
               canary_weight: Optional[float] = None, warmup: bool = True,
               quantize: bool = False,
               calibration: Optional[str] = None):
        """Deploy into this server's registry with its bucket warmup;
        ``canary_weight`` deploys as a canary instead of activating;
        ``quantize`` deploys an int8 version (with optional exported
        ``calibration`` scales) for side-by-side comparison against the
        f32 baseline."""
        mv = self.registry.deploy(
            name, model=model, path=path,
            warmup=self.registry_warmup() if warmup else None,
            activate=activate and canary_weight is None,
            drain_timeout=self.helper.drain_timeout,
            quantize=quantize, calibration=calibration)
        if canary_weight is not None:
            self.registry.set_canary(mv.name, mv.version,
                                     float(canary_weight))
        return mv

    def warmup(self, shape=None) -> dict:
        """Best-effort warm of every currently routed version (the
        deploy path warms strictly; this covers recovered sets)."""
        shape = tuple(shape if shape is not None else
                      self.helper.image_shape)
        times = {}
        for mv in self.registry.routed_versions():
            for b in self.buckets:
                try:
                    t = mv.model.warm(shape, [b])
                except Exception as e:  # noqa: BLE001 - best-effort
                    logger.warning("warmup: %s bucket %d failed: %s",
                                   mv.key, b, e)
                    continue
                times[f"{mv.key}:{b}:{mv.dtype}"] = t[b]
        return times

    def pipeline_stats(self) -> dict:
        out = super().pipeline_stats()
        out["models"] = self.registry.stats()["models"]
        return out
