"""One serving-fleet worker process (spawned by serving/fleet.py).

Counterpart of ``analytics_zoo_tpu/serving/fleet_worker.py``, copied.
Where the JAX worker honours ``JAX_PLATFORMS``, this one takes
``--device`` (``cuda`` by default) and passes it to
``init_nncontext(device=...)`` before it builds anything: without a
CUDA device a ``cuda`` worker raises, it never serves on the CPU.

Runs the standard pipelined serve loop against the shared transport,
plus the fleet-specific plumbing:

- **heartbeat**: a daemon thread writes ``health/worker-N.json`` every
  ``params.health_interval`` seconds with pid, records served, and shed
  count — the fleet manager's liveness signal and `zoo-serving status`'s
  data source;
- **registry sharing**: worker 0 owns the file-RPC control plane (and
  manifest writes); workers >0 watch the manifest's mtime and
  ``recover(save=False)`` on change, so a deploy/promote through worker
  0 reaches every replica without cross-process RPC;
- **teardown**: SIGTERM/SIGINT set the serve loop's stop event — the
  pipeline drains in order (no in-flight record is lost) before exit.

Usage (normally via ServingFleet, runnable standalone for debugging)::

    python -m analytics_zoo_tpu_torch.serving.fleet_worker \
        --config config.yaml --workdir /tmp/fleet --worker-id 0 \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from ..common.nncontext import init_nncontext
from ..utils import telemetry
from .fleet import HEALTH_DIR, write_health

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.fleet_worker")


def _build_serving(cfg: str, workdir: str, worker_id: int):
    """Worker-side twin of cli._build_serving: per-worker stats path,
    control-plane ownership only on worker 0, manifest following on the
    rest."""
    from .cluster_serving import ClusterServing, ClusterServingHelper

    helper = ClusterServingHelper(config_path=cfg)
    helper.stats_path = os.path.join(workdir,
                                     f"stats-worker-{worker_id}.json")
    if not helper.request_log and (helper.telemetry or telemetry.enabled()):
        # committed timings per worker — `zoo-serving trace <id>` scans
        # every requests*.jsonl under the workdir for the waterfall
        helper.request_log = os.path.join(
            workdir, f"requests-worker-{worker_id}.jsonl")
    # file transports get routed-placement intake: drain our private
    # generate substream first, then the shared any-claim stream
    # (serving/routing.py; a fleet with no router sees an empty
    # substream and behaves exactly as before)
    backend = None
    root = None
    src = helper.src or ""
    if src.startswith("file:"):
        from .routing import WorkerIntakeQueue

        root = src[len("file:"):]
        backend = WorkerIntakeQueue(root, worker_id)
    if not helper.registry_root:
        return ClusterServing(helper=helper, backend=backend), None
    from .registry import ModelRegistry, RegistryControlServer
    from .router import RoutedClusterServing

    registry = ModelRegistry(
        root=helper.registry_root,
        default_model=helper.default_model,
        canary_error_threshold=helper.canary_error_threshold,
        canary_min_requests=helper.canary_min_requests)
    serving = RoutedClusterServing(registry, helper=helper,
                                   backend=backend)
    registry.recover(load=True, warmup=serving.registry_warmup(),
                     save=worker_id == 0)
    ctl = None
    if worker_id == 0:
        if helper.model_path and not registry.routed_versions():
            serving.deploy(path=helper.model_path)
        ctl = RegistryControlServer(registry, helper.registry_root,
                                    serving=serving).start()
    return serving, ctl


def _watch_manifest(serving, stop: threading.Event, interval: float = 1.0):
    """Followers poll the shared manifest's mtime; on change, re-recover
    (idempotent over loaded versions, never writes the manifest)."""
    registry = serving.registry
    uri = registry.manifest_uri
    last = None
    while not stop.wait(interval):
        try:
            mtime = os.path.getmtime(uri)
        except OSError:
            continue
        if last is not None and mtime != last:
            try:
                registry.recover(load=True,
                                 warmup=serving.registry_warmup(),
                                 save=False)
                logger.info("manifest change picked up")
            except Exception as e:  # noqa: BLE001 - keep serving
                logger.warning("manifest refresh failed: %s", e)
        last = mtime


def _heartbeat(serving, workdir: str, worker_id: int,
               stop: threading.Event, interval: float, restarts: int):
    started = time.time()
    while True:
        with serving._ctr_lock:
            served, shed = serving.results_out, serving.shed
        payload = {
            "pid": os.getpid(),
            "started_at": started,
            "records_served": served,
            "shed": shed,
            "restarts": restarts,
            # EWMA service estimates ride the heartbeat so the
            # supervisor's backlog autoscaler can predict queue wait
            # without RPC into the worker
            "admission": serving.admission.stats(),
        }
        try:
            # routing load report (free slots, queued decode steps,
            # prefix-key digest) rides the same heartbeat — the fleet
            # router's only data source (serving/routing.py)
            report = serving.generate_load_report()
        except Exception:  # noqa: BLE001 - never kill the heartbeat
            report = None
        if report is not None:
            payload["routing"] = report
        dump = getattr(serving, "_flight_dump_path", None)
        if dump:
            payload["flight_dump"] = dump
        write_health(workdir, worker_id, payload)
        if stop.wait(interval):
            return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zoo-serving-fleet-worker")
    ap.add_argument("--config", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu when "
                         "asked for); without a CUDA device a cuda worker "
                         "raises")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s worker-{args.worker_id} %(message)s")
    init_nncontext(device=args.device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(os.path.join(workdir, HEALTH_DIR), exist_ok=True)
    serving, _ctl = _build_serving(args.config, workdir, args.worker_id)
    if serving.helper.telemetry or telemetry.enabled():
        # per-worker metrics snapshots land next to the stats dumps so
        # the supervisor (worker 0's host) can merge a fleet view
        telemetry.configure(enabled=True,
                            trace_dir=serving.helper.trace_dir,
                            service=f"serving-worker-{args.worker_id}",
                            export_metrics=False)
        telemetry.start_metrics_exporter(os.path.join(
            workdir, f"metrics-worker-{args.worker_id}.json"))
    if serving.helper.warmup:
        serving.warmup()
    stop = threading.Event()
    restarts = int(os.environ.get("ZOO_SERVING_WORKER_RESTARTS", "0"))

    def _term(sig, _frm):
        telemetry.event("serving/drain", signal=sig,
                        worker=args.worker_id)
        dump = telemetry.dump_flight(
            f"serving worker {args.worker_id} draining on signal {sig}")
        if dump:
            # stamp the post-mortem path into the heartbeat file so
            # `zoo-serving status` can point an operator straight at it
            serving._flight_dump_path = dump
            with serving._ctr_lock:
                served, shed = serving.results_out, serving.shed
            write_health(workdir, args.worker_id, {
                "pid": os.getpid(), "records_served": served,
                "shed": shed, "restarts": restarts,
                "flight_dump": dump, "draining": True,
            })
        stop.set()
        serving._stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    hb = threading.Thread(
        target=_heartbeat,
        args=(serving, workdir, args.worker_id, stop,
              float(serving.helper.health_interval), restarts),
        daemon=True, name="fleet-heartbeat")
    hb.start()
    if args.worker_id > 0 and getattr(serving, "registry", None) is not None:
        threading.Thread(target=_watch_manifest, args=(serving, stop),
                         daemon=True, name="fleet-manifest-watch").start()
    logger.info("fleet worker %d serving (pid %d)", args.worker_id,
                os.getpid())
    try:
        serving.serve_forever()
    finally:
        stop.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
