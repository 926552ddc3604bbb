"""Per-worker bootstrap: signal-safe teardown around the user's script.

Counterpart of ``analytics_zoo_tpu/launcher/worker.py``. The launcher
runs every worker as ``python -m analytics_zoo_tpu_torch.launcher.worker
<script> [args...]`` so that:

1. a supervisor-driven SIGTERM first tries a graceful drain: if a
   trainer is mid-loop (``pipeline.engine.active_trainer_count() > 0``)
   the handler requests preemption, the training loop checkpoints at the
   next step boundary and raises ``TrainingPreempted``, and the worker
   exits 143 having saved its state. A watchdog hard-exits after
   ``ZOO_TPU_PREEMPTION_GRACE_S`` (default 30) seconds in case the loop
   never reaches a step boundary;
2. when no trainer is active (or on SIGINT) teardown is immediate:
   every live infeed stage closes (``feature.shutdown_all_pipelines``)
   before exiting — otherwise concurrent.futures' atexit hook joins
   still-busy non-daemon transform-pool threads and a "killed" worker
   hangs instead of dying;
3. the script sees a clean ``sys.argv`` (its own name + args), exactly
   as if launched directly.

Deliberately import-light: torch and the package's heavy modules load
only if (and when) the user script imports them.
"""

from __future__ import annotations

import os
import runpy
import signal
import sys
import threading


def _grace_s() -> float:
    try:
        return float(os.environ.get("ZOO_TPU_PREEMPTION_GRACE_S", "30"))
    except ValueError:
        return 30.0


def _flight(reason: str, **args):
    """Flight-recorder dump via sys.modules (not an import: this worker
    shim stays light, and a process that never loaded telemetry has
    nothing worth dumping anyway)."""
    tel = sys.modules.get("analytics_zoo_tpu_torch.utils.telemetry")
    if tel is None:
        return
    try:
        tel.event("launch/worker_signal", **args)
        tel.dump_flight(reason)
    except Exception:  # noqa: BLE001 - teardown must proceed
        pass


def _hard_exit(signum: int):
    rank = os.environ.get("ZOO_TPU_PROCESS_ID", "?")
    _flight(f"worker {rank} hard exit on signal {signum}",
            rank=rank, signal=signum, drain=False)
    try:
        from analytics_zoo_tpu_torch.feature.feature_set import \
            shutdown_all_pipelines

        closed = shutdown_all_pipelines()
        if closed:
            print(f"[launcher.worker {rank}] closed {closed} pipeline "
                  f"stage(s) on signal {signum}", file=sys.stderr,
                  flush=True)
    finally:
        # 128+signum, the shell convention the supervisor reports
        os._exit(128 + signum)


def _shutdown_handler(signum, frame):  # noqa: ARG001 - signal signature
    rank = os.environ.get("ZOO_TPU_PROCESS_ID", "?")
    # sys.modules lookup, not an import: the handler must stay cheap and
    # must not pull torch into a worker that never trained
    engine = sys.modules.get("analytics_zoo_tpu_torch.pipeline.engine")
    if signum == signal.SIGTERM and engine is not None \
            and engine.active_trainer_count() > 0:
        print(f"[launcher.worker {rank}] SIGTERM: draining — checkpoint "
              f"at next step boundary (grace {_grace_s():.0f}s)",
              file=sys.stderr, flush=True)
        tel = sys.modules.get("analytics_zoo_tpu_torch.utils.telemetry")
        if tel is not None:
            try:
                tel.event("launch/drain_requested", rank=rank,
                          signal=signum)
            except Exception:  # noqa: BLE001
                pass
        engine.request_preemption()
        t = threading.Timer(_grace_s(), _hard_exit, args=(signum,))
        t.daemon = True
        t.start()
        return
    _hard_exit(signum)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m analytics_zoo_tpu_torch.launcher.worker "
              "<script.py> [args...]", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, _shutdown_handler)
    signal.signal(signal.SIGINT, _shutdown_handler)
    script, sys.argv = argv[0], argv
    # scripts resolve siblings relative to themselves, like `python x.py`
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)) or ".")
    try:
        runpy.run_path(script, run_name="__main__")
    except Exception as e:
        engine = sys.modules.get("analytics_zoo_tpu_torch.pipeline.engine")
        if engine is not None and isinstance(
                e, getattr(engine, "TrainingPreempted", ())):
            rank = os.environ.get("ZOO_TPU_PROCESS_ID", "?")
            print(f"[launcher.worker {rank}] drained: checkpoint saved, "
                  f"exiting 143", file=sys.stderr, flush=True)
            return 143
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
