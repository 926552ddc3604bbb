"""Async trial executor: keeps the worker pool saturated during a search.

Counterpart of ``analytics_zoo_tpu/automl/executor.py``. The execution
half of distributed AutoML (policy lives in
:mod:`analytics_zoo_tpu_torch.automl.scheduler`).  The batch-synchronous engines
submit every trial up front and block on all refs at once; this executor
instead runs *segments* — "train trial T for B more epochs from its
checkpoint, report val loss" — as an as-completed stream over
:class:`~analytics_zoo_tpu_torch.ray.RayContext` remote tasks:

* a slot frees up → the next runnable segment is submitted immediately
  (``RayContext.wait(num_returns=1)``), so ASHA's async promotions keep
  every worker busy with no rung barrier;
* a segment reaching its rung boundary checkpoints the forecaster params
  under ``<workdir>/trial-<id>/weights.npz`` plus a ``progress.json``
  sidecar (cumulative epochs + a fresh cache token; both atomic
  renames); a promoted trial's next segment resumes from that checkpoint
  instead of retraining from scratch (optimizer moments restart per
  segment — the params do not);
* a segment whose worker process died (``WorkerLostError``) is requeued
  **exactly once** — same trial, same budget, resumed from the last
  committed checkpoint; a second loss (or a task-raised error, or a
  non-finite val loss) marks the trial ``failed`` without aborting the
  search;
* every trial is finalized exactly once; ``stats`` carries the full
  accounting (per-state counts, requeues, max observed concurrency,
  worker pids) so chaos legs can assert exactly-once.

With no ``ray_ctx`` the executor owns a private local spawn pool (a
``RayContext`` of ``max_concurrent`` workers on ``platform``: the card
unless the caller passes ``"cpu"``, where the JAX executor defaults to
the CPU); ``serial=True``
runs segments inline in the driver process — deterministic, for tests.
Checkpoints assume workers share the driver's filesystem (one host, or a
shared mount on a multi-host cluster).
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import tempfile
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import telemetry
from .scheduler import COMPLETE, PROMOTE, STOP, TrialScheduler

logger = logging.getLogger("analytics_zoo_tpu_torch.automl")


#: worker-local model cache: (ckpt_dir, trial_id) -> (forecaster,
#: progress token at our last save).  A promoted trial that lands on
#: the worker that ran its previous segment reuses the live model —
#: skipping the rebuild, the move to the device and the checkpoint
#: load.  The cached
#: entry is only trusted while the trial's ``progress.json`` sidecar
#: still carries the random token we wrote at save time; if another
#: worker committed an intermediate segment (requeue after a kill), its
#: save rolled the token and we fall back to the authoritative
#: checkpoint.  (A stat-based check would be fooled by same-size
#: checkpoints landing within one mtime granule on coarse filesystems.)
_MODEL_CACHE: Dict[tuple, tuple] = {}
_MODEL_CACHE_CAP = 32


def _progress_path(ckpt: str) -> str:
    return os.path.join(os.path.dirname(ckpt), "progress.json")


def _read_progress(ckpt: str) -> Optional[Dict]:
    """The trial's committed progress sidecar, or None if absent/torn."""
    import json

    try:
        with open(_progress_path(ckpt)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _write_progress(ckpt: str, epochs: int) -> str:
    """Atomically commit {cumulative epochs, fresh token}; returns the
    token (the model-cache validity key for this checkpoint state)."""
    import json
    import uuid

    token = uuid.uuid4().hex
    path = _progress_path(ckpt)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"epochs": int(epochs), "token": token}, fh)
    os.replace(tmp, path)
    return token


def run_trial_segment(trial_id: int, config: Dict, budget_epochs: int,
                      data: Tuple, ckpt_dir: Optional[str],
                      start_epochs: int = 0) -> Dict:
    """Train one forecaster segment (runs inside a worker process).

    Builds the config's forecaster (or reuses the worker's still-warm
    model from the trial's previous segment), resumes params from the
    trial's checkpoint when one exists, trains up to ``budget_epochs``
    more epochs, evaluates, and commits checkpoint + progress sidecar
    (both atomic renames) before returning — so a worker killed
    mid-segment leaves the previous commit intact and the segment can
    be requeued as-is.

    ``start_epochs`` is the cumulative epoch count the driver has
    accounted for this trial.  If the sidecar already records
    ``start_epochs + budget_epochs`` — the previous attempt committed
    its checkpoint but its worker died before the result reached the
    driver — the rerun trains 0 extra epochs (evaluate only), so a
    requeued trial never accrues epochs beyond its rung and its rung
    comparison against peers stays fair.
    """
    from .forecaster import build_forecaster

    x_train, y_train, x_val, y_val = data
    t0 = time.time()
    cfg = dict(config)
    batch_size = int(cfg.pop("batch_size", 32))
    cfg.pop("epochs", None)   # budgets come from the scheduler, not cfg
    with telemetry.span("automl/trial_segment", trial=trial_id,
                        epochs=int(budget_epochs)):
        ckpt = None if ckpt_dir is None else os.path.join(
            ckpt_dir, f"trial-{trial_id}", "weights.npz")
        target = int(start_epochs) + int(budget_epochs)
        progress = None
        f = None
        resumed = False
        cached = False
        if ckpt is not None and os.path.exists(ckpt):
            progress = _read_progress(ckpt)
            entry = _MODEL_CACHE.get((ckpt_dir, trial_id))
            if (entry is not None and progress is not None
                    and entry[1] is not None
                    and entry[1] == progress.get("token")):
                f = entry[0]
                resumed = cached = True
        if f is None:
            f = build_forecaster(lookback=x_train.shape[1],
                                 feature_dim=x_train.shape[2],
                                 horizon=y_train.shape[1], **cfg)
            if ckpt is not None and os.path.exists(ckpt):
                f.load_params(ckpt)
                resumed = True
        # epochs already committed on disk; a checkpoint without a
        # sidecar (or a fresh trial) is assumed exactly at start_epochs
        done = int(start_epochs)
        if resumed and progress is not None:
            done = int(progress.get("epochs", start_epochs))
        train_epochs = min(int(budget_epochs), max(0, target - done))
        if train_epochs:
            f.fit(x_train, y_train, batch_size=batch_size,
                  epochs=train_epochs)
        metrics = f.evaluate(x_val, y_val, batch_size=batch_size)
        loss = float(metrics["loss"] if isinstance(metrics, dict)
                     else metrics)
        if ckpt is not None and train_epochs:
            f.save_params(ckpt)
            token = _write_progress(ckpt, max(done, target))
            while len(_MODEL_CACHE) >= _MODEL_CACHE_CAP:
                _MODEL_CACHE.pop(next(iter(_MODEL_CACHE)))
            _MODEL_CACHE[(ckpt_dir, trial_id)] = (f, token)
    return {"trial_id": trial_id, "val_loss": loss,
            "epochs": train_epochs, "resumed": resumed,
            "cached": cached, "seconds": time.time() - t0,
            "pid": os.getpid()}


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


class _Trial:
    __slots__ = ("trial_id", "config", "state", "val_loss", "epochs",
                 "segments", "requeues", "seconds", "error", "pids",
                 "resumed_segments", "budget_done")

    def __init__(self, trial_id: int, config: Dict):
        self.trial_id = trial_id
        self.config = config
        self.state = "pending"    # pending|running|completed|stopped|failed
        self.val_loss: Optional[float] = None
        self.epochs = 0
        self.budget_done = 0      # cumulative budget of handled segments
        self.segments = 0
        self.requeues = 0
        self.seconds = 0.0
        self.error: Optional[str] = None
        self.pids: List[int] = []
        self.resumed_segments = 0

    def to_dict(self) -> Dict:
        return {"trial_id": self.trial_id, "config": self.config,
                "state": self.state, "val_loss": self.val_loss,
                "epochs": self.epochs, "segments": self.segments,
                "requeues": self.requeues,
                "resumed_segments": self.resumed_segments,
                "seconds": round(self.seconds, 3), "error": self.error,
                "pids": self.pids}


class AsyncTrialExecutor:
    """Drive a set of trial configs through a :class:`TrialScheduler`.

    Parameters
    ----------
    scheduler: the budget policy (``AshaScheduler``,
        ``RunToCompletionScheduler``, ...). Stateful; one per search.
    ray_ctx: an initialized RayContext to run segments on.  ``None`` →
        the executor owns a private pool of ``max_concurrent`` spawn
        workers on ``platform`` for the duration of ``run()``.
    max_concurrent: submission cap (and private-pool size).  With an
        external ``ray_ctx`` it defaults to the context's worker count.
    workdir: checkpoint root.  ``None`` → a private temp dir, removed
        after the search.
    trial_fn: segment function ``(trial_id, config, budget, data,
        ckpt_dir, start_epochs) -> {"val_loss": ..., ...}``; defaults
        to :func:`run_trial_segment`.  Swappable so chaos tests can run
        cheap stub segments.
    max_requeues: worker-loss requeue budget per trial (default 1 —
        "requeue exactly once").
    serial: run segments inline in the driver (deterministic tests).
    platform: the private pool's device (None: the card; ``"cpu"``).
    """

    def __init__(self, scheduler: TrialScheduler, ray_ctx=None,
                 max_concurrent: Optional[int] = None,
                 workdir: Optional[str] = None,
                 trial_fn: Optional[Callable] = None,
                 max_requeues: int = 1, serial: bool = False,
                 platform: Optional[str] = None):
        self.scheduler = scheduler
        self.ray_ctx = ray_ctx
        if max_concurrent is None:
            max_concurrent = getattr(ray_ctx, "num_workers", None) or 2
        self.max_concurrent = max(1, int(max_concurrent))
        self.workdir = workdir
        self.trial_fn = trial_fn or run_trial_segment
        self.max_requeues = int(max_requeues)
        self.serial = bool(serial)
        self.platform = platform
        self.trials: List[_Trial] = []
        self.stats: Dict = {}

    # ------------------------------------------------------------------
    def run(self, configs: Sequence[Dict], data: Tuple) -> List[Dict]:
        self.trials = [_Trial(i, dict(c)) for i, c in enumerate(configs)]
        self.stats = {"trials": len(self.trials), "segments": 0,
                      "requeued": 0, "max_concurrent": 0,
                      "worker_pids": set(), "epochs_trained": 0,
                      "finalized": 0, "cached_segments": 0}
        owns_workdir = self.workdir is None
        workdir = self.workdir or tempfile.mkdtemp(prefix="zoo-automl-")
        runnable: deque = deque(
            (t.trial_id, self.scheduler.initial_budget())
            for t in self.trials)
        try:
            with telemetry.span("automl/search", trials=len(self.trials),
                                mode="serial" if self.serial else "pool"):
                if self.serial:
                    self._run_serial(runnable, data, workdir)
                else:
                    self._run_pool(runnable, data, workdir)
        finally:
            if owns_workdir:
                shutil.rmtree(workdir, ignore_errors=True)
        # exactly-once: every trial reached a terminal state, once
        counts = {"completed": 0, "stopped": 0, "failed": 0}
        for t in self.trials:
            if t.state not in counts:
                raise RuntimeError(
                    f"trial {t.trial_id} ended in non-terminal state "
                    f"{t.state!r} — executor accounting bug")
            counts[t.state] += 1
        if self.stats["finalized"] != len(self.trials):
            raise RuntimeError(
                f"finalized {self.stats['finalized']} of "
                f"{len(self.trials)} trials — executor accounting bug")
        self.stats.update(counts)
        self.stats["worker_pids"] = sorted(self.stats["worker_pids"])
        self.stats["early_stopped_fraction"] = (
            counts["stopped"] / max(1, len(self.trials)))
        return [t.to_dict() for t in self.trials]

    # ------------------------------------------------------------------
    def _run_serial(self, runnable, data, workdir):
        while runnable:
            trial_id, budget = runnable.popleft()
            trial = self.trials[trial_id]
            trial.state = "running"
            self.stats["segments"] += 1
            self.stats["max_concurrent"] = max(
                self.stats["max_concurrent"], 1)
            try:
                result = self.trial_fn(trial_id, trial.config, budget,
                                       data, workdir, trial.budget_done)
            except Exception as e:  # noqa: BLE001 - record, keep going
                self._finalize(trial, "failed",
                               error=f"{type(e).__name__}: {e}")
                continue
            self._handle_result(trial, budget, result, runnable)

    def _run_pool(self, runnable, data, workdir):
        ctx = self.ray_ctx
        owns_ctx = ctx is None
        if owns_ctx:
            from ..ray import RayContext
            ctx = RayContext(num_ray_nodes=self.max_concurrent,
                             ray_node_cpu_cores=1,
                             platform=self.platform).init()
        from ..ray import RemoteTaskError, WorkerLostError

        inflight: Dict[str, tuple] = {}   # task_id -> (ref, tid, budget)
        try:
            while runnable or inflight:
                while runnable and len(inflight) < self.max_concurrent:
                    trial_id, budget = runnable.popleft()
                    trial = self.trials[trial_id]
                    trial.state = "running"
                    ref = ctx.remote(self.trial_fn).remote(
                        trial_id, trial.config, budget, data, workdir,
                        trial.budget_done)
                    inflight[ref.task_id] = (ref, trial_id, budget)
                    self.stats["segments"] += 1
                self.stats["max_concurrent"] = max(
                    self.stats["max_concurrent"], len(inflight))
                ready, _ = ctx.wait([e[0] for e in inflight.values()],
                                    num_returns=1)
                for ref in ready:
                    _, trial_id, budget = inflight.pop(ref.task_id)
                    trial = self.trials[trial_id]
                    try:
                        result = ctx.get(ref)
                    except WorkerLostError as e:
                        if trial.requeues < self.max_requeues:
                            # same trial, same budget, same start_epochs:
                            # the rerun resumes from the last committed
                            # checkpoint, and the progress sidecar caps
                            # it at the rung budget — if the dead worker
                            # committed before the result got out, the
                            # rerun skips straight to evaluate
                            trial.requeues += 1
                            self.stats["requeued"] += 1
                            telemetry.counter(
                                "zoo_automl_requeued_total").inc()
                            telemetry.event("automl/segment_requeued",
                                            trial=trial_id)
                            runnable.append((trial_id, budget))
                        else:
                            self._finalize(
                                trial, "failed",
                                error=f"worker lost twice: {e}")
                    except RemoteTaskError as e:
                        self._finalize(
                            trial, "failed",
                            error=str(e).splitlines()[0][:300])
                    else:
                        self._handle_result(trial, budget, result,
                                            runnable)
        finally:
            if owns_ctx:
                ctx.stop()

    # ------------------------------------------------------------------
    def _handle_result(self, trial: _Trial, budget: int, result: Dict,
                       runnable) -> None:
        trial.segments += 1
        trial.budget_done += int(budget)
        trial.epochs += int(result.get("epochs", budget))
        trial.seconds += float(result.get("seconds", 0.0))
        if result.get("resumed"):
            trial.resumed_segments += 1
        if result.get("cached"):
            self.stats["cached_segments"] += 1
        pid = result.get("pid")
        if pid is not None:
            trial.pids.append(pid)
            self.stats["worker_pids"].add(pid)
        self.stats["epochs_trained"] += int(result.get("epochs", budget))
        val = result.get("val_loss")
        if not _finite(val):
            # a diverged trial (NaN/Inf) must neither win the search nor
            # poison the rung cutoffs — failed, excluded from best
            self._finalize(trial, "failed",
                           error=f"non-finite val_loss: {val!r}")
            return
        trial.val_loss = float(val)   # latest rung = highest budget
        decision = self.scheduler.on_report(trial.trial_id, float(val))
        telemetry.counter("zoo_automl_rung_decisions_total",
                          decision=decision.action).inc()
        telemetry.event("automl/rung_report", trial=trial.trial_id,
                        rung=decision.rung, val_loss=float(val),
                        decision=decision.action)
        if decision.action == PROMOTE:
            runnable.append((trial.trial_id, decision.budget))
        elif decision.action == STOP:
            self._finalize(trial, "stopped")
        elif decision.action == COMPLETE:
            self._finalize(trial, "completed")
        else:
            raise RuntimeError(
                f"scheduler returned unknown action {decision.action!r}")

    def _finalize(self, trial: _Trial, state: str, error: str = None):
        if trial.state in ("completed", "stopped", "failed"):
            raise RuntimeError(
                f"trial {trial.trial_id} finalized twice "
                f"({trial.state} -> {state}) — executor accounting bug")
        trial.state = state
        trial.error = error
        self.stats["finalized"] += 1
        telemetry.counter("zoo_automl_trials_total", state=state).inc()
        if error:
            logger.warning("trial %d %s: %s", trial.trial_id, state,
                           error)
