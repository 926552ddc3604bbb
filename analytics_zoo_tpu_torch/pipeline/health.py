"""Training health monitor.

A copy of ``analytics_zoo_tpu/pipeline/health.py`` over the port's
``utils/telemetry.py`` and ``utils/profiling.EwmaStd``. The port's
sentinel stays on the device as the first bad step's index and is read
at each logging window, at epoch end and before every checkpoint save
(``engine.SPMDTrainer._read_sentinel``), not after every step; the
monitor's ladder is the same.

The serving path got the full observability treatment (telemetry spine,
tracing, SLO burn rates); this is the training side: the two failure
modes that burn hours of accelerator time before a human looks are
silent divergence (a NaN/Inf step poisons the params and every step
after it is wasted) and slow drift (loss/grad-norm/step-time spikes).

:class:`HealthMonitor` sits on the :class:`~.engine.SPMDTrainer` step
path:

* **On-device NaN/Inf sentinels** — ``_step_body`` folds
  ``isfinite(loss)`` (and the grad norm, when L2-norm clipping already
  computed it — never an extra global reduce unless
  ``ZooConfig.health_grad_sentinel`` opts in) into ONE boolean scalar
  per step; the fused k-step scan reduces k of them to the index of the
  first bad step, so the host fetches one tiny scalar per dispatch and
  still pins the exact step.
* **EWMA z-score spike detection** — per logging window, loss /
  grad-norm / step-time are scored against exponential moving moments
  (:class:`~..utils.profiling.EwmaStd`); ``|z| >
  ZooConfig.health_z_threshold`` after the warmup raises a latched
  WARN.
* **Typed escalation ladder** — every alert is latched (single-fire per
  kind+signal): ``health/...`` telemetry event → flight-recorder dump →
  for non-finite values with ``ZooConfig.health_halt`` on, a
  checkpoint-and-halt through the existing
  :func:`~.engine.request_preemption` drain.  The epoch loop suppresses
  the drain's final checkpoint when the halt came from the monitor —
  the live params are poisoned; ``latest`` must keep pointing at the
  last good step — and raises :class:`~.engine.TrainingHalted`.

State is exported as the ``zoo_train_health_state`` gauge
(0 ok / 1 warn / 2 fault / 3 halted) so ``zoo-train top`` and
Prometheus see it live.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import telemetry
from ..utils.profiling import EwmaStd

logger = logging.getLogger("analytics_zoo_tpu_torch.health")

# zoo_train_health_state gauge values
STATE_OK = 0
STATE_WARN = 1        # latched spike (training continues)
STATE_FAULT = 2       # latched non-finite (training continues, poisoned)
STATE_HALTED = 3      # non-finite + health_halt: drain requested

_STATE_NAMES = {STATE_OK: "ok", STATE_WARN: "warn", STATE_FAULT: "fault",
                STATE_HALTED: "halted"}


class HealthMonitor:
    """Latched health state for one training run. Not shared across
    trainers; the engine builds one per ``train()`` when
    ``ZooConfig.health_monitor`` is on."""

    def __init__(self, z_threshold: float = 6.0, warmup_windows: int = 5,
                 halt: bool = False, alpha: float = 0.25):
        self.z_threshold = float(z_threshold)
        self.halt = bool(halt)
        self.state = STATE_OK
        self.halted = False
        self.halt_step: Optional[int] = None
        self.alerts: List[Dict[str, Any]] = []
        self._latched: set = set()
        self._streak: Dict[str, int] = {}   # consecutive spike windows
        self._lock = threading.Lock()
        self._trackers = {
            "loss": EwmaStd(alpha=alpha, min_samples=warmup_windows),
            "grad_norm": EwmaStd(alpha=alpha, min_samples=warmup_windows),
            "step_time_ms": EwmaStd(alpha=alpha,
                                    min_samples=warmup_windows),
        }
        telemetry.gauge("zoo_train_health_state").set(STATE_OK)

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def on_nonfinite(self, step: int, signal: str = "loss") -> None:
        """A NaN/Inf sentinel fired: the value computed at ``step`` (the
        1-based count of completed steps) was non-finite."""
        self._escalate("nonfinite", signal, step,
                       detail=f"non-finite {signal} at step {step}")

    def observe_window(self, step: int, loss: Optional[float] = None,
                       grad_norm: Optional[float] = None,
                       step_time_ms: Optional[float] = None) -> None:
        """Host-side window observations (once per logging window): a
        non-finite check on the fetched scalars (catches runs with the
        on-device sentinel path disabled) plus EWMA z-score spikes."""
        for signal, value in (("loss", loss), ("grad_norm", grad_norm),
                              ("step_time_ms", step_time_ms)):
            if value is None:
                continue
            value = float(value)
            if not math.isfinite(value):
                self.on_nonfinite(step, signal=signal)
                continue
            tracker = self._trackers[signal]
            z = tracker.zscore(value)
            if abs(z) > self.z_threshold:
                # step time is host-noisy (GC pause, checkpoint flush,
                # scheduler hiccup): one slow window is not a health
                # event — it must persist for two consecutive windows.
                # Loss/grad-norm are model signals: one window fires.
                streak = self._streak.get(signal, 0) + 1
                self._streak[signal] = streak
                if streak >= (2 if signal == "step_time_ms" else 1):
                    self._escalate("spike", signal, step,
                                   detail=f"{signal}={value:.6g} is "
                                          f"{z:+.1f} sigma from its "
                                          f"moving mean at step {step}",
                                   z=z)
                # an outlier must not drag the baseline it was scored
                # against — skip the update, the next clean window
                # resumes tracking
                continue
            self._streak[signal] = 0
            tracker.update(value)

    # ------------------------------------------------------------------
    # escalation ladder
    # ------------------------------------------------------------------
    def _escalate(self, kind: str, signal: str, step: int, detail: str,
                  z: Optional[float] = None) -> None:
        latch = (kind, signal)
        with self._lock:
            if latch in self._latched:
                return  # single-fire per kind+signal
            self._latched.add(latch)
            alert = {"kind": kind, "signal": signal, "step": int(step),
                     "detail": detail, "ts": time.time()}
            if z is not None:
                alert["z"] = float(z)
            self.alerts.append(alert)
            severity = STATE_FAULT if kind == "nonfinite" else STATE_WARN
            will_halt = kind == "nonfinite" and self.halt and \
                not self.halted
            if will_halt:
                severity = STATE_HALTED
                self.halted = True
                self.halt_step = int(step)
            self.state = max(self.state, severity)
        # ladder rung 1: latched, typed event + metrics
        telemetry.counter("zoo_train_health_alerts_total",
                          kind=kind, signal=signal).inc()
        telemetry.gauge("zoo_train_health_state").set(self.state)
        telemetry.event("health/alert", kind=kind, signal=signal,
                        step=step, detail=detail)
        logger.error("health %s (%s): %s", kind, signal, detail)
        # ladder rung 2: flight-recorder dump (last-N spans + metrics)
        telemetry.dump_flight(f"health {kind} ({signal}): {detail}")
        # ladder rung 3: checkpoint-and-halt through the preemption drain
        if will_halt:
            from . import engine
            telemetry.event("health/halt", step=step, signal=signal)
            logger.error("health halt: requesting training drain at step "
                         "%d (last good checkpoint is preserved)", step)
            engine.request_preemption()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def state_name(self) -> str:
        return _STATE_NAMES.get(self.state, str(self.state))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state_name, "halted": self.halted,
                    "halt_step": self.halt_step,
                    "alerts": [dict(a) for a in self.alerts]}
