"""Streaming SLO engine: declarative objectives + burn-rate alerts.

A copy of ``analytics_zoo_tpu/utils/slo.py`` (standard library and the
port's ``utils/telemetry.py``); the port's Cluster Serving loop feeds it.

ROADMAP item 2(d) owes serving a sustained-qps soak gate ("p99 <= X at
Y qps for Z minutes, shed fraction bounded").  This module is the
machinery that computes it live (docs/observability.md#slo):

- **Objectives** are declarative good/bad classifications of the request
  stream with a target good-fraction.  ``p99_ms: X`` means "99% of
  requests finish within X ms" (good = latency <= X, target 0.99);
  ``error_rate: e`` and ``shed_fraction: s`` mean "at most that
  fraction of requests errors / is shed" (target = 1 - bound).
- **Burn rate** is the Google-SRE multi-window form: over a window,
  ``bad_fraction / error_budget`` where the budget is ``1 - target``.
  A burn rate of 1.0 consumes the budget exactly at the sustainable
  pace; an alert fires only when the burn exceeds ``burn_threshold``
  over *both* the fast and the slow window — the fast window gives
  detection latency, the slow window immunity to blips.
- **Alerts are edge-triggered**: one typed event per transition into
  violation (latched until the windows clear), so a steady-state
  healthy service emits *zero* alert events — the soak gate's
  false-alert criterion is literal, not statistical.

Every evaluation publishes ``zoo_slo_burn_rate`` /
``zoo_slo_budget_remaining`` gauges into the metrics registry and each
fired alert lands as a ``slo/alert`` instant event (flight recorder +
trace) plus a ``zoo_slo_alerts_total`` counter — so an SLO breach is
visible in `zoo-serving top`, the Prometheus scrape, and the post-mortem
flight dump through the same spine.

Stdlib-only (like telemetry.py) so serving workers pay no import tax.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import telemetry

__all__ = ["Objective", "SloEngine", "parse_slo_config",
           "SloClass", "parse_slo_class_config", "match_slo_class",
           "DEFAULT_FAST_WINDOW_S", "DEFAULT_SLOW_WINDOW_S",
           "DEFAULT_BURN_THRESHOLD"]

DEFAULT_FAST_WINDOW_S = 10.0
DEFAULT_SLOW_WINDOW_S = 60.0
DEFAULT_BURN_THRESHOLD = 2.0

#: objective kinds -> how a request is classified bad
KIND_LATENCY = ("p50_ms", "p90_ms", "p95_ms", "p99_ms")
KIND_RATE = ("error_rate", "shed_fraction")


@dataclass
class Objective:
    """One declarative objective over the request stream.

    ``kind`` is one of ``p50_ms``/``p90_ms``/``p95_ms``/``p99_ms``
    (bound is a latency in ms, target comes from the percentile) or
    ``error_rate``/``shed_fraction`` (bound is the tolerated bad
    fraction, target = 1 - bound)."""

    name: str
    kind: str
    bound: float
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    burn_threshold: float = DEFAULT_BURN_THRESHOLD
    target: float = field(init=False)

    def __post_init__(self):
        if self.kind in KIND_LATENCY:
            pct = float(self.kind[1:-3])          # "p99_ms" -> 99
            self.target = pct / 100.0
        elif self.kind in KIND_RATE:
            if not 0.0 < self.bound < 1.0:
                raise ValueError(
                    f"{self.name}: {self.kind} bound must be in (0,1), "
                    f"got {self.bound}")
            self.target = 1.0 - float(self.bound)
        else:
            raise ValueError(f"{self.name}: unknown objective kind "
                             f"{self.kind!r} (want one of "
                             f"{KIND_LATENCY + KIND_RATE})")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"{self.name}: target {self.target} out of "
                             f"(0,1)")

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def is_bad(self, latency_ms: Optional[float], error: bool,
               shed: bool) -> bool:
        if self.kind == "error_rate":
            return error
        if self.kind == "shed_fraction":
            return shed
        # latency objectives: sheds/errors never produced a latency —
        # count them bad too (a shed request did not meet its latency)
        if latency_ms is None:
            return error or shed
        return latency_ms > self.bound


def parse_slo_config(cfg: Optional[dict]) -> List[Objective]:
    """Build objectives from the serving config's ``slo:`` section::

        slo:
          fast_window_s: 10      # optional, per-section defaults
          slow_window_s: 60
          burn_threshold: 2.0
          objectives:
            - name: latency
              p99_ms: 250
            - name: sheds
              shed_fraction: 0.05

    Each objective entry is a ``name`` plus exactly one kind key; the
    window/threshold knobs may also be set per objective."""
    if not cfg:
        return []
    fast = float(cfg.get("fast_window_s") or DEFAULT_FAST_WINDOW_S)
    slow = float(cfg.get("slow_window_s") or DEFAULT_SLOW_WINDOW_S)
    burn = float(cfg.get("burn_threshold") or DEFAULT_BURN_THRESHOLD)
    out: List[Objective] = []
    for i, entry in enumerate(cfg.get("objectives") or []):
        kinds = [k for k in entry if k in KIND_LATENCY + KIND_RATE]
        if len(kinds) != 1:
            raise ValueError(
                f"slo objective #{i} needs exactly one kind key "
                f"({KIND_LATENCY + KIND_RATE}), got {sorted(entry)}")
        kind = kinds[0]
        out.append(Objective(
            name=str(entry.get("name") or kind),
            kind=kind, bound=float(entry[kind]),
            fast_window_s=float(entry.get("fast_window_s") or fast),
            slow_window_s=float(entry.get("slow_window_s") or slow),
            burn_threshold=float(entry.get("burn_threshold") or burn)))
    return out


@dataclass
class SloClass:
    """A named tenant: an SLO class bound to (model, version) with a
    fair-share weight and a shed priority (docs/multi-tenancy.md).

    - ``weight`` is the deficit-round-robin share of intake capacity
      (a weight-3 class drains 3 records for every 1 a weight-1 class
      does while both have backlog);
    - ``priority`` orders sheds under pressure — LOWER is more
      important, so the highest-priority-number class sheds first;
    - ``shed_wait_ms`` is the predicted-wait bound above which this
      class's queued records are shed (defaults to the tightest
      latency-objective bound, since queueing past it makes the
      objective unmeetable);
    - ``model``/``version`` bind traffic: exact (model, version) beats
      model-only beats the catch-all (``model: None``)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    model: Optional[str] = None
    version: Optional[str] = None
    shed_wait_ms: Optional[float] = None
    objectives: List[Objective] = field(default_factory=list)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"slo class {self.name}: weight must be "
                             f"> 0, got {self.weight}")
        if self.shed_wait_ms is None:
            bounds = [o.bound for o in self.objectives
                      if o.kind in KIND_LATENCY]
            self.shed_wait_ms = min(bounds) if bounds else None


def parse_slo_class_config(cfg: Optional[dict]) -> List[SloClass]:
    """Build tenant classes from the ``slo:`` section's ``classes:``::

        slo:
          classes:
            - name: premium
              model: resnet50        # omit for a catch-all class
              version: "2"           # optional; omit to match any
              weight: 3              # DRR fair share (default 1)
              priority: 0            # lower sheds LAST (default 0)
              shed_wait_ms: 250      # default: tightest latency bound
              objectives:
                - name: latency
                  p99_ms: 250

    Per-class objectives inherit the section-level window/threshold
    defaults exactly like the top-level ``objectives:`` list."""
    if not cfg:
        return []
    out: List[SloClass] = []
    seen = set()
    for i, entry in enumerate(cfg.get("classes") or []):
        name = str(entry.get("name") or f"class-{i}")
        if name in seen:
            raise ValueError(f"duplicate slo class name {name!r}")
        seen.add(name)
        objectives = parse_slo_config(
            {**{k: cfg.get(k) for k in ("fast_window_s", "slow_window_s",
                                        "burn_threshold")},
             "objectives": entry.get("objectives") or []})
        model = entry.get("model")
        version = entry.get("version")
        shed_wait = entry.get("shed_wait_ms")
        out.append(SloClass(
            name=name,
            weight=float(entry.get("weight", 1.0)),
            priority=int(entry.get("priority", 0)),
            model=None if model is None else str(model),
            version=None if version is None else str(version),
            shed_wait_ms=None if shed_wait is None else float(shed_wait),
            objectives=objectives))
    return out


def match_slo_class(classes: Sequence[SloClass], model: Optional[str],
                    version: Optional[str]) -> Optional[SloClass]:
    """Most-specific class for a request: exact (model, version) >
    model-only > catch-all (``model: None``); None if nothing binds."""
    best: Optional[SloClass] = None
    best_rank = -1
    for cls in classes:
        if cls.model is None:
            rank = 0
        elif cls.model == model:
            if cls.version is None:
                rank = 1
            elif cls.version == version:
                rank = 2
            else:
                continue
        else:
            continue
        if rank > best_rank:
            best, best_rank = cls, rank
    return best


class _ObjectiveState:
    __slots__ = ("obj", "alerting", "alerts_fired")

    def __init__(self, obj: Objective):
        self.obj = obj
        self.alerting = False
        self.alerts_fired = 0


class SloEngine:
    """Multi-window error-budget burn-rate evaluation over a live
    request stream.

    ``record()`` is called once per finished request (from the serving
    writer / shed / dead-letter paths); ``evaluate()`` runs periodically
    (the stats-dump loop) and returns the alerts that *fired* on this
    pass.  ``status()`` is the JSON-ready view `zoo-serving top` and the
    soak bench leg render."""

    def __init__(self, objectives: Sequence[Objective],
                 service: str = "", max_events: int = 65536):
        self.objectives = list(objectives)
        self.service = service
        # one shared stream: (ts, latency_ms_or_None, error, shed)
        self._events: deque = deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self._states = [_ObjectiveState(o) for o in self.objectives]

    # -- ingest ---------------------------------------------------------
    def record(self, latency_ms: Optional[float] = None,
               error: bool = False, shed: bool = False,
               ts: Optional[float] = None):
        self._events.append((ts if ts is not None else time.time(),
                             latency_ms, bool(error), bool(shed)))

    # -- evaluation -----------------------------------------------------
    def _window_bad_fraction(self, obj: Objective, window_s: float,
                             now: float, events: Sequence[tuple]
                             ) -> Tuple[float, int]:
        lo = now - window_s
        total = bad = 0
        for ts, lat, err, shd in reversed(events):
            if ts < lo:
                break
            total += 1
            if obj.is_bad(lat, err, shd):
                bad += 1
        return (bad / total if total else 0.0), total

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass: publish gauges, fire edge-triggered
        alerts, return the alert dicts fired on *this* pass."""
        now = now if now is not None else time.time()
        with self._lock:
            events = list(self._events)
        fired: List[dict] = []
        for st in self._states:
            obj = st.obj
            bad_fast, n_fast = self._window_bad_fraction(
                obj, obj.fast_window_s, now, events)
            bad_slow, n_slow = self._window_bad_fraction(
                obj, obj.slow_window_s, now, events)
            burn_fast = bad_fast / obj.budget
            burn_slow = bad_slow / obj.budget
            budget_remaining = max(0.0, 1.0 - burn_slow)
            telemetry.gauge("zoo_slo_burn_rate", objective=obj.name,
                            window="fast").set(burn_fast)
            telemetry.gauge("zoo_slo_burn_rate", objective=obj.name,
                            window="slow").set(burn_slow)
            telemetry.gauge("zoo_slo_budget_remaining",
                            objective=obj.name).set(budget_remaining)
            violating = (n_fast > 0 and n_slow > 0 and
                         burn_fast > obj.burn_threshold and
                         burn_slow > obj.burn_threshold)
            if violating and not st.alerting:
                st.alerting = True
                st.alerts_fired += 1
                alert = {"objective": obj.name, "kind": obj.kind,
                         "bound": obj.bound,
                         "burn_fast": round(burn_fast, 4),
                         "burn_slow": round(burn_slow, 4),
                         "bad_fast": round(bad_fast, 4),
                         "bad_slow": round(bad_slow, 4),
                         "n_fast": n_fast, "n_slow": n_slow,
                         "ts": now}
                fired.append(alert)
                telemetry.counter("zoo_slo_alerts_total",
                                  objective=obj.name).inc()
                telemetry.event("slo/alert", **alert)
            elif not violating and st.alerting:
                st.alerting = False
                telemetry.event("slo/alert_cleared", objective=obj.name,
                                burn_fast=round(burn_fast, 4),
                                burn_slow=round(burn_slow, 4))
        return fired

    # -- reporting ------------------------------------------------------
    def status(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-objective burn/budget/alert view (computed fresh, no
        side effects — safe from any thread)."""
        now = now if now is not None else time.time()
        with self._lock:
            events = list(self._events)
        out: Dict[str, dict] = {}
        for st in self._states:
            obj = st.obj
            bad_fast, n_fast = self._window_bad_fraction(
                obj, obj.fast_window_s, now, events)
            bad_slow, n_slow = self._window_bad_fraction(
                obj, obj.slow_window_s, now, events)
            burn_slow = bad_slow / obj.budget
            out[obj.name] = {
                "kind": obj.kind, "bound": obj.bound,
                "target": round(obj.target, 6),
                "burn_fast": round(bad_fast / obj.budget, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_remaining": round(max(0.0, 1.0 - burn_slow), 4),
                "n_fast": n_fast, "n_slow": n_slow,
                "alerting": st.alerting,
                "alerts_fired": st.alerts_fired,
            }
        return out

    def total_alerts(self) -> int:
        return sum(st.alerts_fired for st in self._states)
