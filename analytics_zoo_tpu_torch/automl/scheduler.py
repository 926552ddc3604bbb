"""Trial schedulers: the promote-or-stop policy half of distributed AutoML.

Counterpart of ``analytics_zoo_tpu/automl/scheduler.py``.

The reference platform ran its forecaster search through Ray Tune, whose
trial schedulers separate *policy* (how long does a trial deserve to run)
from *execution* (where does it run).  This module rebuilds that seam:

* :class:`TrialScheduler` — the protocol.  A scheduler owns no processes
  and trains nothing; it is asked for a trial's first epoch budget and is
  told each validation result, answering with a :class:`Decision`.
* :class:`AshaScheduler` — asynchronous successive halving (ASHA; Li et
  al., MLSys 2020).  Rungs sit at cumulative budgets ``min_epochs·η^k``;
  a trial reaching a rung reports its val loss and is promoted iff it
  ranks in the top ``1/η`` of the results *recorded at that rung so far*
  — no synchronization barrier, so early reporters promote optimistically
  and the worker pool never idles waiting for a bracket to fill.
* :class:`RunToCompletionScheduler` — the degenerate policy (every trial
  gets its full budget up front, one rung, always complete) so
  random/grid-to-completion stays expressible through the same executor.

Policies here are pure and single-threaded: the executor
(:mod:`analytics_zoo_tpu_torch.automl.executor`) serializes calls into them.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

#: Decision actions.
PROMOTE = "promote"    # run the trial for ``budget`` more epochs
STOP = "stop"          # early-stop: rank at the rung did not make the cut
COMPLETE = "complete"  # trial reached the top rung — done, keep result


class Decision:
    """What to do with a trial after it reported at a rung boundary."""

    __slots__ = ("action", "budget", "rung")

    def __init__(self, action: str, budget: int = 0, rung: int = 0):
        self.action = action
        self.budget = int(budget)   # additional epochs (promote only)
        self.rung = int(rung)       # rung index the report landed on

    def __repr__(self):
        return f"Decision({self.action}, budget={self.budget}, " \
               f"rung={self.rung})"


class TrialScheduler:
    """Protocol: epoch-budget policy for one search.

    ``initial_budget()`` is the epochs a fresh trial runs before its
    first report; ``on_report(trial_id, val_loss)`` records the result
    at the trial's current rung and returns a :class:`Decision`.  A
    scheduler instance is stateful per-search and must not be reused.
    """

    def initial_budget(self) -> int:
        raise NotImplementedError

    def on_report(self, trial_id, val_loss: float) -> Decision:
        raise NotImplementedError

    def rungs(self) -> List[int]:
        """Cumulative epoch budgets per rung (diagnostics/telemetry)."""
        raise NotImplementedError


class RunToCompletionScheduler(TrialScheduler):
    """Every trial trains its full budget, then completes (random/grid)."""

    def __init__(self, max_epochs: int):
        if max_epochs < 1:
            raise ValueError(f"max_epochs must be >= 1, got {max_epochs}")
        self.max_epochs = int(max_epochs)

    def initial_budget(self) -> int:
        return self.max_epochs

    def on_report(self, trial_id, val_loss: float) -> Decision:
        return Decision(COMPLETE, 0, 0)

    def rungs(self) -> List[int]:
        return [self.max_epochs]


class AshaScheduler(TrialScheduler):
    """Asynchronous successive halving over epoch rungs.

    Rungs are the cumulative budgets ``min_epochs * η^k`` clipped to
    ``max_epochs`` (e.g. ``min=1, η=3, max=9`` → rungs ``[1, 3, 9]``).
    On a report at rung ``k`` the value is recorded into that rung's
    history and the trial is promoted iff its rank is within
    ``max(1, n/η)`` of the ``n`` results recorded there so far (lower
    val loss = better).  The ``max(1, ...)`` floor is the standard async
    relaxation: the first reporter at a rung always promotes, so the
    search never deadlocks waiting for a full bracket — the price is a
    few optimistic promotions early on, exactly ASHA's trade.

    Non-finite values are never recorded (a diverged trial must not
    poison the cutoff) and always answer STOP.
    """

    def __init__(self, max_epochs: int, min_epochs: int = 1,
                 reduction_factor: int = 3):
        if min_epochs < 1:
            raise ValueError(f"min_epochs must be >= 1, got {min_epochs}")
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2, got "
                             f"{reduction_factor}")
        if max_epochs < min_epochs:
            raise ValueError(f"max_epochs ({max_epochs}) < min_epochs "
                             f"({min_epochs})")
        self.eta = int(reduction_factor)
        self.min_epochs = int(min_epochs)
        self.max_epochs = int(max_epochs)
        self._rungs: List[int] = []
        budget = self.min_epochs
        while budget < self.max_epochs:
            self._rungs.append(budget)
            budget *= self.eta
        self._rungs.append(self.max_epochs)
        # recorded (finite) results per rung, kept sorted for rank lookup
        self._results: List[List[float]] = [[] for _ in self._rungs]
        self._trial_rung: Dict[object, int] = {}

    def rungs(self) -> List[int]:
        return list(self._rungs)

    def initial_budget(self) -> int:
        return self._rungs[0]

    def cutoff(self, rung: int) -> Optional[float]:
        """Largest value that would still promote at ``rung`` right now
        (None while the rung is empty — the next reporter promotes)."""
        recorded = self._results[rung]
        if not recorded:
            return None
        keep = max(1, len(recorded) // self.eta)
        return recorded[keep - 1]

    def on_report(self, trial_id, val_loss: float) -> Decision:
        rung = self._trial_rung.get(trial_id, 0)
        val_loss = float(val_loss)
        if val_loss != val_loss or val_loss in (float("inf"),
                                                float("-inf")):
            return Decision(STOP, 0, rung)
        recorded = self._results[rung]
        bisect.insort(recorded, val_loss)
        if rung == len(self._rungs) - 1:
            return Decision(COMPLETE, 0, rung)
        # keep-top-1/η over what this rung has seen SO FAR (async: no
        # waiting for the other trials to arrive at the rung)
        keep = max(1, len(recorded) // self.eta)
        rank = bisect.bisect_left(recorded, val_loss)
        if rank < keep:
            self._trial_rung[trial_id] = rung + 1
            return Decision(PROMOTE,
                            self._rungs[rung + 1] - self._rungs[rung],
                            rung)
        return Decision(STOP, 0, rung)
