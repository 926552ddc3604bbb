"""Trigger algebra for training control.

A copy of ``analytics_zoo_tpu/common/zoo_trigger.py`` (it has no jax in
it; the port keeps its own copy so that it never imports the JAX
package). Parity surface: ``zoo/.../common/ZooTrigger.scala:26-60``
(EveryEpoch, SeveralIteration, MaxEpoch, MaxIteration, MinLoss, MaxScore,
And/Or). Triggers fire on a :class:`TrainRecord` snapshot held by the
host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainRecord:
    epoch: int = 0            # completed epochs
    iteration: int = 0        # completed iterations (global)
    epoch_finished: bool = False
    loss: float = float("inf")
    score: Optional[float] = None


class ZooTrigger:
    def __call__(self, record: TrainRecord) -> bool:
        raise NotImplementedError

    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)


class EveryEpoch(ZooTrigger):
    def __call__(self, record):
        return record.epoch_finished


class SeveralIteration(ZooTrigger):
    def __init__(self, interval: int):
        self.interval = int(interval)

    def __call__(self, record):
        return record.iteration > 0 and record.iteration % self.interval == 0


class MaxEpoch(ZooTrigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, record):
        return record.epoch >= self.max_epoch


class MaxIteration(ZooTrigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def __call__(self, record):
        return record.iteration >= self.max_iteration


class MinLoss(ZooTrigger):
    def __init__(self, min_loss: float):
        self.min_loss = float(min_loss)

    def __call__(self, record):
        return record.loss < self.min_loss


class MaxScore(ZooTrigger):
    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def __call__(self, record):
        return record.score is not None and record.score > self.max_score


class And(ZooTrigger):
    def __init__(self, first: ZooTrigger, *others: ZooTrigger):
        self.triggers = (first,) + others

    def __call__(self, record):
        return all(t(record) for t in self.triggers)


class Or(ZooTrigger):
    def __init__(self, first: ZooTrigger, *others: ZooTrigger):
        self.triggers = (first,) + others

    def __call__(self, record):
        return any(t(record) for t in self.triggers)
