"""LocalEstimator: single-host training from raw arrays.

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/local_estimator.py``
(parity: ``LocalEstimator.scala:39-260``, the reference's dev-mode
trainer with a thread pool a core). Here the "local" path is the port's
:class:`SPMDTrainer` on the context's device over the model's own
parameters; the class accepts raw arrays and runs epochs eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...common.zoo_trigger import MaxEpoch
from ...feature.feature_set import ArrayFeatureSet
from ..api.keras.metrics import get_metric
from ..api.keras.objectives import get_loss
from ..api.keras.optimizers import get_optimizer
from ..engine import SPMDTrainer


def _as_feature_set(data, labels):
    if isinstance(data, (np.ndarray, list, tuple)):
        return ArrayFeatureSet(data, labels)
    return data


class LocalEstimator:
    """``LocalEstimator(model, criterion, validation_methods, optim_method,
    thread_num)``; ``thread_num`` is accepted for parity and ignored."""

    def __init__(self, model, criterion, validation_methods=None,
                 optim_method="sgd", thread_num: Optional[int] = None):
        self.model = model
        self.criterion = get_loss(criterion)
        self.validation_methods = [get_metric(m, self.criterion)
                                   for m in (validation_methods or [])]
        self.optim_method = get_optimizer(optim_method)
        self.thread_num = thread_num
        model.graph_function()   # a Sequential builds its layers here
        self.trainer = SPMDTrainer(model, self.criterion, self.optim_method,
                                   metrics=self.validation_methods)

    def fit(self, train_data, train_labels=None, validation_data=None,
            validation_labels=None, epoch: int = 1, batch_size: int = 32):
        """Parity: LocalEstimator.fit (LocalEstimator.scala:89-135)."""
        train_set = _as_feature_set(train_data, train_labels)
        val_set = None if validation_data is None else \
            _as_feature_set(validation_data, validation_labels)
        self.trainer.train(train_set, batch_size=batch_size,
                           end_trigger=MaxEpoch(self.trainer.epoch + epoch),
                           validation_set=val_set)
        return self

    def validate(self, data, labels=None, batch_size: int = 32):
        return self.trainer.evaluate(_as_feature_set(data, labels),
                                     batch_size=batch_size)

    def predict(self, data, batch_size: int = 128):
        return self.trainer.predict(data, batch_size=batch_size)
