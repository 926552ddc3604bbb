"""BERTClassifier (counterpart of ``analytics_zoo_tpu/tfpark/text/
estimator/bert_classifier.py``; parity: pyzoo/zoo/tfpark/text/estimator/
bert_classifier.py): pooled BERT output → dropout-free softmax head over
``num_classes``."""

from __future__ import annotations

from ....pipeline.api.keras.layers import Dense
from .bert_base import BERTBaseEstimator


class BERTClassifier(BERTBaseEstimator):
    def __init__(self, num_classes: int, optimizer="adam", **kwargs):
        self.num_classes = num_classes
        super().__init__(
            head_fn=lambda seq, pooled: Dense(
                num_classes, activation="softmax")(pooled),
            loss="sparse_categorical_crossentropy",
            optimizer=optimizer, **kwargs)
