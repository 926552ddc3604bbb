"""BERTNER (counterpart of ``analytics_zoo_tpu/tfpark/text/estimator/
bert_ner.py``; parity: pyzoo/zoo/tfpark/text/estimator/bert_ner.py):
per-token entity softmax over the BERT sequence output."""

from __future__ import annotations

from ....pipeline.api.keras.layers import Dense
from .bert_base import BERTBaseEstimator


class BERTNER(BERTBaseEstimator):
    def __init__(self, num_entities: int, optimizer="adam", **kwargs):
        self.num_entities = num_entities
        super().__init__(
            head_fn=lambda seq, pooled: Dense(
                num_entities, activation="softmax")(seq),
            loss="sparse_categorical_crossentropy",
            optimizer=optimizer, **kwargs)
