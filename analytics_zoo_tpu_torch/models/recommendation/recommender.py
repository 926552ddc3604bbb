"""Recommender base + user/item record types.

Counterpart of ``analytics_zoo_tpu/models/recommendation/recommender.py``
(parity: ``pyzoo/zoo/models/recommendation/recommender.py``: UserItemFeature,
UserItemPrediction, Recommender.predict_user_item_pair /
recommend_for_user / recommend_for_item), a copy over the port's imports.
RDDs become plain python sequences / numpy arrays; batching and device
placement are the trainer's (``SPMDTrainer.predict``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence

import numpy as np

from ..common import ZooModel
from ...feature.feature_set import FeatureSet, Sample


class UserItemFeature:
    """One (user, item, sample) record."""

    def __init__(self, user_id, item_id, sample: Sample):
        self.user_id = int(user_id)
        self.item_id = int(item_id)
        self.sample = sample

    def __repr__(self):
        return (f"UserItemFeature [user_id: {self.user_id}, "
                f"item_id: {self.item_id}]")


class UserItemPrediction:
    def __init__(self, user_id, item_id, prediction, probability):
        self.user_id = int(user_id)
        self.item_id = int(item_id)
        self.prediction = int(prediction)
        self.probability = float(probability)

    def __repr__(self):
        return (f"UserItemPrediction [user_id: {self.user_id}, item_id: "
                f"{self.item_id}, prediction: {self.prediction}, "
                f"probability: {self.probability}]")


class Recommender(ZooModel):
    """Base class for recommendation models."""

    def _predict_features(self, features: Sequence[UserItemFeature],
                          batch_size=1024):
        samples = [f.sample for f in features]
        fs = FeatureSet.samples(samples)
        # strip labels: predict on features only
        probs = self.model.predict(
            fs.features if len(fs.features) > 1 else fs.features[0],
            batch_size=batch_size)
        return np.asarray(probs)

    def predict_user_item_pair(self, features: Sequence[UserItemFeature],
                               batch_size=1024) -> List[UserItemPrediction]:
        """Predicted class + probability per (user, item) pair. Classes are
        1-based like the reference (BigDL convention)."""
        probs = self._predict_features(features, batch_size)
        preds = probs.argmax(axis=-1)
        return [UserItemPrediction(f.user_id, f.item_id, int(c) + 1,
                                   float(p[c]))
                for f, c, p in zip(features, preds, probs)]

    def recommend_for_user(self, features: Sequence[UserItemFeature],
                           max_items: int) -> List[UserItemPrediction]:
        """Top-N items per user ranked by P(max class)."""
        predictions = self.predict_user_item_pair(features)
        by_user = defaultdict(list)
        for p in predictions:
            by_user[p.user_id].append(p)
        out = []
        for user, preds in by_user.items():
            preds.sort(key=lambda p: -p.probability)
            out.extend(preds[:max_items])
        return out

    def recommend_for_item(self, features: Sequence[UserItemFeature],
                           max_users: int) -> List[UserItemPrediction]:
        predictions = self.predict_user_item_pair(features)
        by_item = defaultdict(list)
        for p in predictions:
            by_item[p.item_id].append(p)
        out = []
        for item, preds in by_item.items():
            preds.sort(key=lambda p: -p.probability)
            out.extend(preds[:max_users])
        return out
