"""AnomalyDetector: an LSTM forecaster and rank-based anomaly flagging.

Counterpart of ``analytics_zoo_tpu/models/anomalydetection/
anomaly_detector.py`` (parity: ``AnomalyDetector.scala`` /
``pyzoo/zoo/models/anomalydetection/anomaly_detector.py``): a
stacked-LSTM regressor over unrolled windows. ``unroll`` builds (window,
next value) pairs (AnomalyDetector.scala:160-200) and
``detect_anomalies`` flags the top ``anomaly_size`` percent of the
|truth - prediction| gaps (AnomalyDetector.scala:106-150); both are numpy,
copies of the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...pipeline.api.keras.layers import LSTM, Dense, Dropout, InputLayer
from ...pipeline.api.keras.models import Sequential
from ..common import ZooModel


@dataclass
class FeatureLabelIndex:
    """Parity: the ``FeatureLabelIndex`` case class
    (AnomalyDetector.scala:36)."""

    feature: np.ndarray  # (unroll_length, feature_size)
    label: float
    index: int


class AnomalyDetector(ZooModel):
    """* feature_shape: (unroll_length, feature_size) of the windows.
    * hidden_layers: units of the stacked LSTMs (default [8, 32, 15]).
    * dropouts: dropout rates, as many as hidden_layers.
    """

    def __init__(self, feature_shape, hidden_layers=(8, 32, 15),
                 dropouts=(0.2, 0.2, 0.2)):
        hidden_layers = [int(h) for h in hidden_layers]
        dropouts = [float(d) for d in dropouts]
        if len(hidden_layers) != len(dropouts):
            raise ValueError(
                "sizes of dropouts and hidden_layers should be equal")
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.hidden_layers = hidden_layers
        self.dropouts = dropouts
        self._record_config(feature_shape=list(self.feature_shape),
                            hidden_layers=hidden_layers, dropouts=dropouts)
        self.model = self.build_model()

    def build_model(self):
        model = Sequential()
        model.add(InputLayer(input_shape=self.feature_shape))
        model.add(LSTM(self.hidden_layers[0], return_sequences=True))
        for units, rate in zip(self.hidden_layers[1:-1], self.dropouts[1:-1]):
            model.add(LSTM(units, return_sequences=True))
            model.add(Dropout(rate))
        model.add(LSTM(self.hidden_layers[-1], return_sequences=False))
        model.add(Dropout(self.dropouts[-1]))
        model.add(Dense(1))
        return model

    @staticmethod
    def unroll(data, unroll_length: int, predict_step: int = 1):
        """(features (m, unroll_length, feature_size), labels (m,),
        indices (m,)) of ``data`` ((n,) or (n, feature_size)): window i
        covers ``data[i : i + unroll_length]`` and its label is the first
        feature of ``data[i + unroll_length - 1 + predict_step]``."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = data.shape[0]
        m = n - unroll_length - predict_step + 1
        if m <= 0:
            return (np.zeros((0, unroll_length, data.shape[1]), np.float32),
                    np.zeros((0,), np.float32), np.zeros((0,), np.int64))
        idx = np.arange(m)[:, None] + np.arange(unroll_length)[None, :]
        features = data[idx]
        labels = data[np.arange(m) + unroll_length - 1 + predict_step, 0]
        return features, labels, np.arange(m)

    @staticmethod
    def detect_anomalies(y_truth, y_predict, anomaly_size: int = 5):
        """Flag the top ``anomaly_size`` percent largest |truth - pred|
        gaps (at least one): (truth, predict, anomaly), anomaly[i] the
        truth at a flagged point and NaN elsewhere (the reference's
        ``null``)."""
        y_truth = np.asarray(y_truth, np.float32).reshape(-1)
        y_predict = np.asarray(y_predict, np.float32).reshape(-1)
        if y_truth.shape != y_predict.shape:
            raise ValueError("length of predictions and truth should match")
        diffs = np.abs(y_truth - y_predict)
        k = max(int(len(y_truth) * anomaly_size / 100.0), 1)
        threshold = np.sort(diffs)[::-1][:k].min()
        return AnomalyDetector.detect_anomalies_by_threshold(
            y_truth, y_predict, float(threshold))

    @staticmethod
    def detect_anomalies_by_threshold(y_truth, y_predict, threshold: float):
        """Parity: detectAnomalies(threshold)
        (AnomalyDetector.scala:136-150), a strict ``>``."""
        y_truth = np.asarray(y_truth, np.float32).reshape(-1)
        y_predict = np.asarray(y_predict, np.float32).reshape(-1)
        diffs = np.abs(y_truth - y_predict)
        anomaly = np.where(diffs > threshold, y_truth, np.nan)
        return y_truth, y_predict, anomaly
