"""Time-series feature engineering for the AutoML forecasters.

Counterpart of ``analytics_zoo_tpu/automl/feature.py`` (a numpy-only
copy). The reference's AutoML lives on the off-tree ``automl`` branch (SURVEY.md
§2.8: capability target, spec from docs); its documented pipeline is
rolling-window featurization + scaling + searched model. These are the
window/scale primitives, numpy-only so they run in search workers before any
model is built.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rolling_window(series: np.ndarray, lookback: int, horizon: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Unroll a (T, F) series into supervised pairs.

    Returns ``x (N, lookback, F)`` and ``y (N, horizon)`` where the target
    is feature 0 over the next ``horizon`` steps.
    """
    series = np.asarray(series, np.float32)
    if series.ndim == 1:
        series = series[:, None]
    t = series.shape[0]
    n = t - lookback - horizon + 1
    if n <= 0:
        raise ValueError(
            f"series length {t} too short for lookback {lookback} + "
            f"horizon {horizon}")
    x = np.stack([series[i:i + lookback] for i in range(n)])
    y = np.stack([series[i + lookback:i + lookback + horizon, 0]
                  for i in range(n)])
    return x, y


def train_val_split(x: np.ndarray, y: np.ndarray, val_ratio: float = 0.1):
    """Chronological split (no shuffling across the time boundary)."""
    n_val = max(1, int(len(x) * val_ratio))
    return (x[:-n_val], y[:-n_val]), (x[-n_val:], y[-n_val:])


class Scaler:
    """Per-feature standard scaler (fit on train only)."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, series: np.ndarray) -> "Scaler":
        series = np.asarray(series, np.float32)
        if series.ndim == 1:
            series = series[:, None]
        self.mean = series.mean(axis=0)
        self.std = series.std(axis=0) + 1e-8
        return self

    def transform(self, series: np.ndarray) -> np.ndarray:
        series = np.asarray(series, np.float32)
        squeeze = series.ndim == 1
        if squeeze:
            series = series[:, None]
        out = (series - self.mean) / self.std
        return out[:, 0] if squeeze else out

    def fit_transform(self, series):
        return self.fit(series).transform(series)

    def inverse_transform_y(self, y: np.ndarray) -> np.ndarray:
        """Undo scaling for target (feature 0) predictions."""
        return y * self.std[0] + self.mean[0]
