"""Time-series forecasters searched by the AutoML engine.

Counterpart of ``analytics_zoo_tpu/automl/forecaster.py``. The reference
implementation lives on the off-tree ``automl`` branch, so these are
spec-from-docs builds on the port's Keras API (``LSTM``,
``AtrousConvolution1D``, ``Dense``, ``Dropout``): an LSTM forecaster and a
causal dilated-conv (TCN) forecaster, both ``(B, lookback, F) ->
(B, horizon)``, trained through ``Model.fit`` on the context's device.
``save_params`` writes the weights in the JAX model's leaf order, so
either package's forecaster loads the other's ``weights.npz``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class _BaseForecaster:
    def __init__(self, lookback: int, feature_dim: int = 1,
                 horizon: int = 1, lr: float = 1e-3,
                 metrics: Sequence[str] = ("mae",)):
        self.lookback = lookback
        self.feature_dim = feature_dim
        self.horizon = horizon
        self.lr = lr
        self.metrics = list(metrics)
        self.model = self._build()

    def _build(self):
        raise NotImplementedError

    def _compile(self, model):
        from ..pipeline.api.keras.optimizers import Adam

        model.compile(optimizer=Adam(lr=self.lr), loss="mse",
                      metrics=self.metrics)
        return model

    def fit(self, x, y, batch_size: int = 32, epochs: int = 1,
            validation_data=None):
        self.model.fit(np.asarray(x, np.float32),
                       np.asarray(y, np.float32),
                       batch_size=batch_size, nb_epoch=epochs)
        return self

    def evaluate(self, x, y, batch_size: int = 32):
        return self.model.evaluate(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   batch_size=batch_size)

    def predict(self, x, batch_size: int = 128):
        return self.model.predict(np.asarray(x, np.float32),
                                  batch_size=batch_size)

    # -- checkpointing (ASHA pause/resume at rung boundaries) ----------
    def save_params(self, path: str):
        """Atomically checkpoint model weights to ``path`` (npz).

        Written via a file object — ``np.savez(str)`` appends ``.npz``
        to bare paths — then ``os.replace``d so a killed worker never
        leaves a torn checkpoint behind.
        """
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, *self.model.get_weights())
        os.replace(tmp, path)
        return path

    def load_params(self, path: str):
        """Restore weights saved by :meth:`save_params`.

        Only weights round-trip; optimizer moments restart per segment —
        a known resume tradeoff documented in docs/automl.md.
        """
        with np.load(path) as data:
            weights = [data[k] for k in sorted(
                data.files, key=lambda n: int(n.split("_")[-1]))]
        self.model.set_weights(weights)
        return self


class LSTMForecaster(_BaseForecaster):
    """Stacked-LSTM regressor (automl-branch LSTMForecaster spec)."""

    def __init__(self, lookback: int, feature_dim: int = 1, horizon: int = 1,
                 lstm_units: Sequence[int] = (32, 16), dropout: float = 0.1,
                 lr: float = 1e-3, **kw):
        self.lstm_units = [int(u) for u in (
            lstm_units if isinstance(lstm_units, (list, tuple))
            else [lstm_units])]
        self.dropout = dropout
        super().__init__(lookback, feature_dim, horizon, lr, **kw)

    def _build(self):
        from ..pipeline.api.keras.layers import LSTM, Dense, Dropout
        from ..pipeline.api.keras.models import Sequential

        model = Sequential()
        for i, units in enumerate(self.lstm_units):
            last = i == len(self.lstm_units) - 1
            kw = {"input_shape": (self.lookback, self.feature_dim)} \
                if i == 0 else {}
            model.add(LSTM(units, return_sequences=not last, **kw))
            if self.dropout:
                model.add(Dropout(self.dropout))
        model.add(Dense(self.horizon))
        return self._compile(model)


class TCNForecaster(_BaseForecaster):
    """Causal dilated-conv forecaster (TCN spec: left-padded dilated
    stacks, exponentially growing receptive field)."""

    def __init__(self, lookback: int, feature_dim: int = 1, horizon: int = 1,
                 n_filters: int = 16, kernel_size: int = 3, n_blocks: int = 2,
                 dropout: float = 0.1, lr: float = 1e-3, **kw):
        self.n_filters = int(n_filters)
        self.kernel_size = int(kernel_size)
        self.n_blocks = int(n_blocks)
        self.dropout = dropout
        super().__init__(lookback, feature_dim, horizon, lr, **kw)

    def _build(self):
        from ..pipeline.api.keras.layers import (AtrousConvolution1D, Dense,
                                                 Dropout, Flatten,
                                                 ZeroPadding1D)
        from ..pipeline.api.keras.models import Sequential

        model = Sequential()
        in_shape = {"input_shape": (self.lookback, self.feature_dim)}
        for b in range(self.n_blocks):
            dilation = 2 ** b
            pad = (self.kernel_size - 1) * dilation
            model.add(ZeroPadding1D(padding=(pad, 0), **in_shape))
            in_shape = {}
            model.add(AtrousConvolution1D(self.n_filters, self.kernel_size,
                                          atrous_rate=dilation,
                                          activation="relu"))
            if self.dropout:
                model.add(Dropout(self.dropout))
        model.add(Flatten())
        model.add(Dense(self.horizon))
        return self._compile(model)


FORECASTERS = {"lstm": LSTMForecaster, "tcn": TCNForecaster}


def build_forecaster(model: str = "lstm", **config) -> _BaseForecaster:
    try:
        cls = FORECASTERS[model.lower()]
    except KeyError:
        raise ValueError(f"unknown forecaster {model!r}; "
                         f"choose from {sorted(FORECASTERS)}") from None
    import inspect

    allowed = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in config.items() if k in allowed})
