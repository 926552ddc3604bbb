"""Normalization layers: BatchNormalization (moving statistics as float32
buffers), LayerNorm, LRN2D, WithinChannelLRN2D.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
normalization.py`` (parity: BatchNormalization.scala, Keras-1 arguments:
``axis`` 1, the channel of "th" ordering; LayerNorm.scala /
InternalLayerNorm.scala).
"""

from __future__ import annotations

import torch

from .....ops.batchnorm import batch_norm_inference, batch_norm_train
from .....ops.conv import pad_spatial, same_pads
from .....ops.layernorm import layer_norm
from ..engine.base import KerasLayer


class BatchNormalization(KerasLayer):
    """Batch norm over every axis but ``axis``, with the Keras defaults:
    epsilon 1e-3 and moving statistics ``m * old + (1 - m) * batch`` at
    momentum m = 0.99, over the biased batch variance. ``moving_mean``
    and ``moving_var`` are float32 buffers (the JAX layer's state): a
    training call normalizes with the batch moments and updates them in
    place, any other call normalizes with them and leaves them be."""

    has_state = True

    def __init__(self, epsilon=1e-3, momentum=0.99, beta_init="zero",
                 gamma_init="one", axis=1, dim_ordering="th",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis

    def _dim(self, input_shape):
        axis = self.axis if self.axis >= 0 else len(input_shape) + self.axis
        return axis, int(input_shape[axis])

    def build(self, generator, input_shape):
        _, d = self._dim(input_shape)
        return {"gamma": torch.ones(d), "beta": torch.zeros(d)}

    def init_state(self, input_shape):
        _, d = self._dim(input_shape)
        return {"moving_mean": torch.zeros(d), "moving_var": torch.ones(d)}

    def forward(self, x, training=False, **kw):
        axis, _ = self._dim(x.shape)
        if not training:
            return batch_norm_inference(x, self.gamma, self.beta,
                                        self.moving_mean, self.moving_var,
                                        axis, self.epsilon)
        y, mean, var = batch_norm_train(x, self.gamma, self.beta, axis,
                                        self.epsilon)
        m = self.momentum
        with torch.no_grad():
            self.moving_mean.copy_(m * self.moving_mean +
                                   (1 - m) * mean.detach())
            self.moving_var.copy_(m * self.moving_var +
                                  (1 - m) * var.detach())
        return y


class LayerNorm(KerasLayer):
    """Layer normalization over the last dim (LayerNorm.scala /
    InternalLayerNorm.scala: hidden_size, epsilon), with f32 single-pass
    statistics (``ops/layernorm.py``)."""

    def __init__(self, hidden_size=None, epsilon=1e-5, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.hidden_size = hidden_size
        self.epsilon = epsilon

    def build(self, generator, input_shape):
        d = int(self.hidden_size or input_shape[-1])
        return {"gamma": torch.ones(d), "beta": torch.zeros(d)}

    def forward(self, x, training=False, **kw):
        return layer_norm(x, self.gamma, self.beta, self.epsilon)


class LRN2D(KerasLayer):
    """Local response normalization across channels (LRN2D.scala):
    ``x / (k + alpha / n * sum of squares over n channels) ** beta``."""

    def __init__(self, alpha=1e-4, k=1.0, beta=0.75, n=5, dim_ordering="th",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, int(n)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        c_axis = 1 if self.dim_ordering == "th" else 3
        half = self.n // 2
        c = x.shape[c_axis]
        sq = torch.square(x).movedim(c_axis, -1)
        padded = torch.nn.functional.pad(sq, (half, half)).movedim(-1,
                                                                   c_axis)
        window_sum = sum(padded.narrow(c_axis, i, c) for i in range(self.n))
        norm = self.k + (self.alpha / self.n) * window_sum
        return x / torch.pow(norm, self.beta)


class WithinChannelLRN2D(KerasLayer):
    """``x / (1 + alpha * mean of squares over a size x size window)
    ** beta`` per channel, the window zero-padded "SAME" ('th' layout)."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.size, self.alpha, self.beta = int(size), alpha, beta

    def forward(self, x, training=False, **kw):
        window = (self.size, self.size)
        pads = same_pads(x.shape[2:], window, (1, 1))
        avg = torch.nn.functional.avg_pool2d(
            pad_spatial(torch.square(x), pads), window, 1)
        return x / torch.pow(1.0 + self.alpha * avg, self.beta)
