"""Core layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``;
so far ``Dense``, ``Activation``, ``Dropout``, ``Flatten`` and
``Select``: the layers of the BERT classifier head, of the
recommendation models and of the image classifiers.
"""

from __future__ import annotations

import math

import torch

from .....ops import quant
from ..engine.base import KerasLayer, get_activation_fn, init_tensor


class Dense(KerasLayer):
    """Fully connected: applies to the last dim (Dense.scala). ``kernel``
    is (in, out), as in the JAX layer."""

    def __init__(self, output_dim, init="glorot_uniform", activation=None,
                 W_regularizer=None, b_regularizer=None, bias=True,
                 input_dim=None, input_shape=None, name=None, **kwargs):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation_fn(activation)
        # the JAX layer calls this flag ``bias``; here that name is the
        # parameter
        self.use_bias = bool(bias)

    def build(self, generator, input_shape):
        in_dim = int(input_shape[-1])
        params = {"kernel": init_tensor(generator,
                                        (in_dim, self.output_dim),
                                        self.init)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.output_dim)
        return params

    def forward(self, x, training=False, **kw):
        # quant.matmul owns the whole epilogue: a float kernel gives
        # matmul + bias + activation; a calibrated int8 kernel (supplied
        # by QuantizedModel) folds the bias into the int32 accumulator
        # and may emit int8 for the next requantization-chain link
        return quant.matmul(x, quant.kernel_of(self),
                            bias=self.bias if self.use_bias else None,
                            activation=self.activation)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(KerasLayer):
    """Applies an activation by name (``get_activation_fn``)."""

    def __init__(self, activation, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.fn = get_activation_fn(activation)

    def forward(self, x, training=False, **kw):
        return self.fn(x)


class Dropout(KerasLayer):
    """Zeroes each element with probability ``p`` while training and
    scales the rest by ``1 / (1 - p)``; the identity when not training,
    at ``p = 0`` or without a generator. The mask comes from the
    trainer's per-step ``generator`` on x's device, so it differs from
    JAX's ``bernoulli`` bits by design."""

    stochastic = True

    def __init__(self, p, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class Flatten(KerasLayer):
    """(B, ...) -> (B, prod(...)); a 1-D input (B,) becomes (B, 1)."""

    def forward(self, x, training=False, **kw):
        return x.reshape(x.shape[0], -1) if x.dim() > 1 else \
            x.reshape(x.shape[0], 1)

    def compute_output_shape(self, input_shape):
        rest = list(input_shape[1:])
        return (input_shape[0], int(math.prod(rest)) if rest else 1)


class Select(KerasLayer):
    """Select one index along a dim, removing it (Select.scala). ``dim``
    counts the batch dim as 0; a negative ``dim`` or ``index`` counts
    from the end."""

    def __init__(self, dim, index, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.index = int(index)

    def forward(self, x, training=False, **kw):
        idx = self.index if self.index >= 0 else \
            x.shape[self.dim] + self.index
        return x.select(self.dim, idx)

    def compute_output_shape(self, input_shape):
        dim = self.dim if self.dim >= 0 else len(input_shape) + self.dim
        return tuple(d for i, d in enumerate(input_shape) if i != dim)
