"""Core layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``;
so far only ``Dense``, the classifier head of the serving path.
"""

from __future__ import annotations

import torch

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
        # the float epilogue of ops/quant.py matmul: matmul + bias +
        # activation (the int8 paths arrive with quantised inference)
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)
