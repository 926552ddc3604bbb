"""Autograd: so far ``Lambda``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/autograd.py`` (parity:
Lambda.scala:49). The JAX module's symbolic ``Variable`` math,
``CustomLoss`` and ``ParameterLayer`` are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Callable

import torch

from .keras.engine.base import KerasLayer


class Lambda(KerasLayer):
    """Wrap a function of tensors as a layer; a list input is spread into
    positional arguments. Without ``output_shape`` the shape is inferred
    by running the function on ``meta`` tensors (None dims as 2), where
    the JAX layer uses ``jax.eval_shape``. A graph holding a Lambda is not
    saved by definition (``UnserializableConfig``)."""

    def __init__(self, function: Callable, output_shape=None,
                 input_shape=None, name=None, num_outputs: int = 1,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.function = function
        self.output_shape_spec = output_shape
        self.num_outputs = num_outputs

    def forward(self, x, training=False, **kw):
        if isinstance(x, (list, tuple)):
            return self.function(*x)
        return self.function(x)

    def compute_output_shape(self, input_shape):
        spec = self.output_shape_spec
        if spec is not None:
            if self.num_outputs > 1:
                if not (isinstance(spec, (list, tuple)) and
                        len(spec) == self.num_outputs and
                        all(isinstance(s, (list, tuple)) for s in spec)):
                    raise ValueError(
                        "num_outputs > 1 needs output_shape as a list of "
                        f"{self.num_outputs} shape tuples")
                return [tuple(s) if s and s[0] is None
                        else (None,) + tuple(s) for s in spec]
            return tuple(spec) if spec and spec[0] is None \
                else (None,) + tuple(spec)
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        probes = [torch.zeros(tuple(2 if d is None else d for d in s),
                              device="meta") for s in shapes]
        out = self.function(*probes)
        if isinstance(out, torch.Tensor):
            return (None,) + tuple(out.shape[1:])
        return [(None,) + tuple(o.shape[1:]) for o in out]
