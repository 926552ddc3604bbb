"""Merge layers (Merge.scala and the functional ``merge`` helper).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``.
Shapes as in the JAX package: ``"dot"`` gives (B, 1) and ``"cos"``
(B, 1, 1).
"""

from __future__ import annotations

import torch

from ..engine.base import KerasLayer


class Merge(KerasLayer):
    """Merge a list of inputs: sum/add, sub, mul, max, min, ave, concat
    (along ``concat_axis``), dot, cos."""

    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=None, name=name)
        self.mode = mode
        self.concat_axis = concat_axis

    def forward(self, xs, training=False, **kw):
        mode = self.mode
        if mode in ("sum", "add"):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if mode == "sub":
            if len(xs) != 2:
                raise ValueError("sub merge takes exactly 2 inputs")
            return xs[0] - xs[1]
        if mode == "mul":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if mode == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        if mode == "min":
            out = xs[0]
            for x in xs[1:]:
                out = torch.minimum(out, x)
            return out
        if mode in ("ave", "avg", "average"):
            return sum(xs) / float(len(xs))
        if mode == "concat":
            return torch.cat(list(xs), dim=self.concat_axis)
        if mode == "dot":
            a = xs[0].reshape(xs[0].shape[0], -1)
            b = xs[1].reshape(xs[1].shape[0], -1)
            return torch.sum(a * b, dim=-1, keepdim=True)
        if mode == "cos":
            a = xs[0].reshape(xs[0].shape[0], -1)
            b = xs[1].reshape(xs[1].shape[0], -1)
            an = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=-1, keepdim=True), min=1e-12)
            bn = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=-1, keepdim=True), min=1e-12)
            return torch.sum(an * bn, dim=-1, keepdim=True)[:, None, :]
        raise ValueError(f"Unknown merge mode: {self.mode}")

    def compute_output_shape(self, input_shapes):
        shapes = input_shapes
        if self.mode == "concat":
            ref_shape = list(shapes[0])
            axis = self.concat_axis
            axis = axis if axis >= 0 else len(ref_shape) + axis
            total = 0
            for s in shapes:
                if s[axis] is None:
                    total = None
                    break
                total += s[axis]
            ref_shape[axis] = total
            return tuple(ref_shape)
        if self.mode == "dot":
            return (shapes[0][0], 1)
        if self.mode == "cos":
            return (shapes[0][0], 1, 1)
        return tuple(shapes[0])


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge over Variables (pyzoo keras ``merge``)."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(list(inputs))


class Add(Merge):
    def __init__(self, **kw):
        super().__init__(mode="sum", **kw)


class Multiply(Merge):
    def __init__(self, **kw):
        super().__init__(mode="mul", **kw)


class Average(Merge):
    def __init__(self, **kw):
        super().__init__(mode="ave", **kw)


class Maximum(Merge):
    def __init__(self, **kw):
        super().__init__(mode="max", **kw)


class Concatenate(Merge):
    def __init__(self, axis=-1, **kw):
        super().__init__(mode="concat", concat_axis=axis, **kw)
