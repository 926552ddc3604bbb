"""Autograd: symbolic math over Variables, ``CustomLoss``, ``Lambda`` and
``Parameter``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/autograd.py`` (parity:
``AutoGrad`` math, math.scala:32; the ``Variable`` operators,
Variable.scala:365-378; ``CustomLoss``, CustomLoss.scala:29-66;
``Lambda``, Lambda.scala:49; ``Parameter``, KerasParameter.scala:31,73).

Every op is dual-dispatch, as in the JAX module: on a :class:`Variable`
it records a ``Lambda`` node in the symbolic graph, with the JAX op's
shape rule; on concrete tensors it runs the torch op at once. So a loss
written against this API is a graph node and, inside the training step,
plain torch that autograd differentiates.
"""

from __future__ import annotations

import builtins
import operator
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .keras.engine.base import KerasLayer, init_tensor
from .keras.engine.graph import Node, Variable


class Lambda(KerasLayer):
    """Wrap a function of tensors as a layer; a list input is spread into
    positional arguments. Without ``output_shape`` the shape is inferred
    by running the function on ``meta`` tensors (None dims as 2), where
    the JAX layer uses ``jax.eval_shape``. A graph holding a Lambda saves
    its architecture by pickle (``KerasNet.save_model``)."""

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


class ParameterLayer(KerasLayer):
    """A trainable free tensor (KerasParameter.scala:31); with
    ``trainable=False`` its output carries no gradient."""

    def __init__(self, shape, init_weight=None, init_method="glorot_uniform",
                 trainable=True, name=None, **kwargs):
        super().__init__(name=name)
        self.shape = tuple(int(s) for s in shape)
        self.init_weight = init_weight
        self.init_method = init_method
        self.trainable = trainable

    def build(self, generator, input_shape):
        if self.init_weight is not None:
            w = torch.as_tensor(np.asarray(self.init_weight, np.float32))
        else:
            w = init_tensor(generator, self.shape, self.init_method)
        return {"weight": w}

    def forward(self, x, training=False, **kw):
        return self.weight if self.trainable else self.weight.detach()

    def compute_output_shape(self, input_shape):
        return self.shape


def Parameter(shape, init_weight=None, init_method="glorot_uniform",
              trainable=True, name=None) -> Variable:
    layer = ParameterLayer(shape, init_weight, init_method, trainable,
                           name=name)
    return Variable(Node(layer, []), layer.shape)


# ---------------------------------------------------------------------------
# dual-dispatch op machinery
# ---------------------------------------------------------------------------

def _is_sym(x):
    return isinstance(x, Variable)


def _apply(fn: Callable, shape_fn: Callable, *args, op_name="op"):
    """``fn`` over ``args`` (Variables and constants): a graph node with
    ``shape_fn``'s shape if any argument is a Variable, else the value."""
    if builtins.any(_is_sym(a) for a in args):
        sym_inputs = [a for a in args if _is_sym(a)]

        def call_fn(*concrete_sym):
            it = iter(concrete_sym)
            return fn(*[next(it) if _is_sym(a) else a for a in args])

        layer = Lambda(call_fn, name=None)
        layer.name = layer.name.replace("lambda", op_name)
        in_shapes = [v.shape for v in sym_inputs]
        out_shape = shape_fn(in_shapes) if shape_fn else \
            layer.compute_output_shape(
                in_shapes if len(in_shapes) > 1 else in_shapes[0])
        return Variable(Node(layer, sym_inputs), out_shape)
    return fn(*args)


def _broadcast_shape(shapes):
    out = ()
    for s in shapes:
        s = tuple(s)
        r = []
        for a, b in zip(reversed(out), reversed(s)):
            r.append(None if a is None or b is None else builtins.max(a, b))
        longer = out if len(out) > len(s) else s
        out = tuple(longer[:len(longer) - len(r)]) + tuple(reversed(r))
    return out


_BINARY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv, "pow": operator.pow}


def _binary_op(a, b, mode):
    return _apply(_BINARY[mode], _broadcast_shape, a, b, op_name=mode)


def _unary(fn, name):
    def op(x):
        return _apply(fn, lambda s: tuple(s[0]), x, op_name=name)

    op.__name__ = name
    return op


neg = _unary(torch.neg, "neg")
abs = _unary(torch.abs, "abs")  # noqa: A001 - parity with AutoGrad.abs
square = _unary(torch.square, "square")
sqrt = _unary(torch.sqrt, "sqrt")
exp = _unary(torch.exp, "exp")
log = _unary(torch.log, "log")
erf = _unary(torch.erf, "erf")
softsign = _unary(F.softsign, "softsign")
softplus = _unary(F.softplus, "softplus")
relu = _unary(torch.relu, "relu")
sigmoid = _unary(torch.sigmoid, "sigmoid")
tanh = _unary(torch.tanh, "tanh")


def _reduced_shape(shape, axis, keepdims):
    if axis is None:
        return (None,) if not keepdims else tuple(1 for _ in shape)
    axis = axis if axis >= 0 else len(shape) + axis
    if keepdims:
        return tuple(1 if i == axis else d for i, d in enumerate(shape))
    return tuple(d for i, d in enumerate(shape) if i != axis)


def _reduce(fn, a, axis, keepdims):
    if axis is None:
        out = fn(a)
        return out.reshape((1,) * a.dim()) if keepdims else out
    return fn(a, dim=axis, keepdim=keepdims)


def sum(x, axis=0, keepdims=False):  # noqa: A001 - parity AutoGrad.sum
    return _apply(lambda a: _reduce(torch.sum, a, axis, keepdims),
                  lambda s: _reduced_shape(s[0], axis, keepdims), x,
                  op_name="sum")


def mean(x, axis=0, keepdims=False):
    return _apply(lambda a: _reduce(torch.mean, a, axis, keepdims),
                  lambda s: _reduced_shape(s[0], axis, keepdims), x,
                  op_name="mean")


def _as_tensor(v, like):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _pairwise(fn):
    def run(a, b):
        ref = a if isinstance(a, torch.Tensor) else b
        return fn(_as_tensor(a, ref), _as_tensor(b, ref))
    return run


def maximum(x, y):
    return _apply(_pairwise(torch.maximum), _broadcast_shape, x, y,
                  op_name="maximum")


def minimum(x, y):
    return _apply(_pairwise(torch.minimum), _broadcast_shape, x, y,
                  op_name="minimum")


def clip(x, min_value, max_value):
    return _apply(lambda a: torch.clamp(a, min_value, max_value),
                  lambda s: tuple(s[0]), x, op_name="clip")


def pow(x, a):  # noqa: A001
    return _binary_op(x, a, "pow")


def epsilon():
    return 1e-7


def _axis(ax, rank):
    return ax if ax >= 0 else rank + ax


def mm(x, y, axes=None):
    """Matmul, or a contraction over ``axes`` (AutoGrad.mm)."""

    def fn(a, b):
        if axes is None:
            return torch.matmul(a, b)
        return torch.tensordot(a, b, dims=([axes[0]], [axes[1]]))

    def shape_fn(shapes):
        sa, sb = shapes
        if axes is None:
            return tuple(sa[:-1]) + (sb[-1],)
        ax, bx = _axis(axes[0], len(sa)), _axis(axes[1], len(sb))
        return tuple(d for i, d in enumerate(sa) if i != ax) + \
            tuple(d for i, d in enumerate(sb) if i != bx)

    return _apply(fn, shape_fn, x, y, op_name="mm")


def _l2n(a, axis):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=axis,
                                                    keepdim=True),
                           min=1e-12)


def batch_dot(x, y, axes=(2, 2), normalize=False):
    """Batch dot over ``axes`` (AutoGrad.batchDot): ``dot_general`` with
    batch dim 0, the result (B, x's free dims, y's free dims)."""

    def fn(a, b):
        if normalize:
            a, b = _l2n(a, axes[0]), _l2n(b, axes[1])
        a2 = a.movedim(axes[0], -1)
        b2 = b.movedim(axes[1], 1)
        fa, fb = a2.shape[1:-1], b2.shape[2:]
        out = torch.bmm(a2.reshape(a2.shape[0], -1, a2.shape[-1]),
                        b2.reshape(b2.shape[0], b2.shape[1], -1))
        return out.reshape((a.shape[0],) + tuple(fa) + tuple(fb))

    def shape_fn(shapes):
        sa, sb = shapes
        ax, bx = _axis(axes[0], len(sa)), _axis(axes[1], len(sb))
        return (sa[0],) + tuple(d for i, d in enumerate(sa)
                                if i not in (0, ax)) + \
            tuple(d for i, d in enumerate(sb) if i not in (0, bx))

    return _apply(fn, shape_fn, x, y, op_name="batch_dot")


batchDot = batch_dot


def l2_normalize(x, axis=-1):
    return _apply(lambda a: _l2n(a, axis), lambda s: tuple(s[0]), x,
                  op_name="l2_normalize")


l2Normalize = l2_normalize


def stack(inputs, axis=1):
    def shape_fn(shapes):
        s = list(shapes[0])
        s.insert(axis if axis >= 0 else len(s) + axis + 1, len(shapes))
        return tuple(s)

    return _apply(lambda *arrays: torch.stack(arrays, dim=axis), shape_fn,
                  *inputs, op_name="stack")


def concatenate(inputs, axis=-1):
    def shape_fn(shapes):
        s = list(shapes[0])
        ax = _axis(axis, len(s))
        dims = [sh[ax] for sh in shapes]
        s[ax] = None if builtins.any(d is None for d in dims) \
            else builtins.sum(dims)
        return tuple(s)

    return _apply(lambda *arrays: torch.cat(arrays, dim=axis), shape_fn,
                  *inputs, op_name="concat")


def expand_dims(x, axis):
    def shape_fn(shapes):
        s = list(shapes[0])
        s.insert(axis if axis >= 0 else len(s) + axis + 1, 1)
        return tuple(s)

    return _apply(lambda a: torch.unsqueeze(a, axis), shape_fn, x,
                  op_name="expand_dims")


def _drop_dim(dim):
    def shape_fn(shapes):
        s = shapes[0]
        d = _axis(dim, len(s))
        return tuple(v for i, v in enumerate(s) if i != d)
    return shape_fn


def squeeze(x, dim):
    return _apply(lambda a: torch.squeeze(a, dim), _drop_dim(dim), x,
                  op_name="squeeze")


def index_select(x, dim, index):
    return _apply(lambda a: a.select(dim, index), _drop_dim(dim), x,
                  op_name="index_select")


def contiguous(x):
    return x


def _slice_dim(x, dim, start_index, length):
    def shape_fn(shapes):
        s = list(shapes[0])
        s[_axis(dim, len(s))] = length
        return tuple(s)

    return _apply(lambda a: a.narrow(dim, start_index, length), shape_fn, x,
                  op_name="slice")


def _slice_variable(x, key):
    def shape_fn(shapes):
        s = shapes[0]
        probe = np.zeros(tuple(2 if d is None else d for d in s),
                         np.float32)[key]
        out = list(probe.shape)
        if s[0] is None and len(out) > 0:
            out[0] = None
        return tuple(out)

    return _apply(lambda a: a[key], shape_fn, x, op_name="getitem")


# ---------------------------------------------------------------------------
# CustomLoss (CustomLoss.scala:29-66)
# ---------------------------------------------------------------------------

class CustomLoss:
    """A loss from an autograd expression ``fn(y_true, y_pred)``: the ops
    run eagerly on the step's tensors, so it works wherever a loss
    does (``compile(loss=CustomLoss(fn))``)."""

    def __init__(self, loss_fn: Callable, y_pred_shape=None,
                 y_true_shape=None):
        self.loss_fn = loss_fn

    def per_sample(self, y_pred, y_true):
        out = torch.as_tensor(self.loss_fn(y_true, y_pred))
        if out.dim() == 0:
            return out.expand(y_pred.shape[0])
        return out.reshape(out.shape[0], -1).mean(dim=-1)

    def __call__(self, y_pred, y_true, sample_weight=None):
        losses = self.per_sample(y_pred, y_true)
        if sample_weight is not None:
            return (losses * sample_weight).sum() / \
                torch.clamp(sample_weight.sum(), min=1e-7)
        return losses.mean()

    def forward(self, y_true, y_pred):
        return float(self(torch.as_tensor(np.asarray(y_pred)),
                          torch.as_tensor(np.asarray(y_true))))
