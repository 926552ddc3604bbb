"""KerasLayer base class.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/base.py``.
In JAX a layer is a stateless description whose ``build`` returns a
params pytree; here a layer is an ``nn.Module`` that keeps its parameters.
``build(generator, input_shape)`` still returns the pytree — a dict of
tensors, nested one level for grouped parameters — and
:meth:`KerasLayer.build_params` registers it on the module under the JAX
names and layouts: top-level leaves as parameters, nested dicts as
``nn.ParameterDict``s (``block0.qkv_w``; a Dense ``kernel`` is (in, out)).
So a model's ``state_dict()`` keys are the JAX param paths joined by
".", and JAX weights copy over with no transposes
(``utils/jax_weights.py``).

Calling a layer on symbolic :class:`Variable`s records a graph node;
calling it on tensors runs ``forward``.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from .graph import Node, Variable

_name_counters: Dict[str, Any] = collections.defaultdict(lambda: 0)


def _auto_name(cls_name: str) -> str:
    key = cls_name.lower()
    _name_counters[key] += 1
    return f"{key}_{_name_counters[key]}"


class KerasLayer(nn.Module):
    """Base class for all layers.

    Subclasses implement:
      * ``build(generator, input_shape) -> dict of tensors`` (may be {})
      * ``forward(inputs, training=False, **kw) -> outputs``
      * ``compute_output_shape(input_shape) -> shape`` (batch dim = None)

    Stochastic layers set ``stochastic=True`` and accept a ``generator``
    keyword (a ``torch.Generator``)."""

    stochastic = False
    num_outputs = 1

    def __init__(self, input_shape=None, name: Optional[str] = None,
                 **kwargs):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        # Reference layers accept input_shape WITHOUT the batch dim.
        self.input_shape = (None,) + tuple(input_shape) if input_shape \
            else None

    # -- to be overridden ------------------------------------------------
    def build(self, generator, input_shape) -> Dict[str, Any]:
        return {}

    def forward(self, inputs, training: bool = False, **kwargs):
        raise NotImplementedError(type(self).__name__)

    def compute_output_shape(self, input_shape):
        return input_shape

    # -- parameters --------------------------------------------------------
    def build_params(self, generator, input_shape) -> None:
        """Run ``build`` and register its tensors on this module."""
        for key, val in self.build(generator, input_shape).items():
            if isinstance(val, dict):
                if any(isinstance(v, dict) for v in val.values()):
                    raise NotImplementedError(
                        f"{self.name}: params nested deeper than one level")
                self.add_module(key, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in val.items()}))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def param_tree(self) -> Dict[str, Any]:
        """This layer's parameters as the JAX-shaped nested dict."""
        tree: Dict[str, Any] = {}
        for path, param in self.named_parameters():
            node = tree
            *parents, leaf = path.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = param
        return tree

    # -- symbolic application -------------------------------------------
    def __call__(self, x, *args, **kwargs):
        if isinstance(x, Variable) or (
                isinstance(x, (list, tuple)) and x and
                all(isinstance(v, Variable) for v in x)):
            inputs = [x] if isinstance(x, Variable) else list(x)
            in_shape = inputs[0].shape if len(inputs) == 1 else \
                [v.shape for v in inputs]
            out_shape = self.compute_output_shape(in_shape)
            node = Node(self, inputs)
            if self.num_outputs > 1:
                return tuple(
                    Variable(node, s, index=i)
                    for i, s in enumerate(out_shape))
            return Variable(node, out_shape)
        return super().__call__(x, *args, **kwargs)

    def extra_repr(self):
        return f"name={self.name}"


class InputLayer(KerasLayer):
    def __init__(self, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)

    def forward(self, inputs, training=False, **kwargs):
        return inputs


def Input(shape=None, name: Optional[str] = None) -> Variable:
    """Create a graph input Variable. ``shape`` excludes the batch dim,
    matching the reference's ``Input`` (keras/layers/Input.scala)."""
    if shape is None:
        raise ValueError("Input(shape=...) is required")
    return Variable(None, (None,) + tuple(shape), name=name)


# ---------------------------------------------------------------------------
# Initializers — names follow the reference's ``init`` strings
# (KerasUtils.getInitMethod). Draws come from the given torch.Generator
# (on the CPU) and need not match JAX's: parity tests copy the weights.
# ---------------------------------------------------------------------------

def init_tensor(generator, shape, init="glorot_uniform",
                dtype=torch.float32, scale: float = 0.05):
    shape = tuple(int(s) for s in shape)
    if callable(init):
        return init(generator, shape, dtype)
    init = (init or "glorot_uniform").lower()

    def uniform(limit):
        return (torch.rand(shape, generator=generator, dtype=dtype) * 2.0
                - 1.0) * limit

    def normal(std):
        return torch.randn(shape, generator=generator, dtype=dtype) * std

    if init in ("glorot_uniform", "xavier"):
        fan_in, fan_out = _fans(shape)
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if init == "glorot_normal":
        fan_in, fan_out = _fans(shape)
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if init in ("he_normal", "msra"):
        return normal(math.sqrt(2.0 / _fans(shape)[0]))
    if init == "he_uniform":
        return uniform(math.sqrt(6.0 / _fans(shape)[0]))
    if init == "lecun_uniform":
        return uniform(math.sqrt(3.0 / _fans(shape)[0]))
    if init == "uniform":
        return uniform(scale)
    if init in ("normal", "gaussian"):
        return normal(scale)
    if init in ("zero", "zeros"):
        return torch.zeros(shape, dtype=dtype)
    if init in ("one", "ones"):
        return torch.ones(shape, dtype=dtype)
    if init == "orthogonal":
        return nn.init.orthogonal_(torch.empty(shape, dtype=dtype),
                                   generator=generator)
    raise ValueError(f"Unknown init: {init}")


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: (spatial..., in, out)
    receptive = int(math.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


# ---------------------------------------------------------------------------
# Activations — string names follow KerasUtils.getKerasActivation. Only
# those the ported path uses so far; the rest arrive with the layers that
# need them.
# ---------------------------------------------------------------------------

def _softmax(x):
    return torch.softmax(x, dim=-1)


def _linear(x):
    return x


ACTIVATIONS = {"tanh": torch.tanh, "softmax": _softmax, "linear": _linear}


def get_activation_fn(name):
    if name is None:
        return None
    if callable(name):
        return name
    key = name.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown or not yet ported activation: {name}")
    return ACTIVATIONS[key]
