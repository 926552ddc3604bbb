"""KerasLayer base class.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/base.py``.
In JAX a layer is a stateless description whose ``build`` returns a
params pytree; here a layer is an ``nn.Module`` that keeps its parameters.
``build(generator, input_shape)`` still returns the pytree — a dict of
tensors, nested one level for grouped parameters — and
:meth:`KerasLayer.build_params` registers it on the module under the JAX
names and layouts: top-level leaves as parameters, nested dicts as
``nn.ParameterDict``s (``block0.qkv_w``; a Dense ``kernel`` is (in, out)).
A layer that wraps others (``TimeDistributed``, ``Bidirectional``,
Seq2seq's coders) holds them as submodules under the JAX tree's keys and
builds them in its own ``build_params``. So a model's ``state_dict()``
keys are the JAX param paths joined by ".", and JAX weights copy over with no transposes
(``utils/jax_weights.py``).

A layer with non-trainable state (BatchNorm's moving statistics) sets
``has_state`` and returns the JAX ``init_state`` dict from
:meth:`KerasLayer.init_state`; ``build_params`` registers its tensors as
float32 buffers, PyTorch's home for such state, where the JAX layer
hands a new state back from ``call``. The layer updates its buffers in
place in ``forward`` when ``training`` is True, once a call, and only
reads them otherwise; ``named_parameters()`` (the trainable weights, the
optimizer's tree, ``get_weights``) never holds them.

Calling a layer on symbolic :class:`Variable`s records a graph node;
calling it on tensors runs ``forward``.

Every subclass's ``__init__`` records its bound arguments (``get_config``,
``from_config``), as the JAX base does: ``model_io`` saves a model as its
layers' classes and configs, and the port's constructors take the JAX
signatures' argument names, so the configs are the JAX package's.
"""

from __future__ import annotations

import collections
import functools
import inspect
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


def _capture_config(init):
    """Wrap ``__init__`` to record the bound constructor arguments
    (``_capture_config`` of the JAX base)."""

    @functools.wraps(init)
    def wrapped(self, *args, **kwargs):
        if "_config" not in self.__dict__:
            try:
                bound = inspect.signature(init).bind(self, *args, **kwargs)
                bound.apply_defaults()
                cfg = dict(bound.arguments)
                cfg.pop("self", None)
                cfg.pop("kwargs", None)
            except TypeError:
                cfg = {}
            self.__dict__["_config"] = cfg
        init(self, *args, **kwargs)

    return wrapped


def is_symbolic(x) -> bool:
    """Whether a layer call on ``x`` records a graph node: ``x`` is a
    ``Variable`` or a non-empty list of them."""
    return isinstance(x, Variable) or (
        isinstance(x, (list, tuple)) and bool(x) and
        all(isinstance(v, Variable) for v in x))


class KerasLayer(nn.Module):
    """Base class for all layers.

    Subclasses implement:
      * ``build(generator, input_shape) -> dict of tensors`` (may be {})
      * ``forward(inputs, training=False, **kw) -> outputs``
      * ``compute_output_shape(input_shape) -> shape`` (batch dim = None)

    Layers with non-trainable state set ``has_state=True`` and implement
    ``init_state(input_shape) -> dict of tensors`` (registered as float32
    buffers). Stochastic layers set ``stochastic=True`` and accept a
    ``generator`` keyword (a ``torch.Generator``)."""

    has_state = False
    stochastic = False
    num_outputs = 1

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "__init__" in cls.__dict__:
            cls.__init__ = _capture_config(cls.__dict__["__init__"])

    def __init__(self, input_shape=None, name: Optional[str] = None,
                 **kwargs):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        #: set once :meth:`build_params` has registered the parameters; a
        #: graph built over this layer later (another ``Model``, a
        #: ``new_graph``) shares them instead of drawing new ones
        self.built = False
        # Reference layers accept input_shape WITHOUT the batch dim.
        self.input_shape = (None,) + tuple(input_shape) if input_shape \
            else None

    # -- to be overridden ------------------------------------------------
    def build(self, generator, input_shape) -> Dict[str, Any]:
        return {}

    def init_state(self, input_shape) -> Dict[str, Any]:
        return {}

    def forward(self, inputs, training: bool = False, **kwargs):
        raise NotImplementedError(type(self).__name__)

    def compute_output_shape(self, input_shape):
        return input_shape

    # -- parameters --------------------------------------------------------
    def build_params(self, generator, input_shape) -> None:
        """Run ``build`` and register its tensors on this module, and
        ``init_state``'s as float32 buffers."""
        self.built = True
        for key, val in self.build(generator, input_shape).items():
            if isinstance(val, dict):
                if any(isinstance(v, dict) for v in val.values()):
                    raise NotImplementedError(
                        f"{self.name}: params nested deeper than one level")
                self.add_module(key, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in val.items()}))
            else:
                self.register_parameter(key, nn.Parameter(val))
        for key, val in self.init_state(input_shape).items():
            self.register_buffer(key, val.float())

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

    def state_tree(self) -> Dict[str, Any]:
        """This layer's state buffers as the JAX ``init_state`` dict."""
        return dict(self.named_buffers(recurse=False))

    # -- symbolic application -------------------------------------------
    def __call__(self, x, *args, **kwargs):
        if is_symbolic(x):
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

    # -- serialization ---------------------------------------------------
    def get_config(self) -> Dict[str, Any]:
        cfg = dict(self.__dict__.get("_config", {}))
        cfg.pop("name", None)
        return cfg

    @classmethod
    def from_config(cls, config):
        """The layer ``config`` describes. A ``**kw`` catch-all recorded
        under its own name (a signature's ``kw`` where the JAX base drops
        only ``kwargs``) is spread back into keywords, so a config
        round-trips unchanged."""
        config = dict(config)
        for p in inspect.signature(cls.__init__).parameters.values():
            if p.kind is p.VAR_KEYWORD and isinstance(config.get(p.name),
                                                      dict):
                config.update(config.pop(p.name))
        return cls(**config)

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
# Activations — string names follow KerasUtils.getKerasActivation, with the
# JAX package's definitions (hard_sigmoid is the Keras-1 clip(0.2x + 0.5,
# 0, 1); gelu the tanh form, jax.nn.gelu's default).
# ---------------------------------------------------------------------------

def _softmax(x):
    return torch.softmax(x, dim=-1)


def _log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def _linear(x):
    return x


def _hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": torch.nn.functional.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": _hard_sigmoid,
    "softmax": _softmax,
    "softplus": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
    "linear": _linear,
    "elu": torch.nn.functional.elu,
    "selu": torch.selu,
    "gelu": _gelu,
    "exp": torch.exp,
    "log": torch.log,
    "swish": torch.nn.functional.silu,
    "log_softmax": _log_softmax,
    "mish": torch.nn.functional.mish,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
}


class NamedActivation:
    """An activation by name: calls ``ACTIVATIONS[name]``. The int8 path
    reads ``name`` (a relu commutes with the requantize scale, so a
    relu layer or epilogue stays on an int8 chain)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __call__(self, x):
        return ACTIVATIONS[self.name](x)

    def __reduce__(self):
        return (NamedActivation, (self.name,))

    def __repr__(self):
        return f"activation:{self.name}"


def get_activation_fn(name):
    if name is None:
        return None
    if callable(name):
        return name
    key = name.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation: {name}")
    return NamedActivation(key)
