"""Wrapper layers: TimeDistributed, Bidirectional.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
wrappers.py`` (parity: TimeDistributed.scala, Bidirectional.scala). The
wrapped layers are submodules under the JAX params' role keys --
``layer`` for TimeDistributed, ``forward`` and ``backward`` for
Bidirectional -- so the parameter paths are the JAX tree's
(``timedistributed_1.layer.kernel``, ``bidirectional_1.forward.W``).
``KerasLayerWrapper`` wraps a torch callable (a function or a stateless
``nn.Module``) as a layer; its output shape comes from one call on the
``meta`` device, as the JAX layer's comes from ``jax.eval_shape``.
"""

from __future__ import annotations

import copy
import threading

import torch

from ..engine.base import KerasLayer, is_symbolic

# the Bidirectional layers each thread is inside the call of
_MERGING = threading.local()


class TimeDistributed(KerasLayer):
    """Apply an inner layer to every temporal slice: time folds into the
    batch, one call of the inner layer over (B*T, ...). Its state and
    stochasticity pass through."""

    def __init__(self, layer: KerasLayer, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.layer = layer

    @property
    def has_state(self):
        return self.layer.has_state

    @property
    def stochastic(self):
        return self.layer.stochastic

    @staticmethod
    def _inner_shape(input_shape):
        return (input_shape[0],) + tuple(input_shape[2:])

    def build_params(self, generator, input_shape) -> None:
        self.built = True
        if not self.layer.built:
            self.layer.build_params(generator, self._inner_shape(input_shape))

    def state_tree(self):
        s = self.layer.state_tree()
        return {"layer": s} if s else {}

    def forward(self, x, training=False, generator=None, **kw):
        b, t = x.shape[0], x.shape[1]
        kwargs = {"generator": generator} if self.layer.stochastic else {}
        out = self.layer(x.reshape((b * t,) + tuple(x.shape[2:])),
                         training=training, **kwargs)
        return out.reshape((b, t) + tuple(out.shape[1:]))

    def compute_output_shape(self, s):
        inner = self.layer.compute_output_shape(self._inner_shape(s))
        return (s[0], s[1]) + tuple(inner[1:])


class _ForwardRole:
    """``Bidirectional.forward``: inside the layer's own call (per thread)
    the merge, which ``nn.Module``'s call then runs with its hooks;
    anywhere else the forward copy, the submodule under the role key
    ``forward``, which ``getattr`` paths (``torch.func.functional_call``)
    walk to."""

    def __get__(self, obj, cls=None):
        if obj is None:
            return self
        if obj in getattr(_MERGING, "layers", ()):
            return obj.merge_call
        return obj._modules["forward"]


class Bidirectional(KerasLayer):
    """Run a recurrent layer forward and a copy of it backward (its
    ``go_backwards`` flipped) and merge the outputs: concat, sum, mul or
    ave (Bidirectional.scala).

    The forward copy's role key is ``forward``, the name of
    ``nn.Module``'s call method: :class:`_ForwardRole` hands out the
    submodule, or the merge while :meth:`__call__` runs the layer on
    tensors."""

    forward = _ForwardRole()

    def __init__(self, layer, merge_mode="concat", input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"unknown merge_mode {merge_mode}")
        backward = copy.deepcopy(layer)
        backward.name = layer.name + "_bwd"
        backward.go_backwards = not getattr(layer, "go_backwards", False)
        self._modules["forward"] = layer
        self.backward = backward
        self.merge_mode = merge_mode

    def build_params(self, generator, input_shape) -> None:
        self.built = True
        for role in (self._modules["forward"], self.backward):
            if not role.built:
                role.build_params(generator, input_shape)

    def __call__(self, x, *args, **kwargs):
        if is_symbolic(x):
            return super().__call__(x, *args, **kwargs)
        layers = _MERGING.__dict__.setdefault("layers", set())
        layers.add(self)
        try:
            return super().__call__(x, *args, **kwargs)
        finally:
            layers.discard(self)

    def merge_call(self, x, training=False, **kw):
        fwd = self._modules["forward"](x, training=training)
        bwd = self.backward(x, training=training)
        if self.merge_mode == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        return (fwd + bwd) / 2.0

    def compute_output_shape(self, s):
        inner = self._modules["forward"].compute_output_shape(s)
        if self.merge_mode == "concat":
            return tuple(inner[:-1]) + (inner[-1] * 2,)
        return inner


class KerasLayerWrapper(KerasLayer):
    """Wrap an arbitrary torch callable (or stateless layer) as a
    KerasLayer."""

    def __init__(self, torch_layer=None, input_shape=None, name=None,
                 function=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        fn = function or torch_layer
        if not callable(fn):
            raise ValueError("KerasLayerWrapper needs a callable")
        # a module given here is called, not registered: it holds no
        # parameters the layer would train (the JAX layer's contract)
        self.__dict__["function"] = fn

    def forward(self, x, training=False, **kw):
        return self.function(x)

    def compute_output_shape(self, input_shape):
        probe = torch.zeros(tuple(2 if d is None else d
                                  for d in input_shape), device="meta")
        out = self.function(probe)
        return (None,) + tuple(out.shape[1:])
