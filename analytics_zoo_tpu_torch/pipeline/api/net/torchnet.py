"""TorchNet / TorchCriterion: PyTorch modules and losses inside the port.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/torchnet.py``
(parity: ``TorchNet.scala:39``, ``TorchCriterion``, and
``torch_net.py:46``'s ``TorchNet.from_pytorch``). The JAX layer either
lowers the module to jax through ``torch.fx`` or runs it on the host
through a callback, because a TPU cannot run torch. The port runs torch
on the card itself, so there is neither lowering nor callback:
:class:`TorchNet` wraps the ``nn.Module`` directly. Its parameters and
buffers become the layer's, the same tensor objects under JAX's names
(``name.replace(".", "_")``, the JAX callback tier's keys), and the
forward is ``torch.func.functional_call`` of the module with the layer's
current tensors: it runs on the device the model was moved to, and a
caller that swaps the layer's parameters (the trainer's bf16 cast,
sharding) swaps what the module computes with. ``fit`` trains it like
any layer, and gradients land on the module's own parameters.

As in the JAX package, the module runs in eval mode whatever ``training``
says (the fx lowering reads BatchNorm's running statistics and drops
Dropout; the callback calls ``module.eval()``). A TorchScript module
(``torch.jit.load``) is called as it is, since ``functional_call`` cannot
swap a script module's attributes: its parameters are still the layer's,
so they move and train with it, but a bf16 cast of them does not reach
it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..keras.engine.base import KerasLayer
from ..keras.objectives import LossFunction

# the JAX fx lowering's short names for a leaf module's tensors
_FX_NAMES = {"weight": "w", "bias": "b", "running_mean": "rm",
             "running_var": "rv"}


def _key(name: str) -> str:
    return name.replace(".", "_")


class TorchNet(KerasLayer):
    """A PyTorch ``nn.Module`` as a zoo layer / inference model."""

    def __init__(self, module=None, lower: bool = True,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        # the module is not a submodule: its tensors are registered on
        # this layer under JAX's names instead (build_params)
        self.__dict__["module"] = module
        #: "torch" for an nn.Module, "script" for a TorchScript module
        #: (the JAX layer's "jax"/"callback")
        self.mode = None
        self.criterion = None
        if module is not None:
            module.eval()
            self.mode = "script" if isinstance(
                module, torch.jit.ScriptModule) else "torch"
            self._params = {_key(n): n for n, _ in module.named_parameters()}
            self._buffers_of = {_key(n): n
                                for n, _ in module.named_buffers()}
            if len(self._params) + len(self._buffers_of) != len(
                    set(self._params) | set(self._buffers_of)):
                raise ValueError("the module's tensor names collide once "
                                 "'.' becomes '_'")
            self.build_params(None, None)

    @classmethod
    def from_pytorch(cls, module, lossFunc=None, lower: bool = True, **kw):
        """Reference factory (torch_net.py:46). ``lossFunc`` is kept for
        the signature; wrap a loss with :class:`TorchCriterion`."""
        net = cls(module, lower=lower, **kw)
        if lossFunc is not None:
            net.criterion = TorchCriterion.from_loss_fn(lossFunc)
        return net

    # -- parameters -------------------------------------------------------
    def build_params(self, generator, input_shape) -> None:
        """Register the module's parameters and buffers (the objects
        themselves) on this layer, once."""
        if self.built:
            return
        self.built = True
        self._share()

    def _share(self):
        params = dict(self.module.named_parameters())
        buffers = dict(self.module.named_buffers())
        for key, name in self._params.items():
            p = params[name]
            # a loaded TorchScript module hands out plain tensors: the
            # Parameter wraps the same storage
            self._parameters[key] = p if isinstance(p, nn.Parameter) \
                else nn.Parameter(p, requires_grad=p.requires_grad)
        for key, name in self._buffers_of.items():
            self._buffers[key] = buffers[name]

    def _apply(self, fn, *args, **kwargs):
        if self.mode != "script":
            return super()._apply(fn, *args, **kwargs)
        # a script module runs its own tensors: move those, share again
        self.module._apply(fn)
        self._share()
        return self

    def load_jax_params(self, tree) -> None:
        """Copy a JAX ``TorchNet``'s params: the callback tier's keys
        (``0_weight``) or the fx lowering's (``0_w``, and BatchNorm's
        ``rm``/``rv``, which JAX trains as parameters and the port keeps
        as the module's buffers)."""
        tree = {k: np.asarray(v) for k, v in tree.items()}
        targets = dict(self.named_parameters())
        targets.update(self.named_buffers())
        names = dict(self._params, **self._buffers_of)
        done = set()
        with torch.no_grad():
            for key, t in targets.items():
                path, _, leaf = names[key].rpartition(".")
                fx = f"{_key(path)}_{_FX_NAMES.get(leaf, leaf)}" if path \
                    else _FX_NAMES.get(leaf, leaf)
                src = key if key in tree else fx if fx in tree else None
                if src is None:
                    if t.is_floating_point() and key in self._params:
                        raise ValueError(f"{self.name}: JAX params lack "
                                         f"{key!r} ({fx!r})")
                    continue
                arr = tree[src]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{self.name}.{key} <- {src}: shape "
                                     f"{arr.shape} vs {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
                done.add(src)
        extra = sorted(set(tree) - done)
        if extra:
            raise ValueError(f"{self.name}: JAX params {extra} have no "
                             "tensor in the module")

    # -- forward ----------------------------------------------------------
    def _tensors(self) -> Dict[str, torch.Tensor]:
        out = {n: getattr(self, k) for k, n in self._params.items()}
        out.update((n, getattr(self, k))
                   for k, n in self._buffers_of.items())
        return out

    def forward(self, inputs, training=False, **kwargs):
        xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        if self.mode == "script":
            out = self.module(*xs)
        else:
            out = torch.func.functional_call(self.module, self._tensors(),
                                             tuple(xs))
        if isinstance(out, list):
            out = tuple(out)
        return out

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        device = "meta" if self.mode == "torch" else "cpu"
        xs = [torch.zeros(tuple(2 if d is None else d for d in s),
                          device=device) for s in shapes]
        if self.mode == "torch":
            tensors = {n: torch.empty_like(t, device="meta")
                       for n, t in self._tensors().items()}
            outs = torch.func.functional_call(self.module, tensors,
                                              tuple(xs))
        else:
            with torch.no_grad():
                outs = self.module(*xs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        result = [(None,) + tuple(o.shape[1:]) for o in outs]
        return result[0] if len(result) == 1 else result

    # -- AbstractModel surface (InferenceModel's queue) ---------------------
    def predict(self, inputs):
        """Rows of ``inputs`` (numpy or tensors) on the device of this
        layer's parameters, returned as numpy."""
        device = next(iter(self._tensors().values())).device \
            if self._params or self._buffers_of else torch.device("cpu")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device) for x in xs]
        with torch.inference_mode():
            out = self.forward(xs)
        if isinstance(out, tuple):
            return [o.cpu().numpy() for o in out]
        return out.cpu().numpy()

    def predict_async(self, inputs):
        return self.predict(inputs)

    def release(self):
        pass

    def get_config(self):
        from ..keras.engine.model_io import UnserializableConfig
        raise UnserializableConfig(
            f"{self.name}: a TorchNet saves as its module; save the module "
            "with torch.save or torch.jit.save and load it with "
            "Net.load_torch")


class TorchCriterion:
    """A torch loss as a zoo criterion (TorchCriterion.scala parity).

    ``criterion(y_true, y_pred)`` is the JAX class's call (the torch loss
    gets ``(y_pred, y_true)``, its (input, target)); autograd takes the
    gradient to ``y_pred``. ``compile(loss=criterion)`` trains with it
    through :meth:`as_loss_function` (``objectives.get_loss`` calls it):
    the loss of the batch, its gradient to the predictions."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    @classmethod
    def from_loss_fn(cls, loss_fn):
        return cls(loss_fn)

    @classmethod
    def from_pytorch(cls, loss_fn):
        return cls(loss_fn)

    def __call__(self, y_true, y_pred):
        return self.loss_fn(y_pred, y_true)

    def as_loss_function(self) -> LossFunction:
        fn = self.loss_fn

        class _Criterion(LossFunction):
            def per_sample(self, y_pred, y_true):
                out = fn(y_pred, y_true)
                return out.expand(y_pred.shape[0]) if out.dim() == 0 \
                    else out

        return _Criterion()
