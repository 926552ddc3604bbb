"""Keras-style model topology: KerasNet / Model.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/
topology.py`` (parity surface ``Topology.scala``: ``KerasNet``,
``Model``:602). Both containers are ``nn.Module``s: a ``Model`` registers
each distinct layer of its graph as a submodule under the layer's name,
so ``model.state_dict()`` keys are the JAX param paths joined by "."
(``bert_1.block0.qkv_w``, ``dense_1.kernel``).

This slice ports the inference surface: weights in and out, and
``predict``. ``compile``/``fit``/``evaluate`` arrive with the training
slice, ``Sequential`` and save/load with the persistence slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .....common.nncontext import get_nncontext
from .base import KerasLayer
from .graph import GraphFunction, Variable


def as_device_tensor(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; float64 arrives as float32,
    as ``jnp.asarray`` gives it without x64."""
    t = torch.as_tensor(np.asarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _flatten_sorted(tree: Dict[str, Any], out: List[Any]) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted at
    every level)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            _flatten_sorted(val, out)
        else:
            out.append(val)
    return out


class KerasNet(KerasLayer):
    """Common surface of the Keras-style containers."""

    stochastic = True

    # -- abstract ------------------------------------------------------
    def graph_function(self) -> GraphFunction:
        raise NotImplementedError

    # -- inference -----------------------------------------------------
    def predict(self, x, batch_size=128, distributed=True):
        """Outputs for ``x`` (an array, or a list of arrays for a
        multi-input model) as numpy, in batches of ``batch_size`` on the
        context's device — one device, as ``SPMDTrainer.predict`` batches.
        That is ``cuda:0`` unless the context was made for another device,
        and with no context and no card it raises; the model moves there
        in place, as ``InferenceModel.load_keras_net`` moves it. Runs
        under ``torch.inference_mode()``; the last batch may be short (no
        padding is needed without a compiled program)."""
        device = get_nncontext().device
        self.to(device)
        graph = self.graph_function()
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        n = len(xs[0])
        chunks: List[Any] = []
        with torch.inference_mode():
            for start in range(0, n, batch_size):
                batch = [as_device_tensor(a[start:start + batch_size],
                                          device) for a in xs]
                chunks.append(graph.apply(batch, training=False))
        if not chunks:
            return None
        if isinstance(chunks[0], (list, tuple)):
            return [torch.cat([c[i] for c in chunks]).cpu().numpy()
                    for i in range(len(chunks[0]))]
        return torch.cat(chunks).cpu().numpy()

    # -- weights -------------------------------------------------------
    def param_tree(self) -> Dict[str, Any]:
        """{layer_name: layer params}, the JAX params pytree's shape."""
        tree = {}
        for layer in self.graph_function().layers:
            p = layer.param_tree()
            if p:
                tree[layer.name] = p
        return tree

    def get_weights(self) -> List[np.ndarray]:
        """Every parameter as numpy, in the JAX model's leaf order."""
        return [p.detach().cpu().numpy()
                for p in _flatten_sorted(self.param_tree(), [])]

    def set_weights(self, weights: Sequence[np.ndarray]):
        leaves = _flatten_sorted(self.param_tree(), [])
        if len(leaves) != len(weights):
            raise ValueError(f"expected {len(leaves)} arrays, got "
                             f"{len(weights)}")
        with torch.no_grad():
            for p, w in zip(leaves, weights):
                w = torch.as_tensor(np.asarray(w))
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(f"shape {tuple(w.shape)} does not "
                                     f"match {tuple(p.shape)}")
                p.copy_(w.to(p.dtype))


class Model(KerasNet):
    """Functional graph container (Topology.scala:602). Builds every
    layer's weights at construction from ``seed`` (the context config's
    seed when None) on the CPU; ``predict`` and
    ``InferenceModel.load_keras_net`` move it to the context's device."""

    def __init__(self, input, output, name=None, seed: Optional[int] = None):
        super().__init__(name=name)
        self.inputs = [input] if isinstance(input, Variable) else list(input)
        self.outputs = [output] if isinstance(output, Variable) \
            else list(output)
        self._graph = GraphFunction(self.inputs, self.outputs)
        self.num_outputs = len(self.outputs)
        if seed is None:
            from .....common import nncontext as _nn
            ctx = _nn._global_context
            seed = ctx.config.seed if ctx is not None else 42
        self._graph.init(torch.Generator().manual_seed(int(seed)))
        for layer in self._graph.layers:
            self.add_module(layer.name, layer)

    def graph_function(self):
        return self._graph

    def forward(self, inputs, training=False, generator=None):
        return self._graph.apply(inputs, training=training,
                                 generator=generator)

    def compute_output_shape(self, input_shape):
        shapes = [v.shape for v in self.outputs]
        return shapes[0] if len(shapes) == 1 else shapes
