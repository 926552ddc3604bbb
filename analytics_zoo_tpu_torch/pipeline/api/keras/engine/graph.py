"""Symbolic tensor graph.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/graph.py``.
A :class:`Variable` is the symbolic tensor: calling a layer on Variables
records a :class:`Node`, and ``Model(inputs, outputs)`` turns the DAG
into a :class:`GraphFunction` that builds every distinct layer once and
evaluates the nodes in topological order. PyTorch runs eagerly, so
``apply`` is a plain Python walk over the nodes, and a layer owns its
parameters (it is an ``nn.Module``) instead of receiving a params pytree.
The autograd operator sugar on Variables arrives with the autograd port.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

_id_counter = itertools.count()


class Node:
    """One invocation of a layer on a list of input Variables. A layer
    called twice (weight sharing) produces two Nodes referencing the same
    layer object."""

    def __init__(self, layer, inputs: Sequence["Variable"]):
        self.layer = layer
        self.inputs = list(inputs)
        self.id = next(_id_counter)


class Variable:
    """A symbolic tensor: one output of a :class:`Node` (or a graph
    input). ``shape`` includes the batch dimension as ``None``."""

    def __init__(self, node: Optional[Node], shape, index: int = 0,
                 name: Optional[str] = None):
        self.node = node
        self.shape = tuple(shape)
        self.index = index
        self.id = next(_id_counter)
        if name:
            self.name = name
        elif node is not None:
            self.name = f"{node.layer.name}_out{index}"
        else:
            self.name = f"var_{self.id}"

    @property
    def is_input(self) -> bool:
        return self.node is None

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape})"


def topological_nodes(outputs: Sequence[Variable]) -> List[Node]:
    """Iterative post-order DFS over the Node DAG; returns compute order."""
    order: List[Node] = []
    visited = set()
    stack: List[Tuple[Node, bool]] = []
    for v in reversed(list(outputs)):
        if v.node is not None:
            stack.append((v.node, False))
    while stack:
        node, expanded = stack.pop()
        if node.id in visited:
            continue
        if expanded:
            visited.add(node.id)
            order.append(node)
        else:
            stack.append((node, True))
            for parent_var in reversed(node.inputs):
                if parent_var.node is not None and \
                        parent_var.node.id not in visited:
                    stack.append((parent_var.node, False))
    return order


class GraphFunction:
    """Executable form of a Variable DAG.

    ``init(generator)`` builds every distinct layer's parameters once
    (layer sharing == weight sharing); ``apply(inputs, ...)`` evaluates
    the DAG."""

    def __init__(self, inputs: Sequence[Variable],
                 outputs: Sequence[Variable]):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.nodes = topological_nodes(self.outputs)
        input_ids = {v.id for v in self.inputs}
        for node in self.nodes:
            for pv in node.inputs:
                if pv.node is None and pv.id not in input_ids:
                    raise ValueError(
                        f"Variable {pv.name} is a free input not listed in "
                        "the model's inputs")
        for v in self.outputs:
            if v.node is None and v.id not in input_ids:
                raise ValueError(f"output {v.name} is not reachable")
        # Distinct layers in deterministic (topological) order.
        self.layers = []
        seen = set()
        for node in self.nodes:
            if id(node.layer) not in seen:
                seen.add(id(node.layer))
                self.layers.append(node.layer)

    # ------------------------------------------------------------------
    def init(self, generator) -> None:
        """Build each distinct layer once, keyed by ``layer.name``; the
        layer keeps its parameters (``KerasLayer.build_params``). A layer
        built before (in another graph over it) keeps its parameters."""
        built = set()
        names: Dict[str, Any] = {}
        for node in self.nodes:
            layer = node.layer
            if id(layer) in built:
                continue
            built.add(id(layer))
            if layer.name in names:
                raise ValueError(f"two layers named {layer.name!r}")
            names[layer.name] = layer
            if layer.built:
                continue
            in_shapes = [p.shape for p in node.inputs]
            in_shape = in_shapes[0] if len(in_shapes) == 1 else in_shapes
            layer.build_params(generator, in_shape)

    def apply(self, inputs, training: bool = False, generator=None):
        """Evaluate. ``generator`` feeds the stochastic layers (dropout)
        when ``training``."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if len(inputs) != len(self.inputs):
            raise ValueError(
                f"Model expects {len(self.inputs)} inputs, got {len(inputs)}")
        values: Dict[int, Any] = {v.id: val
                                  for v, val in zip(self.inputs, inputs)}
        node_outs: Dict[int, Any] = {}

        def var_value(v: Variable):
            if v.id in values:
                return values[v.id]
            out = node_outs[v.node.id]
            if v.node.layer.num_outputs > 1:
                return out[v.index]
            return out

        for node in self.nodes:
            layer = node.layer
            xs = [var_value(p) for p in node.inputs]
            x = xs[0] if len(xs) == 1 else xs
            kwargs: Dict[str, Any] = {}
            if layer.stochastic:
                kwargs["generator"] = generator
            node_outs[node.id] = layer(x, training=training, **kwargs)
        outs = [var_value(v) for v in self.outputs]
        return outs[0] if len(outs) == 1 else outs
