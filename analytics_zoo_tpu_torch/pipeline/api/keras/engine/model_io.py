"""Definition-based model persistence (no pickle), in the JAX package's
format.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/model_io.py``
(format ``zoo-tpu-graph-v1``): a model is saved as every layer's class
path and captured constructor config (``KerasLayer.get_config``) plus the
Variable DAG's connectivity, as JSON; ndarray-valued config entries go to
a sidecar ``.npz``.

The file names each class by the JAX package's path
(``analytics_zoo_tpu.pipeline.api.keras.layers.core.Dense``): the JAX
loader refuses any class outside ``analytics_zoo_tpu.``, and the port's
modules mirror the JAX package's, so ``analytics_zoo_tpu_torch.<module>``
is written as ``analytics_zoo_tpu.<module>``. Loading maps the prefix back
and imports only the port's module, never a JAX one; any other prefix is
refused, and a JAX class the port does not have yet raises
``NotImplementedError`` naming the ROADMAP item that ports it.

Layers whose configs hold arbitrary callables (``Lambda``, a callable
activation) cannot be saved by definition. The JAX package falls back to
pickle for those graphs; here ``UnserializableConfig`` is raised (the
pickle fallback waits with ``CustomLoss``, ROADMAP A8 and A10).
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Dict, List

import numpy as np

from .....utils.serialization import to_numpy

logger = logging.getLogger("analytics_zoo_tpu_torch.model_io")

FORMAT = "zoo-tpu-graph-v1"
FILE_PREFIX = "analytics_zoo_tpu."
PORT_PREFIX = "analytics_zoo_tpu_torch."


class UnserializableConfig(Exception):
    pass


def file_module(module: str) -> str:
    """The module path a file holds for a port module (the JAX
    package's)."""
    if not module.startswith(PORT_PREFIX):
        raise UnserializableConfig(f"{module} is not a module of the port")
    return FILE_PREFIX + module[len(PORT_PREFIX):]


def _roadmap_item(path: str) -> str:
    if ".models." in path:
        return "A9"
    if ".keras.layers." in path or ".autograd" in path or ".keras2." in path:
        return "A8"
    return "A10"


def port_class(path: str):
    """The port's class for a class path a file holds (a JAX package
    path). Refuses any prefix but ``analytics_zoo_tpu.``; raises
    ``NotImplementedError`` for a class the port lacks."""
    if not path.startswith(FILE_PREFIX):
        raise ValueError(f"refusing to import class {path!r} "
                         f"(outside {FILE_PREFIX})")
    mod_name, _, cls_name = (PORT_PREFIX + path[len(FILE_PREFIX):]
                             ).rpartition(".")
    try:
        module = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        module = None
    cls = getattr(module, cls_name, None)
    if cls is None:
        raise NotImplementedError(
            f"{path} is not ported yet; it arrives with ROADMAP "
            f"{_roadmap_item(path)}")
    return cls


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{file_module(cls.__module__)}.{cls.__qualname__}"


def _encode(value, arrays: Dict[str, np.ndarray], path: str):
    from .base import KerasLayer

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, KerasLayer):
        return {"__layer__": _layer_spec(value, arrays)}
    if isinstance(value, np.ndarray) or hasattr(value, "__array__") and \
            not isinstance(value, (list, tuple, dict)):
        key = f"{path}_{len(arrays)}"
        arrays[key] = to_numpy(value)
        return {"__ndarray__": key}
    if isinstance(value, tuple):
        return {"__tuple__": [_encode(v, arrays, path) for v in value]}
    if isinstance(value, list):
        return [_encode(v, arrays, path) for v in value]
    if isinstance(value, dict):
        return {str(k): _encode(v, arrays, f"{path}.{k}")
                for k, v in value.items()}
    raise UnserializableConfig(
        f"config entry {path!r} of type {type(value).__name__} cannot be "
        "serialized definition-wise; the JAX package pickles such graphs "
        "(Lambda/CustomLoss), which the port does not yet (ROADMAP A8)")


def _decode(value, arrays: Dict[str, np.ndarray]):
    if isinstance(value, dict):
        if "__ndarray__" in value:
            return arrays[value["__ndarray__"]]
        if "__tuple__" in value:
            return tuple(_decode(v, arrays) for v in value["__tuple__"])
        if "__layer__" in value:
            return _build_layer(value["__layer__"], arrays)
        return {k: _decode(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, arrays) for v in value]
    return value


def _layer_spec(layer, arrays) -> Dict[str, Any]:
    cfg = layer.get_config()
    return {"class": _class_path(layer), "name": layer.name,
            "config": {k: _encode(v, arrays, f"{layer.name}.{k}")
                       for k, v in cfg.items()}}


def _build_layer(spec: Dict[str, Any], arrays):
    cls = port_class(spec["class"])
    config = {k: _decode(v, arrays) for k, v in spec["config"].items()}
    config["name"] = spec["name"]
    return cls.from_config(config)


def graph_to_spec(graph, name: str):
    """GraphFunction -> (json-able spec, sidecar arrays)."""
    arrays: Dict[str, np.ndarray] = {}
    var_ids: Dict[int, List] = {}
    spec_inputs = []
    for i, v in enumerate(graph.inputs):
        var_ids[v.id] = ["input", i]
        spec_inputs.append({"shape": list(v.shape[1:]), "name": v.name})

    spec_nodes = []
    for n_idx, node in enumerate(graph.nodes):
        spec_nodes.append({"layer": node.layer.name,
                           "in": [var_ids[pv.id] for pv in node.inputs]})
        # every Variable whose .node is this node maps to
        # ["node", n_idx, index]
        for other in graph.nodes:
            for pv in other.inputs:
                if pv.node is node:
                    var_ids[pv.id] = ["node", n_idx, pv.index]
        for v in graph.outputs:
            if v.node is node:
                var_ids[v.id] = ["node", n_idx, v.index]

    spec = {
        "format": FORMAT,
        "name": name,
        "inputs": spec_inputs,
        "layers": [_layer_spec(layer, arrays) for layer in graph.layers],
        "nodes": spec_nodes,
        "outputs": [var_ids[v.id] for v in graph.outputs],
    }
    return spec, arrays


def spec_to_model(spec: Dict[str, Any], arrays: Dict[str, np.ndarray]):
    """Rebuild a functional ``Model`` from a spec (its layers take the
    file's names; the weights are drawn anew, for the caller to load)."""
    from .base import Input
    from .topology import Model

    if spec.get("format") != FORMAT:
        raise ValueError(f"unknown model format {spec.get('format')!r}")
    layers = {s["name"]: _build_layer(s, arrays) for s in spec["layers"]}
    inputs = [Input(shape=tuple(s["shape"]), name=s["name"])
              for s in spec["inputs"]]
    node_outputs: List[Any] = []

    def resolve(ref):
        if ref[0] == "input":
            return inputs[ref[1]]
        out = node_outputs[ref[1]]
        return out[ref[2]] if isinstance(out, (list, tuple)) else out

    for node_spec in spec["nodes"]:
        xs = [resolve(r) for r in node_spec["in"]]
        node_outputs.append(
            layers[node_spec["layer"]](xs[0] if len(xs) == 1 else xs))
    outputs = [resolve(r) for r in spec["outputs"]]
    return Model(inputs, outputs if len(outputs) > 1 else outputs[0],
                 name=spec.get("name"))
