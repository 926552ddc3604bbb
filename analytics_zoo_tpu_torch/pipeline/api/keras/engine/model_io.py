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
refused, and a JAX class the port does not have raises
``NotImplementedError`` naming ROADMAP's queue of what is not ported.

Layers whose configs hold arbitrary callables (``Lambda``, a callable
activation) cannot be saved by definition. The JAX package pickles such
a model object whole (``architecture.pkl``); the port pickles its own
format there instead (:data:`PICKLE_FORMAT`): the same spec, with each
callable kept as the object pickle stores by reference. The loader reads
it through a restricted ``Unpickler`` (:func:`load_pickled_spec`) that
refuses, before importing anything, every class of JAX, optax, flax and
the JAX package (so a JAX package's pickle is refused with a clear
error) and the modules that reach the operating system.
"""

from __future__ import annotations

import importlib
import io
import logging
import pickle
import types
from typing import Any, Dict, List

import numpy as np

from .....utils.serialization import to_numpy

logger = logging.getLogger("analytics_zoo_tpu_torch.model_io")

FORMAT = "zoo-tpu-graph-v1"
PICKLE_FORMAT = "zoo-tpu-torch-graph-pickle-v1"
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


def port_class(path: str):
    """The port's class for a class path a file holds (a JAX package
    path). Refuses any prefix but ``analytics_zoo_tpu.``; raises
    ``NotImplementedError`` for a class the port lacks (every JAX module
    has its port but those ROADMAP's queue A names)."""
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
            f"{path} has no class in the port; ROADMAP's queue A names "
            "the JAX code that is not ported")
    return cls


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{file_module(cls.__module__)}.{cls.__qualname__}"


def _encode(value, arrays: Dict[str, np.ndarray], path: str,
            pickled: bool = False):
    from .base import KerasLayer

    def enc(v, p):
        return _encode(v, arrays, p, pickled)

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, KerasLayer):
        return {"__layer__": _layer_spec(value, arrays, pickled)}
    if isinstance(value, np.ndarray) or hasattr(value, "__array__") and \
            not isinstance(value, (list, tuple, dict)):
        key = f"{path}_{len(arrays)}"
        arrays[key] = to_numpy(value)
        return {"__ndarray__": key}
    if isinstance(value, tuple):
        return {"__tuple__": [enc(v, path) for v in value]}
    if isinstance(value, list):
        return [enc(v, path) for v in value]
    if isinstance(value, dict):
        return {str(k): enc(v, f"{path}.{k}") for k, v in value.items()}
    if pickled:
        return {"__object__": value}
    raise UnserializableConfig(
        f"config entry {path!r} of type {type(value).__name__} cannot be "
        "serialized definition-wise (the graph is saved by pickle)")


def _decode(value, arrays: Dict[str, np.ndarray]):
    if isinstance(value, dict):
        if "__ndarray__" in value:
            return arrays[value["__ndarray__"]]
        if "__tuple__" in value:
            return tuple(_decode(v, arrays) for v in value["__tuple__"])
        if "__layer__" in value:
            return _build_layer(value["__layer__"], arrays)
        if "__object__" in value:
            return value["__object__"]
        return {k: _decode(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, arrays) for v in value]
    return value


def _layer_spec(layer, arrays, pickled=False) -> Dict[str, Any]:
    cfg = layer.get_config()
    return {"class": _class_path(layer), "name": layer.name,
            "config": {k: _encode(v, arrays, f"{layer.name}.{k}", pickled)
                       for k, v in cfg.items()}}


def _build_layer(spec: Dict[str, Any], arrays):
    cls = port_class(spec["class"])
    config = {k: _decode(v, arrays) for k, v in spec["config"].items()}
    config["name"] = spec["name"]
    return cls.from_config(config)


def graph_to_spec(graph, name: str, pickled: bool = False):
    """GraphFunction -> (json-able spec, sidecar arrays); with ``pickled``
    a config entry JSON cannot hold stays the object itself, for
    :func:`dump_pickled_spec`."""
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
        "layers": [_layer_spec(layer, arrays, pickled)
                   for layer in graph.layers],
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


# -- the pickled architecture ------------------------------------------------

#: top-level packages a port pickle never names: JAX's, and the JAX
#: package's (``analytics_zoo_tpu``, not ``analytics_zoo_tpu_torch``)
_JAX_PACKAGES = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")
#: modules that reach the operating system or evaluate code
_REFUSED_MODULES = ("os", "posix", "nt", "subprocess", "sys", "shutil",
                    "socket", "importlib", "runpy", "pty", "code",
                    "multiprocessing", "ctypes", "pickle", "marshal")
_REFUSED_BUILTINS = ("eval", "exec", "compile", "__import__", "open",
                     "getattr", "setattr", "delattr", "globals", "locals",
                     "vars", "input", "breakpoint", "exit", "quit")


class PortUnpickler(pickle.Unpickler):
    """Resolves a class only after checking its module: a JAX or JAX
    package class raises ``pickle.UnpicklingError`` naming it, before its
    module is imported."""

    def __init__(self, file, what: str):
        super().__init__(file)
        self.what = what

    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_PACKAGES:
            raise pickle.UnpicklingError(
                f"{self.what} was pickled by the JAX package (it names "
                f"{module}.{name}); the port reads only its own pickled "
                "architectures: rebuild the model in the port, or save it "
                "from the JAX package by definition (architecture.json)")
        self._check(module, name)
        obj = super().find_class(module, name)
        # a dotted name can reach through an allowed module to another
        # one's object: check where the object itself lives
        if isinstance(obj, types.ModuleType):
            raise pickle.UnpicklingError(
                f"{self.what}: refusing to load the module {module}.{name}")
        self._check(getattr(obj, "__module__", None) or "",
                    getattr(obj, "__name__", name))
        return obj

    def _check(self, module, name):
        top = module.split(".")[0]
        if top in _JAX_PACKAGES or top in _REFUSED_MODULES or (
                top == "builtins" and name in _REFUSED_BUILTINS):
            raise pickle.UnpicklingError(
                f"{self.what}: refusing to load {module}.{name}")


def dump_pickled_spec(graph, name: str) -> bytes:
    """The port's pickled architecture of ``graph``; raises
    ``UnserializableConfig`` when a config entry cannot be pickled (a
    lambda, a closure) or :class:`PortUnpickler` would refuse what was
    pickled (a builtin reached through ``getattr``), so what saves
    loads."""
    spec, arrays = graph_to_spec(graph, name, pickled=True)
    hint = "pass module-level functions to Lambda and the activations"
    try:
        raw = pickle.dumps({"format": PICKLE_FORMAT, "spec": spec,
                            "arrays": arrays})
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise UnserializableConfig(
            f"model {name!r} holds a config entry that cannot be pickled "
            f"({e}); {hint}") from e
    try:
        load_pickled_spec(raw, f"model {name!r}")
    except pickle.UnpicklingError as e:
        raise UnserializableConfig(f"{e}; {hint}") from e
    return raw


def load_pickled_spec(raw: bytes, what: str):
    """(spec, arrays) of a :func:`dump_pickled_spec` file."""
    blob = PortUnpickler(io.BytesIO(raw), what).load()
    if not isinstance(blob, dict) or blob.get("format") != PICKLE_FORMAT:
        raise ValueError(f"{what} is not a pickled architecture of the "
                         "port")
    return blob["spec"], blob["arrays"]
