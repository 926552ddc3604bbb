"""ONNX graph -> the port's Keras ``Model``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/onnx_loader.py``:
the graph becomes one :class:`GraphModule` layer, an interpreter over the
node list, wrapped in a functional ``Model`` with the whole
``compile/fit/evaluate/predict`` surface. Float initializers are
trainable parameters under their ONNX names (a "." in a name becomes
"_", as ``nn.Module`` refuses it; :meth:`GraphModule.load_jax_params`
maps JAX's names). Shape-machinery initializers (Reshape targets, axes,
pad amounts) and every integer initializer stay host constants.

The JAX layer decodes each node's attributes and folds the constant
shape subgraph on every call, which XLA's tracing pays once. Eager torch
would pay it on every request, so here the attributes are decoded and
the nodes split once, at construction: a node is *host* when all its
inputs are host values (constants, or outputs of host nodes) or it is a
``Shape``/``Size``; every other node runs on the activations' device.
Host values depend on nothing but the input shapes, so they are computed
at the first call for each input signature (nodes of constants alone at
construction) and kept, with the constants the device nodes read already
on that device; later calls of that signature run only the device nodes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..keras.engine.base import Input, KerasLayer
from ..keras.models import Model
from . import proto
from .ops import REGISTRY, STATIC_ARGS, TORCH_DTYPES, _host, _t

# input signatures whose host values a GraphModule keeps
SIGNATURE_CACHE = 64


class OnnxIR:
    """Decoded and classified ONNX graph."""

    def __init__(self, model: proto.Msg):
        self.model = model
        graph = model["graph"]
        self.graph = graph
        self.nodes = list(graph.get("node", []))
        self.initializers: Dict[str, np.ndarray] = {
            t["name"]: proto.tensor_to_numpy(t)
            for t in graph.get("initializer", [])}
        self.input_infos = [vi for vi in graph.get("input", [])
                            if vi["name"] not in self.initializers]
        self.output_names = [vi["name"] for vi in graph.get("output", [])]

        # names that must stay host constants (consumed at a static position)
        static = set()
        for node in self.nodes:
            for idx in STATIC_ARGS.get(node.get("op_type", ""), ()):
                ins = node.get("input", [])
                if idx < len(ins) and ins[idx] in self.initializers:
                    static.add(ins[idx])
        # integer/bool initializers are shape machinery, never weights
        for name, arr in self.initializers.items():
            if not np.issubdtype(arr.dtype, np.floating):
                static.add(name)
        self.static_names = static
        self.param_names = [n for n in self.initializers if n not in static]

        unsupported = sorted({n.get("op_type", "?") for n in self.nodes
                              if n.get("op_type") not in REGISTRY})
        if unsupported:
            raise NotImplementedError(
                f"unsupported ONNX ops: {unsupported}")

    def input_shapes(self) -> List[tuple]:
        shapes = []
        for vi in self.input_infos:
            dims = vi["type"]["tensor_type"].get(
                "shape", {}).get("dim", [])
            shape = tuple(
                None if ("dim_param" in d or "dim_value" not in d)
                else int(d["dim_value"]) for d in dims)
            shapes.append(shape)
        return shapes

    def input_elem_types(self) -> List[int]:
        return [vi["type"]["tensor_type"].get("elem_type", 1)
                for vi in self.input_infos]


def _param_key(name: str) -> str:
    return name.replace(".", "_")


class _Node:
    __slots__ = ("op_type", "fn", "attrs", "inputs", "outputs", "static",
                 "host")

    def __init__(self, node: proto.Msg):
        self.op_type = node["op_type"]
        self.fn = REGISTRY[self.op_type]
        self.attrs = {a["name"]: proto.attr_value(a)
                      for a in node.get("attribute", [])}
        self.inputs = list(node.get("input", []))
        self.outputs = list(node.get("output", []))
        self.static = set(STATIC_ARGS.get(self.op_type, ()))
        self.host = False


class GraphModule(KerasLayer):
    """A whole foreign graph as one zoo layer."""

    def __init__(self, ir: OnnxIR, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.ir = ir
        self.num_outputs = len(ir.output_names)
        self._keys = {n: _param_key(n) for n in ir.param_names}
        if len(set(self._keys.values())) != len(self._keys):
            raise ValueError("ONNX initializer names collide once '.' "
                             "becomes '_'")
        self._input_types = [TORCH_DTYPES.get(t, torch.float32)
                             for t in ir.input_elem_types()]
        self._nodes = [_Node(n) for n in ir.nodes]
        # host classification and the constants folded now
        const: Dict[str, Any] = {n: ir.initializers[n]
                                 for n in ir.static_names}
        host = set(const)
        for node in self._nodes:
            ins = [n for n in node.inputs if n]
            if node.op_type in ("Shape", "Size") or all(
                    n in host for n in ins):
                node.host = True
                host.update(node.outputs)
                if all(n in const for n in ins):
                    for out, val in zip(node.outputs,
                                        self._run_host(node, const)):
                        if out:
                            const[out] = val
        self._const = const
        self._signatures: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()

    # -- parameters -------------------------------------------------------
    def build(self, generator, input_shape):
        return {self._keys[n]: torch.from_numpy(
                    np.array(self.ir.initializers[n], np.float32))
                for n in self.ir.param_names}

    def load_jax_params(self, tree) -> None:
        """Copy the JAX ``GraphModule``'s params (keyed by ONNX name)."""
        from ....utils.jax_weights import _copy_leaves
        _copy_leaves(self, self.name,
                     {self._keys.get(k, k): v for k, v in tree.items()},
                     dict(self.named_parameters()), "params")

    # -- interpretation ---------------------------------------------------
    @staticmethod
    def _run_host(node: _Node, env: Dict[str, Any]) -> List[np.ndarray]:
        """A host node on CPU tensors; its outputs as numpy."""
        ins = [env[n] if n else None for n in node.inputs]
        return [_host(o) if isinstance(o, torch.Tensor) else np.asarray(o)
                for o in node.fn(node.attrs, ins)]

    def _run(self, inputs, params: Dict[str, torch.Tensor]):
        ir = self.ir
        inputs = [x if torch.is_floating_point(x) == dt.is_floating_point
                  else x.to(dt) for x, dt in zip(inputs, self._input_types)]
        key = (str(inputs[0].device) if inputs else "",) + tuple(
            (tuple(x.shape), x.dtype) for x in inputs)
        env: Dict[str, Any] = {k: params[v] for k, v in self._keys.items()}
        env.update((vi["name"], x) for vi, x in zip(ir.input_infos, inputs))
        entry = self._signatures.get(key)
        if entry is None:
            return self._first_run(inputs, env, key)
        self._signatures.move_to_end(key)
        fed = entry["fed"]
        for i, node in enumerate(self._nodes):
            if node.host:
                continue
            ins = [env[n] if c is None and n else c
                   for n, c in zip(node.inputs, fed[i])]
            for out, val in zip(node.outputs, node.fn(node.attrs, ins)):
                if out:
                    env[out] = val
        host = entry["host"]
        return [env[n] if n in env else host[n] for n in ir.output_names]

    def _first_run(self, inputs, env, key):
        """The first call of a signature: host nodes run as they come
        (a ``Shape`` of an activation reads the activation's shape), and
        their values are kept for the next call of this signature."""
        ir = self.ir
        device = inputs[0].device if inputs else torch.device("cpu")
        host: Dict[str, Any] = dict(self._const)
        fed: Dict[int, list] = {}
        for i, node in enumerate(self._nodes):
            if node.host:
                if not all(o in host for o in node.outputs if o):
                    look = dict(host)
                    for n in node.inputs:
                        if n and n not in look:
                            look[n] = torch.empty(tuple(env[n].shape),
                                                  device="meta")
                    for out, val in zip(node.outputs,
                                        self._run_host(node, look)):
                        if out:
                            host[out] = val
                continue
            consts = []
            for pos, n in enumerate(node.inputs):
                if n and n in host:
                    v = host[n]
                    if pos not in node.static:
                        v = _t(v, device)
                    consts.append(v)
                else:
                    consts.append(None)
            fed[i] = consts
            ins = [env[n] if c is None and n else c
                   for n, c in zip(node.inputs, consts)]
            for out, val in zip(node.outputs, node.fn(node.attrs, ins)):
                if out:
                    env[out] = val
        self._signatures[key] = {"fed": fed, "host": host}
        if len(self._signatures) > SIGNATURE_CACHE:
            self._signatures.popitem(last=False)
        return [env[n] if n in env else host[n] for n in ir.output_names]

    def forward(self, inputs, training=False, **kwargs):
        xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        params = {k: getattr(self, k) for k in self._keys.values()}
        outs = self._run(xs, params)
        outs = [o if isinstance(o, torch.Tensor) else torch.as_tensor(o)
                for o in outs]
        return outs[0] if self.num_outputs == 1 else tuple(outs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        xs = [torch.empty(tuple(1 if d is None else d for d in s),
                          dtype=dt, device="meta")
              for s, dt in zip(shapes, self._input_types)]
        params = {k: torch.empty(self.ir.initializers[n].shape,
                                 device="meta")
                  for n, k in self._keys.items()}
        outs = self._run(xs, params)
        result = [(None,) + tuple(o.shape[1:]) for o in outs]
        return result[0] if self.num_outputs == 1 else result

    # the layer serializes as the re-encoded ONNX bytes
    def get_config(self):
        return {"onnx_bytes": np.frombuffer(proto.encode(self.ir.model),
                                            np.uint8)}

    @classmethod
    def from_config(cls, config):
        raw = config["onnx_bytes"]
        if not isinstance(raw, (bytes, bytearray)):
            raw = np.asarray(raw, np.uint8).tobytes()
        return cls(OnnxIR(proto.decode(bytes(raw))))


class OnnxLoader:
    """``OnnxLoader(model_proto).to_keras()`` /
    ``OnnxLoader.from_path(path)`` (pyzoo onnx_loader.py)."""

    def __init__(self, model: proto.Msg):
        self.ir = OnnxIR(model)

    @classmethod
    def from_path(cls, path: str) -> Model:
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> Model:
        return cls(proto.decode(data)).to_keras()

    def to_keras(self) -> Model:
        module = GraphModule(self.ir)
        in_vars = [Input(shape=tuple(s[1:]) if len(s) > 1 else (1,),
                         name=vi["name"])
                   for s, vi in zip(self.ir.input_shapes(),
                                    self.ir.input_infos)]
        outs = module(in_vars if len(in_vars) > 1 else in_vars[0])
        return Model(in_vars, list(outs) if isinstance(outs, tuple)
                     else outs)


def load_onnx(path: str) -> Model:
    return OnnxLoader.from_path(path)
