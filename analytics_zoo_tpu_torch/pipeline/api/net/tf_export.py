"""``KerasNet.export_tf``: a model as a TensorFlow SavedModel, written
without TensorFlow.

The JAX package exports through ``jax2tf`` (``topology.py:420-462``,
parity ``saveToTf``, Topology.scala:568), which converts any graph. The
card's machine has no TensorFlow, so the port writes the TF ops itself:
each layer of the model's graph becomes GraphDef nodes with its weights
as Consts, and the graph is saved as ``path/saved_model.pb`` (one
MetaGraphDef tagged ``serve`` with a ``serving_default`` predict
signature) beside an empty ``path/variables/``: the TF1 layout, which
``tf.saved_model.load`` loads and ``TFNet.from_saved_model`` reads back
with no TensorFlow. The weights are frozen in the graph, as a frozen
GraphDef holds them.

Layers written: ``Dense``, ``Activation`` (and the activations of Dense
and Convolution2D), ``Convolution2D`` (th/tf, same/valid, strides,
dilation), ``BatchNormalization`` (inference, with the moving
statistics), ``MaxPooling2D``, ``AveragePooling2D``,
``GlobalAveragePooling2D``, ``GlobalMaxPooling2D``, ``ZeroPadding2D``,
``Flatten``, ``Reshape``, ``Dropout`` (the identity) and the ``Merge``
layers (``Add``, ``Concatenate``, and the sum, mul, max, min, concat
modes). Any other layer raises ``NotImplementedError`` naming it.

TF's CPU kernels refuse NCHW convolutions, so a "th" (NCHW) model gets
one ``Transpose`` to NHWC where its first convolution, pooling or batch
norm needs it, NHWC ops after it, and a ``Transpose`` back where a
layer reads the NCHW order (``Flatten``, ``Reshape``, ``Dense``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import graphdef as gd

F32 = gd.type_attr(gd.DT_FLOAT)
I32 = gd.type_attr(gd.DT_INT32)

#: activation name -> the TF ops that compute it (op names, applied in
#: order; "" is the identity)
_ACTIVATION_OPS = {
    "relu": "Relu", "relu6": "Relu6", "tanh": "Tanh", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softplus": "Softplus", "softsign": "Softsign",
    "linear": "", "elu": "Elu", "selu": "Selu", "exp": "Exp",
    "log": "Log", "log_softmax": "LogSoftmax", "square": "Square",
    "sqrt": "Sqrt", "abs": "Abs",
}

# the 4-D layout a tensor is held in: "nhwc" holds a logical NCHW tensor
# transposed to NHWC; "plain" is the model's own layout
_PLAIN, _HELD = "plain", "nhwc"


class _Writer:
    """Appends NodeDefs in topological order."""

    def __init__(self):
        self.nodes: List[Dict[str, Any]] = []
        self.names: Dict[str, int] = {}

    def unique(self, name: str) -> str:
        n = self.names.get(name, 0)
        self.names[name] = n + 1
        return name if n == 0 else f"{name}_{n}"

    def node(self, op: str, name: str, inputs=(), **attrs) -> str:
        name = self.unique(name)
        self.nodes.append({"name": name, "op": op, "input": list(inputs),
                           "attr": {k: v if isinstance(v, dict)
                                    else gd.make_attr(v)
                                    for k, v in attrs.items()}})
        return name

    def const(self, name: str, value) -> str:
        arr = np.ascontiguousarray(value)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return self.node("Const", name, dtype=gd.type_attr(
            gd.DTYPE_CODES[arr.dtype]), value=arr)

    def ints(self, name: str, values) -> str:
        return self.const(name, np.asarray(values, np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _act_name(fn) -> Optional[str]:
    if fn is None:
        return "linear"
    return getattr(fn, "name", None)


class _Exporter:
    def __init__(self, model, batch_size: Optional[int] = None):
        self.graph = model.graph_function()
        self.batch_size = batch_size
        self.w = _Writer()
        # Variable key -> (TF tensor name, the layout it is held in)
        self.vals: Dict[int, Tuple[str, str]] = {}
        self._moved: Dict[Tuple[str, str], str] = {}

    # -- layouts ----------------------------------------------------------
    def held(self, v) -> str:
        """``v`` (a logical NCHW 4-D tensor) held as NHWC."""
        name, layout = self.vals[self._key(v)]
        if layout == _HELD:
            return name
        key = (name, _HELD)
        if key not in self._moved:
            self._moved[key] = self.w.node(
                "Transpose", name + "/to_nhwc",
                [name, self.w.ints(name + "/to_nhwc/perm", [0, 2, 3, 1])],
                T=F32, Tperm=I32)
        return self._moved[key]

    def plain(self, v) -> str:
        """``v`` in the model's own layout."""
        name, layout = self.vals[self._key(v)]
        if layout == _PLAIN:
            return name
        key = (name, _PLAIN)
        if key not in self._moved:
            self._moved[key] = self.w.node(
                "Transpose", name + "/to_nchw",
                [name, self.w.ints(name + "/to_nchw/perm", [0, 3, 1, 2])],
                T=F32, Tperm=I32)
        return self._moved[key]

    def layout(self, v) -> str:
        return self.vals[self._key(v)][1]

    @staticmethod
    def _key(v):
        return v.id if v.node is None else (v.node.id, v.index)

    def nhwc(self, v, th: bool) -> str:
        """The NHWC tensor a layer of ordering ``th`` reads."""
        return self.held(v) if th else self.plain(v)

    # -- layers -----------------------------------------------------------
    def activation(self, name: str, x: str, fn) -> str:
        act = _act_name(fn)
        if act not in _ACTIVATION_OPS:
            raise NotImplementedError(
                f"export_tf: activation {fn!r} of {name} has no TF export "
                "here")
        op = _ACTIVATION_OPS[act]
        return self.w.node(op, f"{name}/{op}", [x], T=F32) if op else x

    def export(self):
        from ..keras.layers import convolutional, core, normalization, \
            pooling
        from ..keras.layers.merge import Merge

        w = self.w
        inputs, outputs = [], []
        for v in self.graph.inputs:
            shape = [self.batch_size] + list(v.shape[1:])
            ph = w.node("Placeholder", v.name, dtype=F32,
                        shape={"shape": gd.shape_proto(shape)})
            self.vals[v.id] = (ph, _PLAIN)
            inputs.append((v.name, ph, shape))
        for node in self.graph.nodes:
            layer, ins, name = node.layer, node.inputs, node.layer.name
            out_layout = _PLAIN
            if isinstance(layer, convolutional.Convolution2D) and type(
                    layer).__name__ in ("Convolution2D",
                                        "AtrousConvolution2D"):
                th = layer.dim_ordering == "th"
                x = self.nhwc(ins[0], th)
                sh, sw = layer.subsample
                dh, dw = layer.dilation
                y = w.node("Conv2D", f"{name}/Conv2D",
                           [x, w.const(f"{name}/kernel", _np(layer.kernel))],
                           T=F32, strides=[1, sh, sw, 1],
                           padding=layer.border_mode.upper(),
                           data_format="NHWC", dilations=[1, dh, dw, 1])
                if layer.use_bias:
                    y = w.node("BiasAdd", f"{name}/BiasAdd",
                               [y, w.const(f"{name}/bias", _np(layer.bias))],
                               T=F32, data_format="NHWC")
                y = self.activation(name, y, layer.activation)
                out_layout = _HELD if th else _PLAIN
            elif isinstance(layer, normalization.BatchNormalization):
                rank = len(ins[0].shape)
                axis = layer.axis % rank
                gamma, beta = _np(layer.gamma), _np(layer.beta)
                mean, var = _np(layer.moving_mean), _np(layer.moving_var)
                if rank == 4 and axis in (1, 3):
                    x = self.held(ins[0]) if axis == 1 else \
                        self.plain(ins[0])
                    y = w.node("FusedBatchNormV3", f"{name}/FusedBatchNormV3",
                               [x] + [w.const(f"{name}/{k}", a) for k, a in (
                                   ("gamma", gamma), ("beta", beta),
                                   ("moving_mean", mean),
                                   ("moving_var", var))],
                               T=F32, U=F32, epsilon=float(layer.epsilon),
                               data_format="NHWC", is_training=False)
                    out_layout = _HELD if axis == 1 else _PLAIN
                elif axis == rank - 1:
                    scale = gamma / np.sqrt(var + np.float32(layer.epsilon))
                    shift = beta - mean * scale
                    y = w.node("Mul", f"{name}/mul",
                               [self.plain(ins[0]),
                                w.const(f"{name}/scale", scale)], T=F32)
                    y = w.node("AddV2", f"{name}/add",
                               [y, w.const(f"{name}/shift", shift)], T=F32)
                else:
                    raise NotImplementedError(
                        f"export_tf: {name} normalizes axis {layer.axis} "
                        f"of a rank-{rank} input")
            elif isinstance(layer, pooling.MaxPooling2D):
                th = layer.dim_ordering == "th"
                ph, pw = layer.pool_size
                sh, sw = layer.strides
                op = "MaxPool" if layer.mode == "max" else "AvgPool"
                y = w.node(op, f"{name}/{op}", [self.nhwc(ins[0], th)],
                           T=F32, ksize=[1, ph, pw, 1],
                           strides=[1, sh, sw, 1],
                           padding=layer.border_mode.upper(),
                           data_format="NHWC")
                out_layout = _HELD if th else _PLAIN
            elif isinstance(layer, pooling.GlobalMaxPooling2D):
                th = layer.dim_ordering == "th"
                op = "Mean" if isinstance(
                    layer, pooling.GlobalAveragePooling2D) else "Max"
                y = w.node(op, f"{name}/{op}",
                           [self.nhwc(ins[0], th),
                            w.ints(f"{name}/axes", [1, 2])],
                           T=F32, Tidx=I32, keep_dims=False)
            elif isinstance(layer, convolutional.ZeroPadding2D):
                th = layer.dim_ordering == "th"
                (t, b), (l, r) = layer.padding
                y = w.node("Pad", f"{name}/Pad",
                           [self.nhwc(ins[0], th),
                            w.ints(f"{name}/paddings",
                                   [[0, 0], [t, b], [l, r], [0, 0]])],
                           T=F32, Tpaddings=I32)
                out_layout = _HELD if th else _PLAIN
            elif isinstance(layer, (core.Flatten, core.Reshape)):
                rest = list(layer.compute_output_shape(ins[0].shape)[1:])
                y = w.node("Reshape", f"{name}/Reshape",
                           [self.plain(ins[0]),
                            w.ints(f"{name}/shape", [-1] + [
                                int(d) for d in rest])],
                           T=F32, Tshape=I32)
            elif isinstance(layer, core.Dense):
                x = self.plain(ins[0])
                kernel = w.const(f"{name}/kernel", _np(layer.kernel))
                if len(ins[0].shape) == 2:
                    y = w.node("MatMul", f"{name}/MatMul", [x, kernel],
                               T=F32, transpose_a=False, transpose_b=False)
                else:
                    y = w.node("BatchMatMulV2", f"{name}/MatMul",
                               [x, kernel], T=F32, adj_x=False, adj_y=False)
                if layer.use_bias:
                    y = w.node("BiasAdd", f"{name}/BiasAdd",
                               [y, w.const(f"{name}/bias", _np(layer.bias))],
                               T=F32, data_format="NHWC")
                y = self.activation(name, y, layer.activation)
            elif isinstance(layer, core.Activation):
                # elementwise ops run in the held layout; a softmax reads
                # the model's last axis
                x, out_layout = self.vals[self._key(ins[0])]
                if _ACTIVATION_OPS.get(_act_name(layer.fn)) in (
                        "Softmax", "LogSoftmax"):
                    x, out_layout = self.plain(ins[0]), _PLAIN
                y = self.activation(name, x, layer.fn)
            elif isinstance(layer, core.Dropout):
                y, out_layout = self.vals[self._key(ins[0])]
            elif isinstance(layer, Merge):
                y, out_layout = self.merge(layer, ins)
            else:
                raise NotImplementedError(
                    f"export_tf: {type(layer).__name__} ({name}) has no TF "
                    "export; the exporter writes Dense, Activation, "
                    "Convolution2D, BatchNormalization, the 2-D poolings, "
                    "ZeroPadding2D, Flatten, Reshape, Dropout and Merge")
            self.vals[(node.id, 0)] = (y, out_layout)
        for i, v in enumerate(self.graph.outputs):
            out = w.node("Identity", f"output_{i}", [self.plain(v)], T=F32)
            outputs.append((f"output_{i}", out,
                            [self.batch_size] + list(v.shape[1:])))
        return inputs, outputs

    def merge(self, layer, ins):
        w, name, mode = self.w, layer.name, layer.mode
        rank = len(ins[0].shape)
        held = rank == 4 and all(self.layout(v) == _HELD for v in ins)
        xs = [self.held(v) if held else self.plain(v) for v in ins]
        layout = _HELD if held else _PLAIN
        if mode == "concat":
            axis = layer.concat_axis % rank
            if held:
                axis = {0: 0, 1: 3, 2: 1, 3: 2}[axis]
            return w.node("ConcatV2", f"{name}/concat",
                          xs + [w.ints(f"{name}/axis", axis)],
                          T=F32, N=len(xs), Tidx=I32), layout
        ops = {"sum": "AddV2", "add": "AddV2", "mul": "Mul",
               "max": "Maximum", "min": "Minimum"}
        if mode not in ops:
            raise NotImplementedError(
                f"export_tf: Merge mode {mode!r} ({name}) has no TF export")
        y = xs[0]
        for i, x in enumerate(xs[1:]):
            y = w.node(ops[mode], f"{name}/{ops[mode]}_{i}", [y, x], T=F32)
        return y, layout


def export_savedmodel(model, path: str,
                      batch_size: Optional[int] = None) -> str:
    """Write ``model``'s inference graph to ``path`` as a SavedModel
    (``saved_model.pb`` and an empty ``variables/``); the inputs' batch
    dim is ``batch_size``, unknown when None."""
    exporter = _Exporter(model, batch_size)
    inputs, outputs = exporter.export()
    graph_def = {"node": exporter.w.nodes, "versions": {"producer": 1087}}
    sig = {"inputs": {key: {"name": f"{t}:0", "dtype": gd.DT_FLOAT,
                            "tensor_shape": gd.shape_proto(shape)}
                      for key, t, shape in inputs},
           "outputs": {key: {"name": f"{t}:0", "dtype": gd.DT_FLOAT,
                             "tensor_shape": gd.shape_proto(shape)}
                       for key, t, shape in outputs},
           "method_name": "tensorflow/serving/predict"}
    saved = {"saved_model_schema_version": 1,
             "meta_graphs": [{"meta_info_def": {"tags": ["serve"]},
                              "graph_def": graph_def,
                              "signature_def": {"serving_default": sig}}]}
    os.makedirs(os.path.join(path, "variables"), exist_ok=True)
    with open(os.path.join(path, "saved_model.pb"), "wb") as f:
        f.write(gd.encode(saved, "SavedModel"))
    return path
