"""TFNet: TensorFlow graphs inside the port.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/tfnet.py`` (parity:
``zoo/.../pipeline/api/net/TFNet.scala:53``, a frozen graph as a module;
its factories :568-620 from a folder, a ``.pb`` or a SavedModel; and
``TFNetForInference``). Two tiers, as in the JAX package:

1. **Translation (primary):** the GraphDef is read by the port's own
   protobuf reader (``graphdef.py``) and translated op by op into torch
   (:class:`~.tf_graph.TFGraphFunction`), so it runs on the card; the
   float Consts are the layer's trainable parameters.
2. **Host callback (fallback):** a graph with an op outside the registry,
   or ``lower=False``, runs in TensorFlow on the host behind a
   ``torch.autograd.Function`` whose backward asks ``tf.GradientTape``
   for the input gradients (the JAX package: ``custom_vjp`` +
   ``pure_callback``). Its Consts are fixed.

A frozen ``.pb`` (:meth:`TFNet.from_frozen`), and a SavedModel whose graph
holds no variable ops (what ``KerasNet.export_tf`` writes), load with no
TensorFlow: the card's machine has none. ``from_keras`` and
``from_saved_model`` on a SavedModel with variables freeze the graph with
TensorFlow (``convert_variables_to_constants_v2``), then hand its bytes to
the same reader; without TensorFlow they raise ``ImportError`` naming it,
as does the callback tier. Nothing falls back silently.

Parameters are registered under the graph's node names, a "." written
``%2E`` (a module's parameter name holds no "."); :meth:`param_tree`
gives them back under the node names, the JAX params' keys.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..keras.engine.base import KerasLayer
from . import graphdef as gd
from .tf_graph import (TFGraphFunction, UnsupportedTFGraph,
                       graph_inputs_outputs, to_tensor)

#: ops of a SavedModel graph that need TensorFlow's loader (variables,
#: and the function calls of a TF2 SavedModel)
_VARIABLE_OPS = {"VarHandleOp", "VariableV2", "Variable", "ReadVariableOp",
                 "AssignVariableOp", "RestoreV2", "SaveV2",
                 "StatefulPartitionedCall", "PartitionedCall"}


def _tf(what: str):
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"{what} needs TensorFlow, which is not installed here; a "
            "frozen .pb and a SavedModel without variables (what "
            "KerasNet.export_tf writes) load without it") from e
    return tf


def _freeze_concrete(concrete):
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2

    frozen = convert_variables_to_constants_v2(concrete)
    graph_def = frozen.graph.as_graph_def()
    inputs = [t.name for t in frozen.inputs
              if "unknown" not in t.name.lower()] or \
             [t.name for t in frozen.inputs]
    outputs = [t.name for t in frozen.outputs]
    return graph_def.SerializeToString(), inputs, outputs


def _key(name: str) -> str:
    return name.replace("%", "%25").replace(".", "%2E")


class TFNet(KerasLayer):
    """A TF graph as a zoo layer / inference model."""

    def __init__(self, graph_fn: Optional[TFGraphFunction] = None,
                 callback_fn=None, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.graph_fn = graph_fn
        self.__dict__["_callback"] = callback_fn
        #: "torch" for the translated graph, "callback" for TensorFlow on
        #: the host (the JAX layer's "jax"/"callback")
        self.mode = "torch" if graph_fn is not None else "callback"
        self._keys: Dict[str, str] = {}
        self._device = torch.device("cpu")
        if graph_fn is not None:
            self._register(graph_fn.init_params())

    def _register(self, params: Dict[str, torch.Tensor]):
        for name, t in params.items():
            key = _key(name)
            self._keys[name] = key
            self.register_parameter(key, nn.Parameter(
                t, requires_grad=t.is_floating_point()))
        self.built = True

    # ------------------------------------------------------------------
    # factories (TFNet.scala:568-620)
    # ------------------------------------------------------------------
    @classmethod
    def from_path(cls, path: str, **kw) -> "TFNet":
        if os.path.isdir(path):
            if os.path.exists(os.path.join(path, "saved_model.pb")):
                return cls.from_saved_model(path, **kw)
            for fname in os.listdir(path):
                if fname.endswith((".h5", ".keras")):
                    return cls.from_keras(os.path.join(path, fname), **kw)
            raise IOError(f"no TF model found under {path}")
        if path.endswith((".h5", ".keras")):
            return cls.from_keras(path, **kw)
        return cls.from_frozen(path, **kw)

    @classmethod
    def from_frozen(cls, pb_path: str,
                    input_names: Optional[Sequence[str]] = None,
                    output_names: Optional[Sequence[str]] = None,
                    **kw) -> "TFNet":
        """A frozen GraphDef file; its Placeholders are the inputs and the
        nodes nothing consumes the outputs, unless named."""
        with open(pb_path, "rb") as f:
            raw = f.read()
        graph_def = gd.parse_graph_def(raw)
        ins, outs = graph_inputs_outputs(graph_def)
        return cls._from_graph_def(
            graph_def, list(input_names if input_names is not None
                            else ins),
            list(output_names if output_names is not None else outs),
            raw=raw, **kw)

    @classmethod
    def from_saved_model(cls, path: str, signature: str = "serving_default",
                         tag: str = "serve", **kw) -> "TFNet":
        """A SavedModel directory. One whose ``tag`` graph holds no
        variable ops is read by the port with no TensorFlow; any other is
        loaded and frozen by TensorFlow."""
        saved = gd.read_saved_model(path)
        metas = [m for m in saved["meta_graphs"]
                 if tag in m.get("meta_info_def", {}).get("tags", [])] \
            or saved["meta_graphs"]
        meta = metas[0] if metas else None
        graph = meta.get("graph_def") if meta else None
        sigs = meta.get("signature_def", {}) if meta else {}
        if graph is not None and sigs and not any(
                n.get("op") in _VARIABLE_OPS for n in graph["node"]):
            sig = sigs.get(signature) or sigs[sorted(sigs)[0]]
            inputs = [sig["inputs"][k]["name"] for k in sorted(sig["inputs"])]
            outputs = [sig["outputs"][k]["name"]
                       for k in sorted(sig["outputs"])]
            return cls._from_graph_def(graph, inputs, outputs, **kw)
        tf = _tf(f"TFNet.from_saved_model({path!r}) with variables")
        loaded = tf.saved_model.load(path)
        sigs = getattr(loaded, "signatures", {})
        if signature in sigs:
            concrete = sigs[signature]
        elif sigs:
            concrete = next(iter(sigs.values()))
        else:
            raise IOError(f"saved model at {path} has no signatures")
        raw, inputs, outputs = _freeze_concrete(concrete)
        return cls._from_graph_def(gd.parse_graph_def(raw), inputs, outputs,
                                   raw=raw, **kw)

    @classmethod
    def from_keras(cls, h5_path: str, **kw) -> "TFNet":
        """A Keras ``.h5``/``.keras`` file, loaded and frozen by
        TensorFlow."""
        tf = _tf(f"TFNet.from_keras({h5_path!r})")
        model = tf.keras.models.load_model(h5_path, compile=False)
        spec = [tf.TensorSpec((None,) + tuple(i.shape[1:]), i.dtype)
                for i in model.inputs]
        fn = tf.function(lambda *xs: model(list(xs) if len(xs) > 1
                                           else xs[0]))
        concrete = fn.get_concrete_function(*spec)
        raw, inputs, outputs = _freeze_concrete(concrete)
        return cls._from_graph_def(gd.parse_graph_def(raw), inputs, outputs,
                                   raw=raw, **kw)

    @classmethod
    def _from_graph_def(cls, graph_def, input_names, output_names,
                        lower: bool = True,
                        raw: Optional[bytes] = None) -> "TFNet":
        if lower:
            try:
                return cls(graph_fn=TFGraphFunction(
                    graph_def, input_names, output_names))
            except UnsupportedTFGraph:
                pass
        if raw is None:
            raw = gd.encode(graph_def, "GraphDef")
        return cls(callback_fn=_CallbackTF(raw, input_names, output_names))

    # -- parameters -------------------------------------------------------
    def build_params(self, generator, input_shape) -> None:
        self.built = True

    def param_tree(self) -> Dict[str, Any]:
        """The parameters under the graph's node names (the JAX keys)."""
        return {n: getattr(self, k) for n, k in self._keys.items()}

    def load_jax_params(self, tree) -> None:
        """Copy a JAX ``TFNet``'s params ({node name: array})."""
        extra = sorted(set(tree) - set(self._keys))
        missing = sorted(set(self._keys) - set(tree))
        if extra or missing:
            raise ValueError(f"{self.name}: JAX params {extra} have no "
                             f"parameter here; {missing} have no JAX leaf")
        with torch.no_grad():
            for name, key in self._keys.items():
                p = getattr(self, key)
                arr = np.asarray(tree[name])
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{self.name}.{name}: shape "
                                     f"{arr.shape} vs {tuple(p.shape)}")
                p.copy_(to_tensor(arr).to(p.dtype))

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._device = fn(torch.empty(0, device=self._device)).device
        return out

    @property
    def device(self) -> torch.device:
        return self._device

    # -- forward ------------------------------------------------------------
    def forward(self, inputs, training=False, **kwargs):
        xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        if self.mode == "torch":
            outs = self.graph_fn(self.param_tree(), *xs)
            device = xs[0].device if xs and isinstance(
                xs[0], torch.Tensor) else self._device
            outs = [to_tensor(o, device) for o in outs]
        else:
            outs = self._callback(xs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    @property
    def num_outputs(self):
        if self.mode == "torch":
            return len(self.graph_fn.output_names)
        return self._callback.num_outputs

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        xs = [np.zeros(tuple(2 if d is None else d for d in s),
                       np.float32) for s in shapes]
        outs = self.predict(xs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        result = [(None,) + tuple(np.shape(o)[1:]) for o in outs]
        return result[0] if len(result) == 1 else result

    # -- AbstractModel surface (InferenceModel's queue) ---------------------
    def predict(self, inputs):
        """Rows of ``inputs`` (numpy or tensors) on this layer's device,
        returned as numpy."""
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [to_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                        self._device) for x in xs]
        with torch.inference_mode():
            out = self.forward(xs)
        if isinstance(out, tuple):
            return [o.cpu().numpy() for o in out]
        return out.cpu().numpy()

    def predict_async(self, inputs):
        return self.predict(inputs)

    def release(self):
        pass


class _TFHostCall(torch.autograd.Function):
    """TensorFlow on the host: the forward runs the graph, the backward
    asks ``tf.GradientTape`` for the input gradients."""

    @staticmethod
    def forward(ctx, runner, *xs):
        ctx.runner = runner
        ctx.save_for_backward(*xs)
        arrays = [x.detach().cpu().numpy() for x in xs]
        device = xs[0].device if xs else torch.device("cpu")
        outs = [torch.from_numpy(np.array(o)).to(device)
                for o in runner.host_run(*arrays)]
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        arrays = [x.detach().cpu().numpy() for x in xs]
        grads = ctx.runner.host_grad(
            arrays, [g.detach().cpu().numpy() for g in gs])
        out = [None]
        for x, g in zip(xs, grads):
            out.append(torch.from_numpy(np.array(g)).to(x.device, x.dtype)
                       if x.is_floating_point() else None)
        return tuple(out)


class _CallbackTF:
    """Host-CPU TensorFlow execution of a GraphDef behind
    :class:`_TFHostCall`. Graph consts are frozen, as TFNet's weights are
    fixed in the reference."""

    def __init__(self, graph_bytes: bytes, input_names, output_names):
        self.tf = _tf("a TF graph outside the port's op registry (or "
                      "lower=False)")
        self.graph_bytes = bytes(graph_bytes)
        self.input_names = [n if ":" in n else n + ":0"
                            for n in input_names]
        self.output_names = [n if ":" in n else n + ":0"
                             for n in output_names]
        self.num_outputs = len(output_names)
        self._fn = None

    def __getstate__(self):
        return {"graph_bytes": self.graph_bytes,
                "input_names": self.input_names,
                "output_names": self.output_names}

    def __setstate__(self, state):
        self.__init__(state["graph_bytes"], state["input_names"],
                      state["output_names"])

    def _ensure(self):
        if self._fn is not None:
            return
        tf = self.tf
        graph_def = tf.compat.v1.GraphDef.FromString(self.graph_bytes)

        def import_and_run(*xs):
            return tf.graph_util.import_graph_def(
                graph_def, input_map=dict(zip(self.input_names, xs)),
                return_elements=self.output_names)
        self._fn = tf.function(import_and_run)

    def host_run(self, *xs):
        self._ensure()
        tf = self.tf
        with tf.device("/CPU:0"):
            outs = self._fn(*[tf.constant(np.asarray(x)) for x in xs])
        return tuple(np.asarray(o) for o in outs)

    def host_grad(self, xs, gs):
        self._ensure()
        tf = self.tf
        with tf.device("/CPU:0"):
            ts = [tf.constant(np.asarray(x)) for x in xs]
            with tf.GradientTape() as tape:
                for t in ts:
                    tape.watch(t)
                outs = self._fn(*ts)
                target = tf.add_n([
                    tf.reduce_sum(o * tf.cast(tf.constant(np.asarray(g)),
                                              o.dtype))
                    for o, g in zip(outs, gs) if o.dtype.is_floating])
            grads = tape.gradient(target, ts)
        return tuple(
            np.zeros(np.shape(x), np.float32) if g is None
            else np.asarray(g, np.float32)
            for x, g in zip(xs, grads))

    def __call__(self, xs):
        xs = [x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x)) for x in xs]
        return list(_TFHostCall.apply(self, *xs))
