"""tf.function -> torch lowering with live-variable capture.

Counterpart of ``analytics_zoo_tpu/tfpark/tf_bridge.py``. Parity: the
reference's TFPark trains TF graphs by exporting graph + grad + assign-op
metadata to files (``tf_optimizer.py:224`` ``_save_to_dir_for_unfreeze``)
and replaying them through a JNI TF session per iteration
(``TFTrainingHelper.scala:188``). Here, as in the JAX package, the tf
callable is traced ONCE, its concrete graph is translated by the port's
GraphDef reader (``pipeline/api/net/tf_graph.py``), and each captured
``tf.Variable`` becomes a named torch parameter: autograd gives the
gradients, the card runs the math, and nothing crosses back into TF until
``write_back`` assigns the trained values to the variables.
``ReadVariableOp`` over a resource placeholder is the identity.

Tracing needs TensorFlow, imported inside each function; without it they
raise ``ImportError`` naming it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..pipeline.api.net.tf_graph import TFGraphFunction
from ..pipeline.api.net.tfnet import _tf


class LoweredTF:
    """A lowered tf callable: torch graph fn + variable correspondence."""

    def __init__(self, graph_fn: TFGraphFunction,
                 var_map: Dict[str, Any], concrete):
        self.graph_fn = graph_fn
        self.var_map = var_map  # param key -> tf.Variable (or None)
        self.concrete = concrete

    def init_params(self):
        return self.graph_fn.init_params()

    def __call__(self, params, *inputs):
        return self.graph_fn(params, *inputs)

    @property
    def output_names(self):
        return self.graph_fn.output_names

    def write_back(self, params) -> None:
        """Assign trained param values (arrays or tensors) into the
        original tf.Variables (the reference's setVariableIntoTF
        direction, once at the end instead of every step), and refresh
        the lowered graph's capture snapshot so a later ``init_params``
        gives the trained values."""
        for key, var in self.var_map.items():
            if key in params:
                value = params[key]
                if hasattr(value, "detach"):
                    value = value.detach().cpu().numpy()
                value = np.asarray(value)
                if var is not None:
                    var.assign(value)
                self.graph_fn.captures[key] = value


def _variable_handles(variables) -> List[Tuple[Any, Any]]:
    """(handle_tensor, variable) for keras-3 / tf variables."""
    out = []
    for v in variables:
        h = getattr(v, "handle", None)
        if h is None:
            inner = getattr(v, "value", None)
            h = getattr(inner, "handle", None)
        if h is not None:
            out.append((h, v))
    return out


def lower_tf_callable(fn: Callable, input_specs: Sequence,
                      variables: Sequence = (),
                      trainable: Optional[Sequence] = None,
                      once: bool = False) -> LoweredTF:
    """Trace ``fn(*specs)`` and lower the concrete graph to torch.

    ``variables``: tf variables whose captures become named params.
    ``trainable``: subset that should train (default: all matched, minus
    ones whose variable reports trainable=False).
    ``once``: trace with ``tf.compat.v1.wrap_function`` (exactly one
    trace) so ``fn`` may CREATE variables -- the estimator model_fn case.
    """
    tf = _tf("tfpark's graph lowering")
    if once:
        concrete = tf.compat.v1.wrap_function(fn, signature=input_specs)
        if not variables:
            holder = getattr(concrete, "_variable_holder", None)
            if holder is not None:
                hv = holder.variables
                variables = list(hv.values() if hasattr(hv, "values")
                                 else hv)
            if trainable is None:
                trainable = [v for v in variables
                             if getattr(v, "trainable", True)]
    else:
        traced = tf.function(fn, autograph=False)
        concrete = traced.get_concrete_function(*input_specs)
    graph_def = concrete.graph.as_graph_def()

    handles = _variable_handles(variables)
    trainable_set = set(id(v) for v in trainable) if trainable is not None \
        else None
    captures: Dict[str, np.ndarray] = {}
    var_map: Dict[str, Any] = {}
    trainable_names: List[str] = []
    for ext, internal in concrete.graph.captures:
        name = internal.op.name
        matched = None
        for h, v in handles:
            if h is ext:
                matched = v
                break
        if matched is not None:
            captures[name] = np.asarray(matched)
            var_map[name] = matched
            is_trainable = getattr(matched, "trainable", True)
            if trainable_set is not None:
                is_trainable = id(matched) in trainable_set
            if is_trainable:
                trainable_names.append(name)
        else:
            # non-variable capture (closed-over tensor / unmatched
            # resource): bake its current value
            if ext.dtype == tf.resource:
                val = _read_resource(tf, ext, concrete, internal)
            else:
                val = np.asarray(ext)
            captures[name] = np.asarray(val)
            var_map[name] = None

    cap_names = set(captures)
    input_names = [t.op.name for t in concrete.inputs
                   if t.op.name not in cap_names]
    output_names = [t.name for t in concrete.outputs]
    gfn = TFGraphFunction(graph_def.SerializeToString(), input_names,
                          output_names, captures=captures,
                          trainable_captures=trainable_names)
    return LoweredTF(gfn, var_map, concrete)


def _read_resource(tf, ext, concrete, internal):
    # find the ReadVariableOp consuming this placeholder to get its dtype
    for op in concrete.graph.get_operations():
        if op.type == "ReadVariableOp" and \
                op.inputs and op.inputs[0].op.name == internal.op.name:
            return tf.raw_ops.ReadVariableOp(
                resource=ext, dtype=op.outputs[0].dtype).numpy()
    raise ValueError(
        f"cannot determine dtype for resource capture {internal.op.name}")


def lower_keras_model(model, training: bool = False) -> LoweredTF:
    """Lower a tf.keras model's forward pass (all weights as params)."""
    tf = _tf("tfpark's graph lowering")
    specs = [tf.TensorSpec((None,) + tuple(i.shape[1:]), i.dtype)
             for i in model.inputs]

    def forward(*xs):
        return model(list(xs) if len(xs) > 1 else xs[0], training=training)

    trainables = {id(v) for v in model.trainable_variables}
    return lower_tf_callable(
        forward, specs, variables=list(model.variables),
        trainable=[v for v in model.variables if id(v) in trainables])
