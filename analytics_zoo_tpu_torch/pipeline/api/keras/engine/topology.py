"""Keras-style model topology: KerasNet / Model.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/
topology.py`` (parity surface ``Topology.scala``: ``KerasNet`` compile
:135, fit :343, evaluate, predict, gradient clipping :261-294; ``Model``
:602). Both containers are ``nn.Module``s: a ``Model`` registers each
distinct layer of its graph as a submodule under the layer's name, so
``model.state_dict()`` keys are the JAX param paths joined by "."
(``bert_1.block0.qkv_w``, ``dense_1.kernel``).

``compile`` picks the loss, optimizer and metrics; ``fit`` builds an
:class:`SPMDTrainer` (``pipeline/engine.py``) on the context's device and
trains the model's own parameters in place, so ``predict`` and
``InferenceModel.load_keras_net`` serve the trained weights.
``set_compute_dtype("bfloat16")`` trains, evaluates and predicts in bf16
over float32 parameters (the trainer's ``compute_dtype``); the layers'
state buffers (BatchNorm's moving statistics, the JAX model's
``net_state``) stay float32. ``fit`` updates them, ``evaluate`` and
``predict`` only read them, and ``get_weights``/``set_weights`` carry
the parameters alone, as JAX's do.

Layers own their parameters, so containers over the same layer objects
share them: ``Sequential.to_model``, ``new_graph`` and a ``Model`` built
over layers of another model train the same weights (the layers of the
reference's ``toModel``/``newGraph`` are shared modules too).

``set_checkpoint`` and ``fit(checkpoint_trigger=...)`` checkpoint into the
trainer's store, ``set_tensorboard`` writes the TrainSummary and
ValidationSummary scalars (``get_train_summary`` /
``get_validation_summary`` read them back), and ``save_model`` /
``load_model`` keep a model as the JAX package does: ``architecture.json``
(``engine/model_io.py``) and ``weights.npz`` (the parameters and state
trees, ``utils/serialization.py``), so a directory either package saved
loads in the other. A graph whose configs hold a callable (a
``Lambda``, a callable activation) is saved as the port's pickled
architecture (``architecture.pkl``, ``model_io.dump_pickled_spec``),
which only the port reads; the port refuses the JAX package's pickles.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .....common.zoo_trigger import EveryEpoch, MaxEpoch, ZooTrigger
from .....feature.feature_set import ArrayFeatureSet, FeatureSet
from .....utils import serialization, tensorboard
from .....parallel.sharding import full_param, full_shape, load_whole
from .....utils.jax_weights import load_jax_params
from ....engine import GradientClipping, SPMDTrainer
from ..metrics import get_metric
from ..objectives import get_loss
from ..optimizers import get_optimizer
from .base import InputLayer, KerasLayer
from .graph import GraphFunction, Node, Variable

logger = logging.getLogger("analytics_zoo_tpu_torch.topology")


def to_feature_set(x, y=None) -> FeatureSet:
    if isinstance(x, FeatureSet):
        return x
    if hasattr(x, "to_feature_set"):
        return x.to_feature_set()
    return ArrayFeatureSet(x, y)


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

    def __init__(self, name=None):
        super().__init__(name=name)
        self.optimizer = None
        self.loss = None
        self.metrics: List = []
        self.trainer: Optional[SPMDTrainer] = None
        self._clipping = GradientClipping()
        self._frozen: set = set()
        self._compute_dtype = None
        self._tb = None
        self._checkpoint_dir: Optional[str] = None
        self._checkpoint_trigger: Optional[ZooTrigger] = None

    # -- abstract ------------------------------------------------------
    def graph_function(self) -> GraphFunction:
        raise NotImplementedError

    # -- config --------------------------------------------------------
    def compile(self, optimizer, loss, metrics=None):
        """Parity: Topology.scala:135."""
        self.optimizer = get_optimizer(optimizer)
        self.loss = get_loss(loss)
        self.metrics = [get_metric(m, self.loss) for m in (metrics or [])]
        self.trainer = None  # rebuilt on the next fit
        return self

    def set_constant_gradient_clipping(self, min_value, max_value):
        self._clipping = GradientClipping(min_value=min_value,
                                          max_value=max_value)

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self._clipping = GradientClipping(l2_norm=clip_norm)

    def clear_gradient_clipping(self):
        self._clipping = GradientClipping()

    def set_tensorboard(self, log_dir, app_name):
        """Write the training and validation scalars under
        ``log_dir/app_name/{train,validation}`` (Topology.scala:204-243)."""
        self._tb = (log_dir, app_name)
        if self.trainer is not None:
            self._attach_summaries(self.trainer)

    def get_train_summary(self, tag=None):
        """[(step, wall_time, tag, value)] of the training scalars."""
        if not self._tb:
            return []
        return tensorboard.read_scalars(
            os.path.join(self._tb[0], self._tb[1], "train"), tag)

    def get_validation_summary(self, tag=None):
        if not self._tb:
            return []
        return tensorboard.read_scalars(
            os.path.join(self._tb[0], self._tb[1], "validation"), tag)

    def set_checkpoint(self, path, over_write=True,
                       trigger: Optional[ZooTrigger] = None):
        """Checkpoint into ``path`` on ``trigger`` (each epoch by
        default) while training."""
        self._checkpoint_dir = path
        self._checkpoint_trigger = trigger or EveryEpoch()
        if self.trainer is not None:
            self.trainer.checkpoint_dir = path
            self.trainer.checkpoint_trigger = self._checkpoint_trigger

    def set_evaluate_status(self):  # parity no-op (eval uses training=False)
        return self

    def set_compute_dtype(self, dtype):
        """Run forward and backward in ``dtype`` ("bfloat16" or "bf16"; any
        other value is float32) over float32 parameters, whatever
        ``ZooConfig.compute_dtype`` says. Drops the trainer, as the JAX
        model does: the next ``fit`` starts a new optimizer state."""
        self._compute_dtype = dtype
        self.trainer = None
        return self

    # -- trainer plumbing ---------------------------------------------
    def _ensure_trainer(self) -> SPMDTrainer:
        if self.trainer is not None:
            return self.trainer
        self.graph_function()   # a Sequential builds its layers here
        optimizer = self.optimizer or get_optimizer("sgd")
        loss = self.loss if self.loss is not None else get_loss("mse")
        self.trainer = SPMDTrainer(self, loss, optimizer,
                                   metrics=self.metrics,
                                   clipping=self._clipping,
                                   compute_dtype=self._compute_dtype)
        if self._frozen:
            self.trainer.set_frozen(self._frozen)
        if self._checkpoint_dir:
            self.trainer.checkpoint_dir = self._checkpoint_dir
            self.trainer.checkpoint_trigger = self._checkpoint_trigger
        if self._tb:
            self._attach_summaries(self.trainer)
        return self.trainer

    def _attach_summaries(self, trainer):
        trainer.train_summary = tensorboard.TrainSummary(*self._tb)
        trainer.val_summary = tensorboard.ValidationSummary(*self._tb)

    # -- freeze (GraphNet freeze/unFreeze parity) ----------------------
    def freeze(self, names: Optional[Sequence[str]] = None):
        """Exclude layers from training (all layers when ``names`` is
        None)."""
        layer_names = {l.name for l in self.graph_function().layers}
        if names is None:
            self._frozen = set(layer_names)
        else:
            unknown = set(names) - layer_names
            if unknown:
                raise ValueError(f"unknown layers: {sorted(unknown)}")
            self._frozen |= set(names)
        if self.trainer is not None:
            self.trainer.set_frozen(self._frozen)
        return self

    def unfreeze(self, names: Optional[Sequence[str]] = None):
        if names is None:
            self._frozen = set()
        else:
            self._frozen -= set(names)
        if self.trainer is not None:
            self.trainer.set_frozen(self._frozen)
        return self

    def freeze_up_to(self, *names: str):
        """Freeze every layer from the inputs up to (and including) the
        named layers (``GraphNet.freezeUpTo``)."""
        graph = self.graph_function()
        nodes_by_layer: Dict[str, List[Node]] = {}
        for node in graph.nodes:
            nodes_by_layer.setdefault(node.layer.name, []).append(node)
        unknown = set(names) - set(nodes_by_layer)
        if unknown:
            raise ValueError(f"unknown layers: {sorted(unknown)}")
        target = set()
        visited = set()
        stack = [n for name in names for n in nodes_by_layer[name]]
        while stack:
            node = stack.pop()
            if node.id in visited:
                continue
            visited.add(node.id)
            target.add(node.layer.name)
            stack.extend(v.node for v in node.inputs if v.node is not None)
        return self.freeze(sorted(target))

    def set_param_sharding(self, fn):
        """Install a ``params -> tree of specs`` function
        (``parallel.sharding.make_param_sharding_fn``'s): the layout the
        next trainer cuts the parameters into. Drops the trainer."""
        self._param_sharding_fn = fn
        self.trainer = None

    def _resolve_param_sharding_fn(self, graph):
        """The one precedence rule of every training surface: an explicit
        ``set_param_sharding`` wins; otherwise the config's layout
        (``ZooConfig.param_sharding``)."""
        fn = getattr(self, "_param_sharding_fn", None)
        if fn is not None:
            return fn
        return self._config_param_sharding(graph)

    def _config_param_sharding(self, graph):
        """The config's layout when no ``set_param_sharding`` was given:
        "auto" applies the annotation rules whenever the ambient mesh has
        a non-data axis > 1; "fsdp" also lays the embed/in/out-annotated
        parameters over the data axis; "default" applies the rules on any
        mesh; "none" keeps every parameter whole."""
        from .....common import nncontext as _nn

        ctx = _nn._global_context
        if ctx is None:
            return None
        mode = str(getattr(ctx.config, "param_sharding", "auto")).lower()
        if mode not in ("auto", "none", "default", "fsdp"):
            raise ValueError(
                f"param_sharding must be auto|none|default|fsdp, "
                f"got {mode!r}")
        if mode == "none":
            return None
        non_data = any(v > 1 for ax, v in ctx.mesh.shape.items()
                       if ax != "data")
        if mode == "auto" and not non_data:
            return None
        from .....parallel.sharding import (FSDP_RULES,
                                            make_param_sharding_fn)

        rules = FSDP_RULES if mode == "fsdp" else None
        return make_param_sharding_fn(graph, ctx.mesh, rules=rules)

    def frozen_layers(self) -> List[str]:
        return sorted(self._frozen)

    # -- training surface ---------------------------------------------
    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, distributed=True,
            checkpoint_trigger=None):
        """Train ``nb_epoch`` more epochs on the context's device
        (Topology.scala:343), checkpointing on ``checkpoint_trigger`` (or
        the ``set_checkpoint`` trigger)."""
        trainer = self._ensure_trainer()
        train_set = to_feature_set(x, y)
        val_set = None
        if validation_data is not None:
            val_set = to_feature_set(*validation_data) \
                if isinstance(validation_data, tuple) else \
                to_feature_set(validation_data)
        trainer.train(train_set, batch_size,
                      end_trigger=MaxEpoch(trainer.epoch + nb_epoch),
                      checkpoint_trigger=checkpoint_trigger,
                      validation_set=val_set)
        return self

    def evaluate(self, x, y=None, batch_size=32):
        """{metric name: value, "loss": value} over ``(x, y)``."""
        return self._ensure_trainer().evaluate(to_feature_set(x, y),
                                               batch_size)

    # -- inference -----------------------------------------------------
    def predict(self, x, batch_size=128, distributed=True):
        """Outputs for ``x`` as float32 numpy: an array, a list of arrays
        for a multi-input model, a ``FeatureSet``, or anything with
        ``to_feature_set()``. Batches of ``batch_size`` run on the
        context's device through the trainer (``SPMDTrainer.predict``: the
        last batch padded and the padding cut off), in the compute dtype;
        the model moves there in place. With no context and no card it
        raises."""
        return self._ensure_trainer().predict(to_feature_set(x), batch_size)

    def predict_classes(self, x, batch_size=128, zero_based_label=True):
        """The arg-max class of each output row; 1-based with
        ``zero_based_label=False``."""
        classes = np.argmax(self.predict(x, batch_size), axis=-1)
        return classes if zero_based_label else classes + 1

    # -- weights -------------------------------------------------------
    def param_tree(self) -> Dict[str, Any]:
        """{layer_name: layer params}, the JAX params pytree's shape."""
        tree = {}
        for layer in self.graph_function().layers:
            p = layer.param_tree()
            if p:
                tree[layer.name] = p
        return tree

    def state_tree(self) -> Dict[str, Any]:
        """{layer_name: layer state buffers}, the JAX ``net_state``'s
        shape."""
        tree = {}
        for layer in self.graph_function().layers:
            s = layer.state_tree()
            if s:
                tree[layer.name] = s
        return tree

    def full_param_tree(self) -> Dict[str, Any]:
        """:meth:`param_tree` with each parameter laid out over the ranks
        all-gathered whole (a collective: every rank calls it)."""
        def whole(tree):
            return {k: whole(v) if isinstance(v, dict) else full_param(v)
                    for k, v in tree.items()}
        return whole(self.param_tree())

    def get_weights(self) -> List[np.ndarray]:
        """Every parameter as numpy, in the JAX model's leaf order, whole
        (a parameter laid out over the ranks is all-gathered: every rank
        calls it)."""
        return [p.cpu().numpy()
                for p in _flatten_sorted(self.full_param_tree(), [])]

    def get_params(self) -> Dict[str, Any]:
        """The parameters as the JAX params pytree (``{layer name:
        {...}}``): the live tensors, or where the trainer laid them out
        over the ranks, their whole leaves (a collective)."""
        if any(hasattr(p, "_zoo_shard") for p in self.parameters()):
            return self.full_param_tree()
        return self.param_tree()

    def summary(self, line_length=100) -> str:
        """Each layer's parameter count and the total, printed and
        returned; the JAX package's text for the same model."""
        lines = [f'Model: "{self.name}"', "_" * line_length,
                 f"{'Layer (type)':40s}{'Param #':>12s}", "=" * line_length]
        total = 0
        for layer in self.graph_function().layers:
            n = sum(math.prod(full_shape(p)) for p in layer.parameters())
            total += n
            lines.append(f"{layer.name + ' (' + type(layer).__name__ + ')':40s}"
                         f"{n:>12,d}")
        lines += ["=" * line_length, f"Total params: {total:,d}"]
        text = "\n".join(lines)
        print(text)
        return text

    def set_weights(self, weights: Sequence[np.ndarray]):
        leaves = _flatten_sorted(self.param_tree(), [])
        if len(leaves) != len(weights):
            raise ValueError(f"expected {len(leaves)} arrays, got "
                             f"{len(weights)}")
        for p, w in zip(leaves, weights):
            load_whole(p, np.asarray(w))

    # -- persistence ---------------------------------------------------
    def save_model(self, path, weight_path=None, over_write=False):
        """Save the architecture (``architecture.json``, the layers'
        classes and configs and the DAG, ``engine/model_io.py``; array
        configs in ``config_arrays.npz``) and the weights
        (``weights.npz``: the parameters and state trees), in the JAX
        package's format (``KerasNet.saveModel``, Topology.scala:109)."""
        from . import model_io

        if os.path.exists(path) and not over_write:
            raise IOError(f"{path} exists; pass over_write=True")
        try:
            spec, arrays = model_io.graph_to_spec(self.graph_function(),
                                                  self.name)
            pickled = None
        except model_io.UnserializableConfig as e:
            logger.warning("definition serialization unavailable (%s); "
                           "saving the architecture by pickle", e)
            pickled = model_io.dump_pickled_spec(self.graph_function(),
                                                 self.name)
        os.makedirs(path, exist_ok=True)
        for stale in ("architecture.json", "config_arrays.npz",
                      "architecture.pkl"):
            sp = os.path.join(path, stale)
            if os.path.exists(sp):
                os.remove(sp)
        if pickled is not None:
            with open(os.path.join(path, "architecture.pkl"), "wb") as f:
                f.write(pickled)
        else:
            with open(os.path.join(path, "architecture.json"), "w") as f:
                json.dump(spec, f, indent=1)
            if arrays:
                np.savez(os.path.join(path, "config_arrays.npz"), **arrays)
        serialization.save_pytree(os.path.join(path, "weights.npz"),
                                  {"params": self.full_param_tree(),
                                   "state": self.state_tree()})

    saveModel = save_model

    def export_tf(self, path, batch_size: Optional[int] = None):
        """Export inference as a TensorFlow SavedModel (parity:
        ``saveToTf``, Topology.scala:568): the layers as TF ops with the
        weights as Consts, written without TensorFlow
        (``pipeline/api/net/tf_export.py``); the inputs' batch dim is
        ``batch_size``, unknown when None."""
        from ...net.tf_export import export_savedmodel
        return export_savedmodel(self, path, batch_size)

    saveToTf = export_tf

    @staticmethod
    def load_model(path, weight_path=None) -> "Model":
        """The model a ``save_model`` directory holds (either package's),
        rebuilt as a ``Model`` with the file's layer names and its
        weights; it runs on the context's device."""
        from . import model_io

        json_path = os.path.join(path, "architecture.json")
        pkl_path = os.path.join(path, "architecture.pkl")
        if os.path.exists(json_path):
            with open(json_path) as f:
                spec = json.load(f)
            arrays = {}
            arr_path = os.path.join(path, "config_arrays.npz")
            if os.path.exists(arr_path):
                with np.load(arr_path, allow_pickle=False) as z:
                    arrays = {k: z[k] for k in z.files}
        elif os.path.exists(pkl_path):
            with open(pkl_path, "rb") as f:
                spec, arrays = model_io.load_pickled_spec(f.read(),
                                                          pkl_path)
        else:
            raise FileNotFoundError(f"{path} holds no architecture.json "
                                    "or architecture.pkl")
        model = model_io.spec_to_model(spec, arrays)
        blob = serialization.load_pytree(os.path.join(path, "weights.npz"))
        load_jax_params(model, blob["params"], blob.get("state") or {})
        return model


class Model(KerasNet):
    """Functional graph container (Topology.scala:602). Builds the weights
    of every layer not built before at construction from ``seed`` (the
    context config's seed when None) on the CPU; ``predict`` and
    ``InferenceModel.load_keras_net`` move it to the context's device."""

    def __init__(self, input, output, name=None, seed: Optional[int] = None):
        super().__init__(name=name)
        self.inputs = [input] if isinstance(input, Variable) else list(input)
        self.outputs = [output] if isinstance(output, Variable) \
            else list(output)
        self._graph = GraphFunction(self.inputs, self.outputs)
        self.num_outputs = len(self.outputs)
        _build_graph(self, self._graph, seed)

    def graph_function(self):
        return self._graph

    def forward(self, inputs, training=False, generator=None):
        return self._graph.apply(inputs, training=training,
                                 generator=generator)

    def compute_output_shape(self, input_shape):
        shapes = [v.shape for v in self.outputs]
        return shapes[0] if len(shapes) == 1 else shapes

    def new_graph(self, outputs: Sequence[str]) -> "Model":
        """Graph surgery: a ``Model`` from the same inputs to the named
        layers' outputs (``GraphNet.newGraph``), over the same layers and
        weights. ``"layer"`` selects output 0 of that layer,
        ``"layer:k"`` output ``k`` of a multi-output layer."""
        graph = self._graph
        nodes_by_layer: Dict[str, Node] = {}
        vars_by_layer: Dict[str, Dict[int, Variable]] = {}
        for node in graph.nodes:
            nodes_by_layer.setdefault(node.layer.name, node)
            for v in _node_out_vars(node, graph):
                vars_by_layer.setdefault(node.layer.name, {})[v.index] = v
        outs = []
        for name in outputs:
            index = 0
            if ":" in name:
                name, idx_s = name.rsplit(":", 1)
                index = int(idx_s)
            node = nodes_by_layer.get(name)
            if node is None:
                raise ValueError(
                    f"no layer named {name!r} in the graph "
                    f"(have: {sorted(nodes_by_layer)})")
            v = vars_by_layer.get(name, {}).get(index)
            if v is None:
                v = _make_out_var(node, index)
            outs.append(v)
        return Model(self.inputs, outs if len(outs) > 1 else outs[0],
                     name=self.name + "_sub")


def _build_graph(container, graph: GraphFunction, seed) -> None:
    """Build the layers of ``graph`` not built yet from ``seed`` (the
    context config's seed when None, 42 without a context) on the CPU,
    and register every layer on ``container`` under its name."""
    if seed is None:
        from .....common import nncontext as _nn
        ctx = _nn._global_context
        seed = ctx.config.seed if ctx is not None else 42
    graph.init(torch.Generator().manual_seed(int(seed)))
    for layer in graph.layers:
        container.add_module(layer.name, layer)


def _layer_out_shapes(node):
    shape = node.layer.compute_output_shape(
        node.inputs[0].shape if len(node.inputs) == 1
        else [v.shape for v in node.inputs])
    if node.layer.num_outputs > 1:
        return list(shape)
    return [shape]


def _make_out_var(node, index: int) -> Variable:
    shapes = _layer_out_shapes(node)
    if index >= len(shapes):
        raise ValueError(
            f"layer {node.layer.name!r} has {len(shapes)} outputs; "
            f"index {index} out of range")
    return Variable(node, shapes[index], index=index)


def _node_out_vars(node, graph):
    """Variables produced by ``node`` that the graph uses (as other
    nodes' inputs or as graph outputs)."""
    seen = [v for v in graph.outputs if v.node is node]
    for n in graph.nodes:
        for v in n.inputs:
            if v.node is node and v not in seen:
                seen.append(v)
    if not seen:
        seen.append(_make_out_var(node, 0))
    return seen


class Sequential(KerasNet):
    """Linear stack (Topology.scala:825). The first layer needs an
    ``input_shape``. The graph is built, and the layers not built yet
    draw their weights from ``seed`` (as ``Model``'s), at the first
    ``graph_function()`` after an ``add``: the first ``fit``,
    ``predict`` or weight access."""

    def __init__(self, name=None, seed: Optional[int] = None):
        super().__init__(name=name)
        self.layers: List[KerasLayer] = []
        self._seed = seed
        self._graph: Optional[GraphFunction] = None

    def add(self, layer) -> "Sequential":
        if not self.layers and not isinstance(layer, KerasNet):
            if layer.input_shape is None and \
                    not isinstance(layer, InputLayer):
                raise ValueError(
                    "first layer needs input_shape (parity with reference "
                    "Sequential semantics)")
        self.layers.append(layer)
        self._graph = None
        self.trainer = None
        return self

    def _input_shape(self):
        first = self.layers[0]
        if isinstance(first, Sequential):
            return first._input_shape()
        if isinstance(first, Model):
            shapes = [v.shape for v in first.inputs]
            return shapes[0] if len(shapes) == 1 else shapes
        return first.input_shape

    def graph_function(self) -> GraphFunction:
        if self._graph is None:
            if not self.layers:
                raise ValueError("an empty Sequential has no graph")
            inp = Variable(None, self._input_shape(),
                           name=self.name + "_input")
            x = inp
            for layer in self.layers:
                x = layer(x)
            graph = GraphFunction([inp], [x])
            _build_graph(self, graph, self._seed)
            self._graph = graph
        return self._graph

    def forward(self, inputs, training=False, generator=None):
        return self.graph_function().apply(inputs, training=training,
                                           generator=generator)

    def build(self, generator, input_shape):
        self.graph_function()
        return {}

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for layer in self.layers:
            shape = layer.compute_output_shape(shape)
        return shape

    def to_model(self) -> Model:
        """The functional ``Model`` over the same layer objects and
        weights (``Sequential.toModel``, Topology.scala:914), with this
        model's loss, optimizer and metrics."""
        graph = self.graph_function()
        m = Model(graph.inputs, graph.outputs
                  if len(graph.outputs) > 1 else graph.outputs[0],
                  name=self.name + "_model")
        m.optimizer, m.loss, m.metrics = (self.optimizer, self.loss,
                                          self.metrics)
        return m

    toModel = to_model

    def new_graph(self, outputs: Sequence[str]) -> Model:
        return self.to_model().new_graph(outputs)

    def save_keras2(self, path: str) -> str:
        """Write a runnable Keras-2 python definition of this stack
        (``saveToKeras2``, Topology.scala:557; ``keras2_export``)."""
        from .keras2_export import sequential_to_keras2_source

        with open(path, "w") as f:
            f.write(sequential_to_keras2_source(self))
        return path

    saveToKeras2 = save_keras2
