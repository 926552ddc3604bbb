"""Estimator: the thin training facade over the engine.

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/estimator.py``
(parity: ``Estimator.scala`` ``train`` :118, ``evaluate`` :163, the
gradient-clipping state machine :79-116). The Estimator owns one
:class:`SPMDTrainer` over the model's own parameters; ``model_dir`` is
its checkpoint directory. ``optim_methods`` may be a dict keyed by layer
name: :class:`MultiOptimizer`, the counterpart of
``optax.multi_transform`` (Topology.scala:1122-1143's parameterSplits).

``load_checkpoint`` restores through the trainer's store, which pairs a
checkpoint's layer names with the model's (user names by name, auto
names by class and creation order, ``utils/jax_weights.py``): the JAX
Estimator's ``_remap_param_names`` step is part of that pairing here.
``train_minibatch`` trains on a pre-batched feature set and
``train_imagefeature`` on an ``ImageSet`` (through its
``to_feature_set``). ``LocalEstimator`` (``local_estimator.py``) trains
from raw arrays over the same trainer.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from ...common.zoo_trigger import MaxEpoch
from ...feature.feature_set import FeatureSet
from ..api.keras.metrics import get_metric
from ..api.keras.objectives import get_loss
from ..api.keras.optimizers import Transformation, ZooOptimizer, \
    get_optimizer
from ..engine import GradientClipping, SPMDTrainer


class AbstractEstimator:
    """Parity: the ``AbstractEstimator`` trait (Estimator.scala:33-45)."""

    def train(self, train_set, criterion=None, end_trigger=None,
              checkpoint_trigger=None, validation_set=None,
              validation_method=None, batch_size=32):
        raise NotImplementedError

    def evaluate(self, validation_set, validation_method=None,
                 batch_size=32):
        raise NotImplementedError

    def close(self):
        pass


def _label(path: str, labels) -> str:
    layer = path.split(".", 1)[0]
    return layer if layer in labels else "__default__"


class MultiTransform(Transformation):
    """``optax.multi_transform`` over the parameter dict: each parameter
    goes to the transform of its label (its layer name when one is
    given, else ``"__default__"``). The state holds one inner state per
    label, in sorted label order, each over its own parameters, as
    optax's does (so the leaves line up with optax's)."""

    def __init__(self, transforms: Dict[str, Transformation]):
        self.transforms = dict(transforms)

    def _split(self, tree):
        parts = {label: {} for label in self.transforms}
        for k, v in tree.items():
            parts[_label(k, self.transforms)][k] = v
        return parts

    def init(self, params):
        parts = self._split(params)
        return {label: self.transforms[label].init(parts[label])
                for label in sorted(self.transforms)}

    def update(self, grads, state, params):
        g_parts, p_parts = self._split(grads), self._split(params)
        updates, new_state = {}, {}
        for label in sorted(self.transforms):
            u, new_state[label] = self.transforms[label].update(
                g_parts[label], state[label], p_parts[label])
            updates.update(u)
        return updates, new_state


class MultiOptimizer(ZooOptimizer):
    """Per-layer optimizers (Topology.scala:1122-1143 parity):
    ``methods`` maps a layer name to a :class:`ZooOptimizer`; the other
    layers take ``default`` (the first method when None)."""

    def __init__(self, methods: Dict[str, ZooOptimizer],
                 default: Optional[ZooOptimizer] = None):
        super().__init__(lr=next(iter(methods.values())).lr)
        self.methods = {k: get_optimizer(v) for k, v in methods.items()}
        self.default = get_optimizer(default) if default is not None else \
            next(iter(self.methods.values()))

    def lr_schedule(self):
        return self.default.lr_schedule()

    def transformation(self) -> Transformation:
        transforms = {k: m.transformation() for k, m in self.methods.items()}
        transforms["__default__"] = self.default.transformation()
        return MultiTransform(transforms)


class Estimator(AbstractEstimator):
    """Train, evaluate and predict a ``KerasNet`` on feature sets.

    Parameters mirror the reference constructor (``Estimator.apply``,
    Estimator.scala:195-258): ``model``, ``optim_methods`` (an optimizer,
    its name, or a dict of layer name -> optimizer), ``model_dir`` (the
    checkpoint directory)."""

    def __init__(self, model, optim_methods: Union[None, str, ZooOptimizer,
                                                   Dict] = None,
                 model_dir: Optional[str] = None):
        self.model = model
        if isinstance(optim_methods, dict):
            self.optimizer = MultiOptimizer(
                {k: get_optimizer(v) for k, v in optim_methods.items()})
        else:
            self.optimizer = get_optimizer(optim_methods or "sgd")
        self.model_dir = model_dir
        self._clipping = GradientClipping()
        self.trainer: Optional[SPMDTrainer] = None

    # -- gradient clipping state machine (Estimator.scala:79-116) ------
    def clear_gradient_clipping(self):
        self._clipping = GradientClipping()
        self._invalidate()

    def set_constant_gradient_clipping(self, min, max):  # noqa: A002
        self._clipping = GradientClipping(min_value=min, max_value=max)
        self._invalidate()

    def set_l2_norm_gradient_clipping(self, clip_norm):
        self._clipping = GradientClipping(l2_norm=clip_norm)
        self._invalidate()

    def _invalidate(self):
        # the next train builds a trainer with the new clipping; the
        # learned weights stay on the model, as the JAX Estimator keeps
        # its params
        self.trainer = None

    # -- trainer plumbing ----------------------------------------------
    def _ensure_trainer(self, criterion, validation_method) -> SPMDTrainer:
        metrics = [get_metric(m, criterion) for m in
                   (validation_method or [])]
        if self.trainer is not None:
            self.trainer.metrics = metrics or self.trainer.metrics
            return self.trainer
        self.model.graph_function()   # a Sequential builds its layers here
        self.trainer = SPMDTrainer(self.model, criterion, self.optimizer,
                                   metrics=metrics, clipping=self._clipping)
        if self.model_dir is not None:
            self.trainer.checkpoint_dir = self.model_dir
        return self.trainer

    # -- training surface (Estimator.scala:118-161) --------------------
    def train(self, train_set: FeatureSet, criterion=None, end_trigger=None,
              checkpoint_trigger=None, validation_set=None,
              validation_method=None, batch_size=32):
        criterion = get_loss(criterion or "mse")
        trainer = self._ensure_trainer(criterion, validation_method)
        trainer.loss_fn = criterion
        trainer.train(train_set, batch_size=batch_size,
                      end_trigger=end_trigger or MaxEpoch(1),
                      checkpoint_trigger=checkpoint_trigger,
                      validation_set=validation_set,
                      validation_trigger=(checkpoint_trigger
                                          if validation_set is not None
                                          else None))
        return self

    def train_minibatch(self, train_set, criterion=None, end_trigger=None,
                        checkpoint_trigger=None, validation_set=None,
                        validation_method=None):
        """Pre-batched variant (estimatorTrainMiniBatch parity): the
        batch size is the feature set's ``batch_size``, else the size of
        its first batch."""
        first = next(iter(train_set.batches(1)), None) \
            if not hasattr(train_set, "batch_size") else None
        bs = getattr(train_set, "batch_size", None) or (
            len(first.weights) if first is not None else 32)
        return self.train(train_set, criterion, end_trigger,
                          checkpoint_trigger, validation_set,
                          validation_method, batch_size=bs)

    def train_imagefeature(self, train_set, criterion=None, end_trigger=None,
                           checkpoint_trigger=None, validation_set=None,
                           validation_method=None, batch_size=32):
        """ImageSet variant (estimatorTrainImageFeature parity): the
        transformed images (their samples, else their tensors and
        labels) as a feature set."""
        to_fs = getattr(train_set, "to_feature_set", None)
        fs = to_fs() if to_fs else train_set
        val = validation_set.to_feature_set() if (
            validation_set is not None and
            hasattr(validation_set, "to_feature_set")) else validation_set
        return self.train(fs, criterion, end_trigger, checkpoint_trigger,
                          val, validation_method, batch_size)

    def evaluate(self, validation_set, validation_method=None,
                 batch_size=32):
        criterion = get_loss(getattr(self.trainer, "loss_fn", None) or "mse")
        trainer = self._ensure_trainer(criterion, validation_method)
        return trainer.evaluate(validation_set, batch_size=batch_size)

    evaluate_minibatch = evaluate

    def predict(self, data, batch_size=128):
        trainer = self._ensure_trainer(get_loss("mse"), None)
        return trainer.predict(data, batch_size=batch_size)

    def get_model(self):
        return self.model

    def load_checkpoint(self, directory):
        """Restore the trainer from ``directory`` (the latest valid
        checkpoint; either package's)."""
        self._ensure_trainer(get_loss("mse"), None).load_checkpoint(
            directory)
        return self

    def close(self):
        self.trainer = None
