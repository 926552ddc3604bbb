"""TFOptimizer -- train an arbitrary TF loss graph on the port's engine.

Counterpart of ``analytics_zoo_tpu/tfpark/tf_optimizer.py`` (parity:
``pyzoo/zoo/pipeline/api/net/tf_optimizer.py:331``, with ``from_loss``:422,
``from_keras``:495 and ``optimize``:607). The loss graph is lowered once
to torch; captured tf.Variables become parameters trained by the port's
``SPMDTrainer`` (the graph computes the loss itself, trained with the
identity loss), and autograd replaces the reference's exported-gradient
machinery. Lowering needs TensorFlow.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..common.zoo_trigger import MaxEpoch
from ..feature.feature_set import ArrayFeatureSet
from .model import tfnet_model
from .tf_bridge import lower_tf_callable
from .tf_dataset import TFDataset, batch_arrays


class TFOptimizer:
    """Minimizes a scalar TF loss over a TFDataset."""

    def __init__(self, lowered, dataset: TFDataset,
                 optim_method=None, input_shapes=None, input_dtypes=None):
        self.lowered = lowered
        self.dataset = dataset
        self.optim_method = optim_method or "adam"
        self._input_shapes = input_shapes
        self._input_dtypes = input_dtypes
        self._keras = None
        self._zoo_model = None
        self._tfnet = None

    # ------------------------------------------------------------------
    @classmethod
    def from_loss(cls, loss_fn, dataset: TFDataset, variables=None,
                  optim_method=None, **kw) -> "TFOptimizer":
        """``loss_fn(*batch_tensors) -> scalar loss`` written in TF;
        ``variables``: the tf.Variables to train (default: all
        captured)."""
        from ..pipeline.api.net.tfnet import _tf

        tf = _tf("TFOptimizer.from_loss")
        batch = next(iter(dataset.feature_set.batches(
            min(dataset.batch_size, max(1, len(dataset))), shuffle=False)))
        arrays = batch_arrays(batch)
        specs = [tf.TensorSpec((None,) + a.shape[1:],
                               tf.dtypes.as_dtype(np.asarray(a).dtype))
                 for a in arrays]
        if variables is None:
            # trace once just to discover variables
            traced = tf.function(loss_fn, autograph=False)
            concrete = traced.get_concrete_function(*specs)
            variables = list(concrete.variables)
        lowered = lower_tf_callable(loss_fn, specs, variables=variables,
                                    trainable=variables)
        return cls(lowered, dataset, optim_method,
                   input_shapes=[a.shape[1:] for a in arrays],
                   input_dtypes=[a.dtype for a in arrays])

    @classmethod
    def from_keras(cls, keras_model, dataset: TFDataset,
                   optim_method=None, **kw) -> "TFOptimizer":
        """Compiled tf.keras model + TFDataset (tf_optimizer.py:495)."""
        from .model import KerasModel

        opt = cls(None, dataset, optim_method)
        opt.optim_method = optim_method
        opt._keras = keras_model if isinstance(keras_model, KerasModel) \
            else KerasModel(keras_model)
        return opt

    # ------------------------------------------------------------------
    def _ensure_model(self):
        if self._zoo_model is None:
            self._zoo_model, self._tfnet = tfnet_model(
                self.lowered.graph_fn, self._input_shapes,
                self.optim_method, "identity", first_output=True)
        return self._zoo_model

    def optimize(self, end_trigger=None, batch_size: Optional[int] = None):
        """Run the optimization loop (tf_optimizer.py:607)."""
        if self._keras is not None:
            self._keras.fit(self.dataset, epochs=_trigger_epochs(
                end_trigger))
            return self
        model = self._ensure_model()
        # feed ALL batch arrays (features + labels) as model inputs; the
        # graph computes the loss itself, trained with the identity loss
        arrays = [np.asarray(a) for a in _all_arrays(
            self.dataset.feature_set)]
        fs = ArrayFeatureSet(arrays,
                             [np.zeros((arrays[0].shape[0], 1), np.float32)])
        trainer = model._ensure_trainer()
        trainer.train(fs, batch_size=batch_size or self.dataset.batch_size,
                      end_trigger=end_trigger or MaxEpoch(1))
        self.lowered.write_back(self._tfnet.param_tree())
        return self


def _all_arrays(fs) -> List[np.ndarray]:
    """Features + labels of any FeatureSet as host arrays.

    ArrayFeatureSet exposes them directly; Generator/Disk/Transformed
    tiers are materialized by iterating one epoch of batches.
    """
    feats = list(getattr(fs, "features", []))
    if feats:
        return feats + list(getattr(fs, "labels", []) or [])
    xs_parts, ys_parts = [], []
    for mb in fs.batches(batch_size=256, drop_remainder=False):
        xs_parts.append([np.asarray(a) for a in mb.inputs])
        if mb.targets is not None:
            ys = mb.targets if isinstance(mb.targets, tuple) else (mb.targets,)
            ys_parts.append([np.asarray(a) for a in ys])
    if not xs_parts:
        raise ValueError(
            f"{type(fs).__name__} produced no batches; cannot rebuild a "
            "training array set from it")
    out = [np.concatenate(cols) for cols in zip(*xs_parts)]
    if ys_parts:
        out += [np.concatenate(cols) for cols in zip(*ys_parts)]
    return out


def _trigger_epochs(end_trigger) -> int:
    if end_trigger is None:
        return 1
    return int(getattr(end_trigger, "max_epoch", getattr(
        end_trigger, "max", 1)))
