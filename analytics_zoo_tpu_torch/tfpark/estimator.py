"""TFEstimator -- a tf.estimator-style API on the port's engine.

Counterpart of ``analytics_zoo_tpu/tfpark/estimator.py`` (parity:
``pyzoo/zoo/tfpark/estimator.py:84``, ``train``:194, with
``TFEstimatorSpec``). model_fn is traced once (variables are created on
that trace and captured), the concrete graph lowers to torch, and
train/evaluate/predict run through the port's ``SPMDTrainer``. The TRAIN
trace returns both ``loss`` and ``predictions`` so every mode shares one
set of variables. Tracing needs TensorFlow.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..common.zoo_trigger import MaxEpoch, MaxIteration
from ..feature.feature_set import ArrayFeatureSet
from .model import tfnet_model
from .tf_bridge import lower_tf_callable
from .tf_dataset import TFDataset, batch_arrays


class ModeKeys:
    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "infer"


class TFEstimatorSpec(NamedTuple):
    """(estimator.py TFEstimatorSpec parity)."""

    mode: str
    predictions: Any = None
    loss: Any = None


class TFEstimator:
    """model_fn-driven estimator (estimator.py:84)."""

    def __init__(self, model_fn: Callable, params: Optional[dict] = None,
                 model_dir: Optional[str] = None, optimizer="adam"):
        self.model_fn = model_fn
        self.params = params or {}
        self.model_dir = model_dir
        self.optimizer = optimizer
        self._lowered = None
        self._zoo = None
        self._tfnet = None
        self._n_features = None

    # ------------------------------------------------------------------
    def _trace(self, dataset: TFDataset):
        if self._lowered is not None:
            return
        from ..pipeline.api.net.tfnet import _tf

        tf = _tf("TFEstimator")
        batch = next(iter(dataset.feature_set.batches(
            min(dataset.batch_size, max(1, len(dataset))), shuffle=False)))
        feats = list(batch.inputs) if isinstance(
            batch.inputs, (list, tuple)) else [batch.inputs]
        tg = batch.targets
        labels = [] if tg is None else (
            list(tg) if isinstance(tg, (list, tuple)) else [tg])
        self._n_features = len(feats)
        specs = [tf.TensorSpec((None,) + a.shape[1:],
                               tf.dtypes.as_dtype(np.asarray(a).dtype))
                 for a in feats + labels]

        spec_holder = {}

        def traced(*args):
            f = args[:self._n_features]
            lab = args[self._n_features:]
            features = f[0] if len(f) == 1 else list(f)
            lab_arg = lab[0] if len(lab) == 1 else (list(lab) or None)
            spec = self.model_fn(features, lab_arg, ModeKeys.TRAIN,
                                 self.params)
            if spec.loss is None or spec.predictions is None:
                raise ValueError(
                    "model_fn must return TFEstimatorSpec with both loss "
                    "and predictions for the TRAIN trace")
            spec_holder["n_pred"] = 1
            preds = spec.predictions
            if isinstance(preds, (list, tuple)):
                spec_holder["n_pred"] = len(preds)
                return (spec.loss, *preds)
            return spec.loss, preds

        self._lowered = lower_tf_callable(traced, specs, once=True)
        self._n_pred = spec_holder["n_pred"]
        self._zoo, self._tfnet = tfnet_model(
            self._lowered.graph_fn, [tuple(s.shape[1:]) for s in specs],
            self.optimizer, "identity", first_output=True)
        self._specs = specs

    # ------------------------------------------------------------------
    def train(self, input_fn_or_dataset, steps: Optional[int] = None,
              end_trigger=None, batch_size: Optional[int] = None):
        """(estimator.py:194 parity) input may be a TFDataset or a
        callable returning one."""
        from .tf_optimizer import _all_arrays

        dataset = _resolve(input_fn_or_dataset)
        self._trace(dataset)
        arrays = [np.asarray(a) for a in _all_arrays(dataset.feature_set)]
        train_fs = ArrayFeatureSet(
            arrays, [np.zeros((arrays[0].shape[0], 1), np.float32)])
        trainer = self._zoo._ensure_trainer()
        if end_trigger is None and steps is not None:
            end_trigger = MaxIteration(steps)
        trainer.train(train_fs,
                      batch_size=batch_size or dataset.batch_size,
                      end_trigger=end_trigger or MaxEpoch(1))
        self._lowered.write_back(self._tfnet.param_tree())
        return self

    def evaluate(self, input_fn_or_dataset, metrics=None) -> Dict[str, Any]:
        dataset = _resolve(input_fn_or_dataset)
        self._trace(dataset)
        losses = [float(np.mean(out)) for out in
                  self._forward_batches(dataset, want="loss")]
        return {"loss": float(np.mean(losses))}

    def predict(self, input_fn_or_dataset):
        dataset = _resolve(input_fn_or_dataset)
        self._trace(dataset)
        preds = list(self._forward_batches(dataset, want="pred"))
        if self._n_pred == 1:
            return np.concatenate(preds, axis=0)
        return [np.concatenate([p[i] for p in preds], axis=0)
                for i in range(self._n_pred)]

    # ------------------------------------------------------------------
    def _forward_batches(self, dataset: TFDataset, want: str):
        has_labels = len(self._specs) > self._n_features
        net = self._tfnet
        for batch in dataset.feature_set.batches(
                dataset.batch_size, shuffle=False, drop_remainder=False):
            arrays = batch_arrays(batch)
            if has_labels and len(arrays) == self._n_features:
                # predict-time input without labels: feed zeros
                for s in self._specs[self._n_features:]:
                    shape = (arrays[0].shape[0],) + tuple(s.shape[1:])
                    arrays.append(np.zeros(shape, s.dtype.as_numpy_dtype))
            with torch.no_grad():
                outs = net([torch.as_tensor(np.asarray(a), device=net.device)
                            for a in arrays])
            outs = outs if isinstance(outs, tuple) else (outs,)
            outs = [o.cpu().numpy() for o in outs]
            if want == "loss":
                yield outs[0]
            else:
                pred = outs[1:1 + self._n_pred]
                yield pred[0] if self._n_pred == 1 else pred


def _resolve(input_fn_or_dataset) -> TFDataset:
    if isinstance(input_fn_or_dataset, TFDataset):
        return input_fn_or_dataset
    return input_fn_or_dataset()
