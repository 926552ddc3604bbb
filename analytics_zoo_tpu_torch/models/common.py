"""ZooModel base.

Counterpart of ``analytics_zoo_tpu/models/common.py`` (parity:
``ZooModel.scala`` + ``KerasZooModel`` and the python mirror
``pyzoo/zoo/models/common/zoo_model.py``): a built-in model owns an
internal Keras graph (``self.model``) and forwards the training and
inference surface to it. ``save_model``/``load_model`` keep a zoo model
in the JAX package's layout: the internal Keras model under ``keras/``
(``KerasNet.save_model``) and ``zoo_model.pkl`` with the class, its
module (the JAX package's path, as ``model_io`` writes class paths) and
the recorded config, so either package loads what the other saved.
``Ranker`` gives the text-matching models NDCG and MAP over query groups
(a ``TextSet`` of relation lists, or ``[(features, labels), ...]``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..pipeline.api.keras.engine.model_io import (FILE_PREFIX,
                                                  file_module, port_class)


class _MetaUnpickler(pickle.Unpickler):
    """Reads ``zoo_model.pkl``: builtins and numpy, and the JAX package's
    classes mapped to the port's (``model_io.port_class``); anything else
    is refused."""

    _SAFE = {"builtins", "collections", "numpy", "numpy.core.multiarray",
             "numpy._core.multiarray", "numpy.dtypes"}

    def find_class(self, module, name):
        if module in self._SAFE:
            return super().find_class(module, name)
        if module.startswith(FILE_PREFIX):
            return port_class(f"{module}.{name}")
        raise pickle.UnpicklingError(
            f"zoo_model.pkl names {module}.{name}, outside the zoo and "
            "the builtins")


class ZooModel:
    """Base for the built-in model zoo; subclasses set ``self.model`` to a
    KerasNet built in ``build_model``."""

    model = None

    # -- training surface forwarded to the internal KerasNet -----------
    def compile(self, optimizer, loss, metrics=None):
        return self.model.compile(optimizer, loss, metrics)

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, **kw):
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                              validation_data=validation_data, **kw)

    def evaluate(self, x, y=None, batch_size=32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=128, distributed=True):
        return self.model.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size=128, zero_based_label=True):
        return self.model.predict_classes(
            x, batch_size=batch_size, zero_based_label=zero_based_label)

    def set_tensorboard(self, log_dir, app_name):
        self.model.set_tensorboard(log_dir, app_name)

    def set_checkpoint(self, path, over_write=True, trigger=None):
        self.model.set_checkpoint(path, over_write=over_write,
                                  trigger=trigger)

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.model.set_constant_gradient_clipping(min_value, max_value)

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self.model.set_gradient_clipping_by_l2_norm(clip_norm)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, weights):
        self.model.set_weights(weights)

    def summary(self):
        return self.model.summary()

    # -- persistence ---------------------------------------------------
    def save_model(self, path, weight_path=None, over_write=False):
        """Save the wrapper's config and the internal Keras model."""
        if os.path.exists(path) and not over_write:
            raise IOError(f"{path} exists; pass over_write=True")
        os.makedirs(path, exist_ok=True)
        self.model.save_model(os.path.join(path, "keras"), over_write=True)
        meta = {"class": type(self).__name__,
                "module": file_module(type(self).__module__),
                "config": getattr(self, "_zoo_config", {})}
        with open(os.path.join(path, "zoo_model.pkl"), "wb") as f:
            pickle.dump(meta, f)

    saveModel = save_model

    @classmethod
    def load_model(cls, path, weight_path=None):
        """The zoo model a ``save_model`` directory holds (either
        package's), its internal model on the context's device."""
        from ..pipeline.api.keras.models import KerasNet

        with open(os.path.join(path, "zoo_model.pkl"), "rb") as f:
            meta = _MetaUnpickler(f).load()
        klass = port_class(f"{meta['module']}.{meta['class']}")
        obj = klass.__new__(klass)
        obj._zoo_config = dict(meta["config"])
        for k, v in meta["config"].items():
            setattr(obj, k, v)
        obj.model = KerasNet.load_model(os.path.join(path, "keras"))
        return obj

    loadModel = load_model

    def _record_config(self, **kwargs):
        self._zoo_config = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)


KerasZooModel = ZooModel


class Ranker:
    """Validation with ranking metrics for matching models (parity:
    ``pyzoo/zoo/models/common/ranker.py`` ``evaluateNDCG``/``evaluateMAP``).
    ``x`` is a ``TextSet`` whose every TextFeature holds ONE query's
    candidate batch -- features ``(listLength, d)``, labels
    ``(listLength, 1)``, exactly what ``TextSet.from_relation_lists``
    builds -- or a list of query groups ``[(features, labels), ...]``.
    Mix into a model exposing ``predict``."""

    def _ranking_groups(self, x):
        if hasattr(x, "features"):           # a TextSet
            for tf_ in x.features:
                sample = tf_.get_sample()
                assert sample is not None, \
                    "TextFeature has no sample; run from_relation_lists " \
                    "(or generate_sample) first"
                yield (np.asarray(sample.features[0]),
                       np.asarray(sample.labels[0]).reshape(-1))
        else:                                 # [(features, labels), ...]
            for feats, labels in x:
                yield np.asarray(feats), np.asarray(labels).reshape(-1)

    def _ranked_relevance(self, feats, labels, threshold):
        scores = np.asarray(
            self.predict(feats, batch_size=max(len(feats), 1))).reshape(-1)
        order = np.argsort(-scores, kind="stable")
        return (labels > threshold).astype(np.float64)[order]

    def evaluate_ndcg(self, x, k: int, threshold: float = 0.0) -> float:
        """Mean NDCG@k over the query groups of ``x``. Queries with no
        positive record contribute 0 (reference semantics)."""
        vals = []
        for feats, labels in self._ranking_groups(x):
            rel = self._ranked_relevance(feats, labels, threshold)
            gains = rel[:k]
            discounts = np.log2(np.arange(2, len(gains) + 2))
            dcg = float((gains / discounts).sum())
            ideal = np.sort(rel)[::-1][:k]
            idcg = float((ideal / discounts[:len(ideal)]).sum())
            vals.append(dcg / idcg if idcg > 0 else 0.0)
        return float(np.mean(vals)) if vals else 0.0

    def evaluate_map(self, x, threshold: float = 0.0) -> float:
        """Mean average precision over the query groups of ``x``."""
        vals = []
        for feats, labels in self._ranking_groups(x):
            rel = self._ranked_relevance(feats, labels, threshold)
            if rel.sum() == 0:
                vals.append(0.0)
                continue
            prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            vals.append(float((prec * rel).sum() / rel.sum()))
        return float(np.mean(vals)) if vals else 0.0
