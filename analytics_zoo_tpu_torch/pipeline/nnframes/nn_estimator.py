"""NNFrames: DataFrame-native training and inference stages.

Counterpart of ``analytics_zoo_tpu/pipeline/nnframes/nn_estimator.py``
(parity: ``zoo/.../pipeline/nnframes/NNEstimator.scala``: the class :198,
``internalFit`` :414-479, ``getDataSet`` :382, ``NNModel.internalTransform``
:665, persistence :743-870; ``NNClassifier.scala``; the python mirror
``pyzoo/zoo/pipeline/nnframes/nn_classifier.py``).

A frame is a pandas DataFrame or a dict of columns: the port duck-types
it (``_col_values``) and never imports pandas. ``fit`` turns the frame's
rows into samples (or spills them to ``.npz`` shards past
``ZooConfig.nnframes_spill_bytes``) and trains through the port's
:class:`Estimator` and :class:`SPMDTrainer` on the model's own
parameters. The camelCase Spark-ML setters are kept, with snake_case
aliases. ``NNModel.save``/``load`` write and read the JAX package's
layout (``model/`` by ``KerasNet.save_model`` and ``nnmodel.pkl``, whose
class paths name the JAX package), so either package loads the other's.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np

from ...common.zoo_trigger import EveryEpoch, MaxEpoch, ZooTrigger
from ...feature.common import (ChainedPreprocessing, Preprocessing,
                               SeqToMultipleTensors, SeqToTensor)
from ...feature.feature_set import FeatureSet, Sample
from ..api.keras.objectives import get_loss
from ..api.keras.optimizers import get_optimizer
from ..api.keras.engine.model_io import (FILE_PREFIX, PORT_PREFIX,
                                         file_module, port_class)
from ..api.keras.models import KerasNet
from ..estimator.estimator import Estimator


def _sizes_to_preprocessing(spec):
    """The python reference accepts a Preprocessing OR a (nested) list of
    tensor sizes (nn_classifier.py:154-181): [5] -> SeqToTensor([5]);
    [[1],[2]] -> SeqToMultipleTensors."""
    if spec is None or isinstance(spec, Preprocessing):
        return spec
    if isinstance(spec, (list, tuple)):
        if len(spec) > 0 and isinstance(spec[0], (list, tuple)):
            return SeqToMultipleTensors(spec)
        return SeqToTensor(spec)
    raise TypeError(f"unsupported preprocessing spec: {spec!r}")


def _col_values(df, col):
    try:
        return df[col].tolist()
    except (TypeError, AttributeError):  # not a pandas frame: dict of columns
        return list(df[col])


class _FilePickler(pickle._Pickler):
    """Pickles the port's classes under the JAX package's module paths
    (``model_io.file_module``), so the JAX package unpickles them as its
    own."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "") or ""
        if module.startswith(PORT_PREFIX) and self.proto >= 4:
            self.save(file_module(module))
            self.save(name or obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _FileUnpickler(pickle.Unpickler):
    """Reads ``nnmodel.pkl``: the JAX package's class paths map to the
    port's (``model_io.port_class``)."""

    def find_class(self, module, name):
        if module.startswith(FILE_PREFIX):
            return port_class(f"{module}.{name}")
        return super().find_class(module, name)


class _Params:
    """Minimal Spark-ML-param-style mixin: camelCase setters return self."""

    def setFeaturesCol(self, value):
        self.features_col = value
        return self

    def setLabelCol(self, value):
        self.label_col = value
        return self

    def setPredictionCol(self, value):
        self.prediction_col = value
        return self

    def setBatchSize(self, value):
        self.batch_size = int(value)
        return self

    def getBatchSize(self):
        return self.batch_size

    # snake_case aliases
    set_features_col = setFeaturesCol
    set_label_col = setLabelCol
    set_prediction_col = setPredictionCol
    set_batch_size = setBatchSize


class NNEstimator(_Params):
    """``NNEstimator(model, criterion, feature_preprocessing,
    label_preprocessing)`` — fit(df) -> NNModel.

    ``model`` is a KerasNet (Sequential/Model); ``criterion`` a loss name or
    LossFunction; preprocessings are Preprocessing chains or size lists.
    """

    def __init__(self, model: KerasNet, criterion,
                 feature_preprocessing=None, label_preprocessing=None):
        self.model = model
        self.criterion = get_loss(criterion)
        self.feature_preprocessing = _sizes_to_preprocessing(
            feature_preprocessing)
        self.label_preprocessing = _sizes_to_preprocessing(
            label_preprocessing)
        self.sample_preprocessing: Optional[Preprocessing] = None
        self.features_col = "features"
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 1
        self.end_when: Optional[ZooTrigger] = None
        self.learning_rate = 1e-3
        self.learning_rate_decay = 0.0
        self.optim_method = None
        self.caching_sample = True
        self.train_summary = None
        self.validation_summary = None
        self.validation = None  # (trigger, df, methods, batch_size)
        self.checkpoint = None  # (path, trigger, overwrite)
        self._clipping = None   # ("const", lo, hi) | ("l2", norm) | None
        self.data_cache_level = "DRAM"

    # -- Spark-ML-style configuration surface --------------------------
    def setSamplePreprocessing(self, value):
        self.sample_preprocessing = value
        return self

    def setMaxEpoch(self, value):
        self.max_epoch = int(value)
        return self

    def getMaxEpoch(self):
        return self.max_epoch

    def setEndWhen(self, trigger: ZooTrigger):
        self.end_when = trigger
        return self

    def getEndWhen(self):
        return self.end_when

    def setDataCacheLevel(self, level, num_slice=None):
        """Accepted for parity (NNEstimator.scala:260); it records intent
        and nothing else."""
        self.data_cache_level = level
        return self

    def getDataCacheLevel(self):
        return self.data_cache_level

    def setLearningRate(self, value):
        self.learning_rate = float(value)
        return self

    def getLearningRate(self):
        return self.learning_rate

    def setLearningRateDecay(self, value):
        self.learning_rate_decay = float(value)
        return self

    def getLearningRateDecay(self):
        return self.learning_rate_decay

    def setOptimMethod(self, value):
        self.optim_method = value
        return self

    def getOptimMethod(self):
        return self.optim_method

    def setCachingSample(self, value):
        self.caching_sample = bool(value)
        return self

    def isCachingSample(self):
        return self.caching_sample

    def setTrainSummary(self, value):
        self.train_summary = value
        return self

    def getTrainSummary(self):
        return self.train_summary

    def setValidationSummary(self, value):
        self.validation_summary = value
        return self

    def getValidationSummary(self):
        return self.validation_summary

    def setValidation(self, trigger, val_df, val_method, batch_size):
        self.validation = (trigger, val_df, val_method, int(batch_size))
        return self

    def getValidation(self):
        return self.validation

    def clearGradientClipping(self):
        self._clipping = None
        return self

    def setConstantGradientClipping(self, min, max):  # noqa: A002
        self._clipping = ("const", float(min), float(max))
        return self

    def setGradientClippingByL2Norm(self, clip_norm):
        self._clipping = ("l2", float(clip_norm))
        return self

    def setCheckpoint(self, path, trigger=None, isOverWrite=True):
        self.checkpoint = (path, trigger or EveryEpoch(), isOverWrite)
        return self

    def getCheckpoint(self):
        return self.checkpoint

    # snake_case aliases
    set_sample_preprocessing = setSamplePreprocessing
    set_max_epoch = setMaxEpoch
    set_end_when = setEndWhen
    set_learning_rate = setLearningRate
    set_learning_rate_decay = setLearningRateDecay
    set_optim_method = setOptimMethod
    set_caching_sample = setCachingSample
    set_train_summary = setTrainSummary
    set_validation_summary = setValidationSummary
    set_validation = setValidation
    set_checkpoint = setCheckpoint
    clear_gradient_clipping = clearGradientClipping
    set_constant_gradient_clipping = setConstantGradientClipping
    set_gradient_clipping_by_l2_norm = setGradientClippingByL2Norm

    # -- dataset extraction (getDataSet parity, NNEstimator.scala:382) --
    def _row_to_sample(self, f, lbl) -> Sample:
        if self.sample_preprocessing is not None:
            return self.sample_preprocessing.apply((f, lbl))
        fv = self.feature_preprocessing.apply(f) \
            if self.feature_preprocessing else np.asarray(f, np.float32)
        lv = None
        if lbl is not None:
            lv = self.label_preprocessing.apply(lbl) \
                if self.label_preprocessing else np.asarray(lbl, np.float32)
        return Sample(fv, lv)

    def _raw_columns(self, df, with_label=True):
        feats = _col_values(df, self.features_col)
        labels = None
        if with_label and self.label_col is not None and \
                self.label_col in getattr(df, "columns", df):
            labels = _col_values(df, self.label_col)
        return feats, labels

    def _samples_from_columns(self, feats, labels):
        return [self._row_to_sample(
            f, labels[i] if labels is not None else None)
            for i, f in enumerate(feats)]

    def _extract_samples(self, df, with_label=True):
        return self._samples_from_columns(*self._raw_columns(df, with_label))

    @staticmethod
    def _sample_nbytes(sample: Sample) -> int:
        total = 0
        for part in (sample.features, sample.labels):
            for a in (part or ()):
                total += np.asarray(a).nbytes
        return total

    def _maybe_spill(self, feats, labels) -> Optional[FeatureSet]:
        """Auto-spill (VERDICT r3 next #8): when the PROCESSED samples of
        the DataFrame would exceed ``config.nnframes_spill_bytes``
        (preprocessing can expand rows by orders of magnitude — an image
        path becomes a 224x224x3 tensor), write ~64 MB ``.npz`` shards and
        stream them via ShardedFileFeatureSet instead of keeping every
        sample resident. The estimate processes a handful of rows spread
        across the dataset; the spill then processes chunk-by-chunk, so
        peak memory is one shard, not the dataset. The spill directory lives as long as the returned
        FeatureSet (weakref finalizer removes it)."""
        from ...common.nncontext import get_nncontext
        from ...feature.feature_set import (DiskFeatureSet,
                                            ShardedFileFeatureSet,
                                            stack_samples)

        threshold = get_nncontext().config.nnframes_spill_bytes
        n = len(feats)
        if n == 0:
            return None
        # probe rows spread across the dataset, not just row 0: with
        # heterogeneous rows (variable-length sequences, mixed image
        # sizes) a small first row would underestimate the total and the
        # spill would silently never trigger
        probe_idx = sorted({int(i) for i in
                            np.linspace(0, n - 1, num=min(n, 8))})
        probe_sizes = [max(1, self._sample_nbytes(self._row_to_sample(
            feats[i], labels[i] if labels is not None else None)))
            for i in probe_idx]
        per_sample = max(1, int(np.mean(probe_sizes)))
        if per_sample * n <= threshold:
            return None
        import shutil
        import tempfile
        import weakref

        # each shard must respect the memory bound that triggered the
        # spill (and a 64 MB practical cap); size shards by the LARGEST
        # probed row so oversized rows can't blow the bound
        shard_bytes = min(threshold, 64 << 20)
        shard_rows = int(min(n, max(1, shard_bytes // max(probe_sizes))))
        spill_dir = tempfile.mkdtemp(prefix="zoo_nnframes_spill_")
        paths = []
        for start in range(0, n, shard_rows):
            chunk = [self._row_to_sample(
                feats[i], labels[i] if labels is not None else None)
                for i in range(start, min(start + shard_rows, n))]
            xs, ys = stack_samples(chunk)
            path = os.path.join(spill_dir,
                                f"shard{start // shard_rows:05d}.npz")
            DiskFeatureSet.write_shard(path, list(xs), ys)
            paths.append(path)
        import logging
        logging.getLogger("analytics_zoo_tpu_torch.nnframes").info(
            "NNFrames ingest spilled %d samples (~%.1f MB) to %d shards "
            "under %s", n, per_sample * n / 1e6, len(paths), spill_dir)
        # the shards were written from THIS process's rows — no further
        # per-host striping (shard_per_host would drop all but 1/P of them)
        fs = ShardedFileFeatureSet(paths, num_slice=1, shard_per_host=False)
        weakref.finalize(fs, shutil.rmtree, spill_dir, ignore_errors=True)
        return fs

    def _get_dataset(self, df, with_label=True) -> FeatureSet:
        # scalable ingest (SURVEY hard part (a)): a FeatureSet — notably
        # FeatureSet.files() over per-host-striped shards — streams
        # directly into the engine instead of materializing columns
        if isinstance(df, FeatureSet):
            return df
        if isinstance(df, str):
            # dataset URI (partitioned parquet/arrow directory): every
            # non-label column is a feature; each host streams its
            # disjoint size-balanced shard subset (feature/dataset.py)
            return FeatureSet.from_dataset(df, label_col=self.label_col)
        if isinstance(df, (list, tuple)) and df and \
                all(isinstance(p, str) for p in df):
            return FeatureSet.files(list(df), label_col=self.label_col)
        feats, labels = self._raw_columns(df, with_label)
        spilled = self._maybe_spill(feats, labels)
        if spilled is not None:
            return spilled
        return FeatureSet.samples(self._samples_from_columns(feats, labels))

    # -- fit (internalFit parity, NNEstimator.scala:414-479) ------------
    def fit(self, df) -> "NNModel":
        train_set = self._get_dataset(df)
        optimizer = get_optimizer(
            self.optim_method if self.optim_method is not None else "sgd")
        if self.optim_method is None:
            optimizer.lr = self.learning_rate
            optimizer.decay = self.learning_rate_decay
        ckpt_dir = self.checkpoint[0] if self.checkpoint else None
        est = Estimator(self.model, optim_methods=optimizer,
                        model_dir=ckpt_dir)
        if self._clipping is not None:
            if self._clipping[0] == "const":
                est.set_constant_gradient_clipping(*self._clipping[1:])
            else:
                est.set_l2_norm_gradient_clipping(self._clipping[1])
        trainer = est._ensure_trainer(self.criterion, None)
        if self.train_summary is not None:
            trainer.train_summary = self.train_summary
        if self.validation_summary is not None:
            trainer.val_summary = self.validation_summary

        validation_set = validation_trigger = validation_methods = None
        if self.validation is not None:
            validation_trigger, val_df, validation_methods, _ = \
                self.validation
            validation_set = self._get_dataset(val_df)
        end_trigger = self.end_when or MaxEpoch(self.max_epoch)
        ckpt_trigger = self.checkpoint[1] if self.checkpoint else None
        criterion = self.criterion
        trainer.loss_fn = criterion
        if validation_methods:
            from ..api.keras.metrics import get_metric
            trainer.metrics = [get_metric(m, criterion)
                               for m in validation_methods]
        trainer.train(train_set, batch_size=self.batch_size,
                      end_trigger=end_trigger,
                      checkpoint_trigger=ckpt_trigger,
                      validation_set=validation_set,
                      validation_trigger=validation_trigger)
        return self._create_model(self.model)

    def _create_model(self, model) -> "NNModel":
        m = NNModel(model, feature_preprocessing=self.feature_preprocessing)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m


class NNModel(_Params):
    """Transformer: adds ``prediction_col`` to a frame
    (NNModel.internalTransform parity: the broadcast model and the
    per-partition predict become one batched ``predict``)."""

    def __init__(self, model: KerasNet, feature_preprocessing=None):
        self.model = model
        self.feature_preprocessing = _sizes_to_preprocessing(
            feature_preprocessing)
        self.features_col = "features"
        self.prediction_col = "prediction"
        self.batch_size = 128

    def _featurize(self, df):
        feats = _col_values(df, self.features_col)
        samples = []
        for f in feats:
            fv = self.feature_preprocessing.apply(f) \
                if self.feature_preprocessing else np.asarray(f, np.float32)
            samples.append(Sample(fv))
        return FeatureSet.samples(samples)

    def transform(self, df):
        fs = self._featurize(df)
        preds = self.model.predict(fs, batch_size=self.batch_size)
        out = df.copy()
        if isinstance(preds, list):  # multi-output: tuple rows
            out[self.prediction_col] = list(zip(*[list(p) for p in preds]))
        else:
            vals = [p.tolist() if getattr(p, "ndim", 0) > 0 else float(p)
                    for p in preds]
            out[self.prediction_col] = vals
        return out

    predict = transform

    # -- ML persistence (NNEstimator.scala:743-870) ---------------------
    def save(self, path):
        os.makedirs(path, exist_ok=True)
        self.model.save_model(os.path.join(path, "model"), over_write=True)
        meta = {"class": type(self).__name__,
                "features_col": self.features_col,
                "prediction_col": self.prediction_col,
                "batch_size": self.batch_size,
                "feature_preprocessing": self.feature_preprocessing,
                "extra": self._save_extra()}
        with open(os.path.join(path, "nnmodel.pkl"), "wb") as f:
            _FilePickler(f, protocol=4).dump(meta)

    def _save_extra(self):
        return {}

    @staticmethod
    def load(path) -> "NNModel":
        with open(os.path.join(path, "nnmodel.pkl"), "rb") as f:
            meta = _FileUnpickler(f).load()
        klass = {"NNModel": NNModel,
                 "NNClassifierModel": NNClassifierModel}[meta["class"]]
        model = KerasNet.load_model(os.path.join(path, "model"))
        obj = klass(model,
                    feature_preprocessing=meta["feature_preprocessing"])
        obj.features_col = meta["features_col"]
        obj.prediction_col = meta["prediction_col"]
        obj.batch_size = meta["batch_size"]
        for k, v in meta.get("extra", {}).items():
            setattr(obj, k, v)
        return obj


class NNClassifier(NNEstimator):
    """Classification specialization: scalar label column, argmax
    prediction (NNClassifier.scala)."""

    def __init__(self, model, criterion=None, feature_preprocessing=None):
        super().__init__(model, criterion or "sparse_categorical_crossentropy",
                         feature_preprocessing=feature_preprocessing,
                         label_preprocessing=None)

    def _create_model(self, model) -> "NNClassifierModel":
        m = NNClassifierModel(
            model, feature_preprocessing=self.feature_preprocessing)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m


class NNClassifierModel(NNModel):
    """Adds argmax + optional binary threshold (HasThreshold parity)."""

    def __init__(self, model, feature_preprocessing=None):
        super().__init__(model, feature_preprocessing)
        self.threshold = 0.5

    def setThreshold(self, value):
        self.threshold = float(value)
        return self

    set_threshold = setThreshold

    def _save_extra(self):
        return {"threshold": self.threshold}

    def transform(self, df):
        fs = self._featurize(df)
        preds = self.model.predict(fs, batch_size=self.batch_size)
        preds = np.asarray(preds)
        if preds.ndim <= 1 or preds.shape[-1] == 1:
            cls = (preds.reshape(len(preds)) > self.threshold).astype(
                np.float64)
        else:
            cls = np.argmax(preds, axis=-1).astype(np.float64)
        out = df.copy()
        out[self.prediction_col] = cls
        return out
