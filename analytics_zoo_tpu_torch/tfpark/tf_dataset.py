"""TFDataset — the TFPark data bridge.

Counterpart of ``analytics_zoo_tpu/tfpark/tf_dataset.py``. Parity:
``pyzoo/zoo/pipeline/api/net/tf_dataset.py:112`` and its factory zoo
(``from_rdd``/``from_ndarrays``/``from_image_set``/``from_text_set``/
``from_tfrecord_file``/``from_feature_set``/``from_string_rdd``/
``from_bytes_rdd``, lines 302-577). The reference materializes TF
placeholders fed from Spark partitions; here a TFDataset is a thin,
declarative wrapper over the port's :class:`FeatureSet` — the trainer
consumes it directly (host batches → the staged host pipeline → the
device), no placeholder plumbing. Nothing here imports TensorFlow:
``from_tfrecord_file`` reads through ``feature.tfrecord``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from ..feature.feature_set import ArrayFeatureSet, FeatureSet, Sample


class TFDataset:
    """Declarative dataset: FeatureSet + global batch size (+ validation)."""

    def __init__(self, feature_set: FeatureSet, batch_size: int = 32,
                 batch_per_thread: int = -1,
                 validation_set: Optional[FeatureSet] = None):
        self.feature_set = feature_set
        self.batch_size = batch_size
        self.batch_per_thread = batch_per_thread
        self.validation_set = validation_set

    def __len__(self):
        return self.feature_set.size()

    # -- factories (tf_dataset.py:302-577) ------------------------------
    @classmethod
    def from_ndarrays(cls, tensors, batch_size: int = 32,
                      batch_per_thread: int = -1,
                      val_tensors=None, **kw) -> "TFDataset":
        """(features, labels) tuple of ndarrays (or nested lists)."""
        fs = _tensors_to_fs(tensors)
        val = _tensors_to_fs(val_tensors) if val_tensors is not None \
            else None
        return cls(fs, batch_size=batch_size,
                   batch_per_thread=batch_per_thread, validation_set=val)

    @classmethod
    def from_rdd(cls, rdd: Iterable[Sample], batch_size: int = 32,
                 batch_per_thread: int = -1, val_rdd=None,
                 **kw) -> "TFDataset":
        """Any iterable of :class:`Sample` (the RDD seam of the
        reference maps to 'any partition iterator')."""
        fs = FeatureSet.samples(list(rdd))
        val = FeatureSet.samples(list(val_rdd)) if val_rdd is not None \
            else None
        return cls(fs, batch_size=batch_size,
                   batch_per_thread=batch_per_thread, validation_set=val)

    @classmethod
    def from_feature_set(cls, dataset: FeatureSet, batch_size: int = 32,
                         batch_per_thread: int = -1,
                         validation_dataset=None) -> "TFDataset":
        return cls(dataset, batch_size=batch_size,
                   batch_per_thread=batch_per_thread,
                   validation_set=validation_dataset)

    @classmethod
    def from_image_set(cls, image_set, image_transformer=None,
                       label_key: str = "label",
                       batch_size: int = 32, **kw) -> "TFDataset":
        """ImageSet → TFDataset (tf_dataset.py:from_image_set)."""
        if image_transformer is not None:
            image_set = image_set.transform(image_transformer)
        feats, labels = [], []
        features = image_set.to_local().features
        for feat in features:
            sample = feat.get_sample()
            if sample is None:
                raise ValueError(
                    "image features carry no Sample — the transformer "
                    "chain must end in ImageSetToSample (or pass "
                    "image_transformer ending in it)")
            feats.append(sample.features[0])
            labels.append(feat.get(label_key))
        n_labeled = sum(l is not None for l in labels)
        if 0 < n_labeled < len(features):
            raise ValueError(
                f"{n_labeled}/{len(features)} images have a "
                f"'{label_key}' — labels must be all-or-nothing")
        fs = ArrayFeatureSet(
            [np.stack(feats)],
            [np.asarray(labels)] if n_labeled else None)
        return cls(fs, batch_size=batch_size, **kw)

    @classmethod
    def from_text_set(cls, text_set, batch_size: int = 32,
                      **kw) -> "TFDataset":
        """TextSet (word2idx'ed + generate_sample'd) → TFDataset."""
        samples = text_set.to_local().get_samples()
        if any(s is None for s in samples):
            raise ValueError(
                "text features carry no Sample — run generate_sample() "
                "on the TextSet first")
        return cls(FeatureSet.samples(samples), batch_size=batch_size, **kw)

    @classmethod
    def from_string_rdd(cls, string_rdd: Iterable[str],
                        batch_size: int = 32, **kw) -> "TFDataset":
        data = np.asarray(list(string_rdd), dtype=object)
        return cls(ArrayFeatureSet([data]), batch_size=batch_size, **kw)

    @classmethod
    def from_bytes_rdd(cls, bytes_rdd: Iterable[bytes],
                       batch_size: int = 32, **kw) -> "TFDataset":
        data = np.asarray(list(bytes_rdd), dtype=object)
        return cls(ArrayFeatureSet([data]), batch_size=batch_size, **kw)

    @classmethod
    def from_tfrecord_file(cls, file_path, parse_fn: Callable,
                           batch_size: int = 32, **kw) -> "TFDataset":
        """TFRecord file(s) → TFDataset (tf_dataset.py:456-501).

        ``parse_fn``: bytes → (features, label) numpy pair. Reading uses
        the native-or-python TFRecord reader in ``feature.tfrecord``.
        """
        from ..feature.tfrecord import read_tfrecord

        paths = [file_path] if isinstance(file_path, str) else list(file_path)
        feats, labels = [], []
        for p in paths:
            for rec in read_tfrecord(p):
                f, lab = parse_fn(rec)
                feats.append(f)
                labels.append(lab)
        fs = ArrayFeatureSet([np.stack(feats)],
                             [np.stack(labels)] if labels[0] is not None
                             else None)
        return cls(fs, batch_size=batch_size, **kw)

    # alias used throughout reference examples
    @classmethod
    def from_dataset(cls, *a, **kw):
        return cls.from_feature_set(*a, **kw)


def batch_arrays(batch) -> list:
    """Flatten a MiniBatch into [features..., labels...] arrays."""
    ins = batch.inputs
    out = list(ins) if isinstance(ins, (list, tuple)) else [ins]
    tg = batch.targets
    if tg is not None:
        out += list(tg) if isinstance(tg, (list, tuple)) else [tg]
    return out


def _tensors_to_fs(tensors) -> FeatureSet:
    if isinstance(tensors, FeatureSet):
        return tensors
    if isinstance(tensors, (list, tuple)) and len(tensors) == 2:
        x, y = tensors
        xs = list(x) if isinstance(x, (list, tuple)) else [np.asarray(x)]
        ys = list(y) if isinstance(y, (list, tuple)) else [np.asarray(y)]
        return ArrayFeatureSet([np.asarray(a) for a in xs],
                               [np.asarray(a) for a in ys])
    xs = list(tensors) if isinstance(tensors, (list, tuple)) \
        else [np.asarray(tensors)]
    return ArrayFeatureSet([np.asarray(a) for a in xs])
