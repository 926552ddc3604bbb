"""FeatureSet: the train-time dataset abstraction.

Counterpart of ``analytics_zoo_tpu/feature/feature_set.py``; so far
what ``Model.fit``/``evaluate``/``predict`` and the recommenders read:
:class:`Sample` and :func:`stack_samples`, :class:`MiniBatch`, the
:class:`FeatureSet` base (with ``FeatureSet.samples``) and the in-memory
:class:`ArrayFeatureSet`.
Batches are host numpy; the trainer copies each to the device. The epoch
order is the JAX package's exactly (``np.random.default_rng(seed)``
shuffles the row indices), so the same seed feeds both packages the same
rows in the same batches.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class Sample:
    """One (features, labels) record; mirrors BigDL ``Sample`` marshalled
    via JTensor (pyzoo/zoo/common/utils.py:75)."""

    def __init__(self, features, labels=None):
        self.features = _as_list(features)
        self.labels = _as_list(labels) if labels is not None else None

    @staticmethod
    def from_ndarray(features, labels=None):
        return Sample(features, labels)


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return [np.asarray(v) for v in x]
    return [np.asarray(x)]


def stack_samples(samples: Sequence[Sample]):
    """Stack Samples into (features tuple, labels): labels None, one
    array, or a list of arrays."""
    samples = list(samples)
    if not samples:
        raise ValueError("empty sample collection")
    n_feat = len(samples[0].features)
    feats = tuple(np.stack([s.features[i] for s in samples])
                  for i in range(n_feat))
    labels = None
    if samples[0].labels is not None:
        labs = [np.stack([s.labels[i] for s in samples])
                for i in range(len(samples[0].labels))]
        labels = labs[0] if len(labs) == 1 else labs
    return feats, labels


class MiniBatch(tuple):
    """(inputs: tuple, targets, sample_weight)."""
    __slots__ = ()

    def __new__(cls, inputs, targets=None, weights=None):
        return super().__new__(cls, (tuple(inputs), targets, weights))

    def __getnewargs__(self):
        return (self[0], self[1], self[2])

    @property
    def inputs(self):
        return self[0]

    @property
    def targets(self):
        return self[1]

    @property
    def weights(self):
        return self[2]


class FeatureSet:
    """Base: iterable of minibatches over host-resident data."""

    def size(self) -> int:
        raise NotImplementedError

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = True, pad_remainder: bool = False,
                seed: int = 0) -> Iterator[MiniBatch]:
        raise NotImplementedError

    @staticmethod
    def samples(samples: Sequence[Sample]) -> "ArrayFeatureSet":
        feats, labels = stack_samples(samples)
        return ArrayFeatureSet(
            list(feats) if len(feats) > 1 else feats[0], labels)


class ArrayFeatureSet(FeatureSet):
    """In-memory dataset of numpy arrays."""

    def __init__(self, features, labels=None, weights=None):
        self.features: List[np.ndarray] = [np.asarray(f) for f in (
            features if isinstance(features, (list, tuple)) else [features])]
        n = self.features[0].shape[0]
        for f in self.features:
            if f.shape[0] != n:
                raise ValueError("feature arrays disagree on batch dim")
        self.labels = None
        if labels is not None:
            self.labels = [np.asarray(l) for l in (
                labels if isinstance(labels, (list, tuple)) else [labels])]
            for l in self.labels:
                if l.shape[0] != n:
                    raise ValueError("labels disagree with the features on "
                                     "the batch dim")
        self.weights = np.asarray(weights) if weights is not None else None
        self._n = n

    def size(self):
        return self._n

    def batches(self, batch_size, shuffle=False, drop_remainder=True,
                pad_remainder=False, seed=0):
        """Batches in the JAX package's order. A short last batch (kept
        when ``drop_remainder`` is False) is padded to ``batch_size`` by
        repeating its last row with zero weight when ``pad_remainder``."""
        n = self._n
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, end, batch_size):
            take = idx[start:start + batch_size]
            pad = 0
            if take.shape[0] < batch_size and pad_remainder:
                pad = batch_size - take.shape[0]
                take = np.concatenate([take, np.repeat(take[-1:], pad)])
            xs = tuple(f[take] for f in self.features)
            ys = None
            if self.labels is not None:
                ys = [l[take] for l in self.labels]
                ys = ys[0] if len(ys) == 1 else tuple(ys)
            w = np.ones(take.shape[0], np.float32)
            if self.weights is not None:
                w = self.weights[take].astype(np.float32)
            if pad:
                w[-pad:] = 0.0
            yield MiniBatch(xs, ys, w)
