"""Preprocessing chains + sample adapters + relations.

Counterpart of ``analytics_zoo_tpu/feature/common.py``, a numpy-only copy
with the same names (parity: ``zoo/.../feature/common/*.scala``,
Preprocessing.scala:82 ``->`` composition, the adapters of
FeatureLabelPreprocessing/ToTuple/..., Relations.scala; and
``pyzoo/zoo/feature/common.py``). Preprocessing is host-side numpy; a
chain is a plain function composition. ``Relations.generate_relation_pairs``
draws its negatives from the same seeded ``random.Random`` as the JAX
package, so both packages build the same pairs.
"""

from __future__ import annotations

import csv
import random
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from .feature_set import MiniBatch, Sample


class Preprocessing:
    """Composable transformer: ``(a >> b)(x) == b(a(x))``.

    Parity: ``Preprocessing[A, B]`` with ``->`` composition
    (feature/common/Preprocessing.scala:82). Subclasses implement
    ``apply(x)`` (one element). ``__call__`` on an iterator maps lazily.
    """

    #: Declares the chain dominated by GIL-holding Python compute (pure-
    #: Python loops, PIL decode, ...) rather than GIL-releasing numpy
    #: kernels; kept for the JAX package's surface (its infeed reads it).
    cpu_bound = False

    def apply(self, x):
        raise NotImplementedError(type(self).__name__)

    def __call__(self, x):
        # Only true iterators/generators are mapped lazily; plain lists are
        # single elements (SeqToTensor([1,2,3]) must yield one tensor).
        if hasattr(x, "__next__"):
            return (self.apply(e) for e in x)
        return self.apply(x)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    # alias matching the scala operator name in docs
    def and_then(self, other):
        return self >> other


class ChainedPreprocessing(Preprocessing):
    """Parity: ChainedPreprocessing (pyzoo feature/common.py)."""

    def __init__(self, transformers: Sequence[Preprocessing]):
        flat: List[Preprocessing] = []
        for t in transformers:
            if isinstance(t, ChainedPreprocessing):
                flat.extend(t.transformers)
            else:
                flat.append(t)
        self.transformers = flat

    @property
    def cpu_bound(self):  # type: ignore[override]
        return any(getattr(t, "cpu_bound", False) for t in self.transformers)

    def apply(self, x):
        for t in self.transformers:
            x = t.apply(x)
        return x


class LambdaPreprocessing(Preprocessing):
    def __init__(self, fn: Callable, cpu_bound: bool = False):
        self.fn = fn
        self.cpu_bound = cpu_bound

    def apply(self, x):
        return self.fn(x)


class ScalarToTensor(Preprocessing):
    def apply(self, x):
        return np.asarray(x, np.float32).reshape(())


class SeqToTensor(Preprocessing):
    """A sequence of numbers -> ndarray of given size (SeqToTensor.scala)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = None if size is None else tuple(int(s) for s in size)

    def apply(self, x):
        arr = np.asarray(x, np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr


class SeqToMultipleTensors(Preprocessing):
    """Splits a flat sequence into several tensors of the given sizes."""

    def __init__(self, sizes: Sequence[Sequence[int]]):
        self.sizes = [tuple(int(s) for s in sz) for sz in sizes]

    def apply(self, x):
        arr = np.asarray(x, np.float32).reshape(-1)
        outs, off = [], 0
        for sz in self.sizes:
            n = int(np.prod(sz))
            outs.append(arr[off:off + n].reshape(sz))
            off += n
        return outs


class ArrayToTensor(Preprocessing):
    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = None if size is None else tuple(int(s) for s in size)

    def apply(self, x):
        arr = np.asarray(x, np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr


class MLlibVectorToTensor(Preprocessing):
    """Accepts anything exposing ``toArray`` (pyspark/MLlib vectors) or a
    plain sequence (MLlibVectorToTensor.scala)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = None if size is None else tuple(int(s) for s in size)

    def apply(self, x):
        arr = np.asarray(x.toArray() if hasattr(x, "toArray") else x,
                         np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr


class TensorToSample(Preprocessing):
    def apply(self, x):
        return Sample(x)


class FeatureLabelPreprocessing(Preprocessing):
    """Applies a feature chain and a label chain to a (feature, label) pair
    and produces a Sample (FeatureLabelTransformer.scala)."""

    def __init__(self, feature_preprocessing: Preprocessing,
                 label_preprocessing: Optional[Preprocessing] = None):
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing

    def apply(self, x):
        feat, label = x
        f = self.feature_preprocessing.apply(feat)
        lbl = None
        if label is not None:
            lbl = self.label_preprocessing.apply(label) \
                if self.label_preprocessing else np.asarray(label, np.float32)
        return Sample(f, lbl)


class ToTuple(Preprocessing):
    """feature -> (feature, None) (ToTuple.scala)."""

    def apply(self, x):
        return (x, None)


class FeatureToTupleAdapter(Preprocessing):
    def __init__(self, preprocessing: Preprocessing):
        self.preprocessing = preprocessing

    def apply(self, x):
        return (self.preprocessing.apply(x[0]), x[1])


class BigDLAdapter(Preprocessing):
    """Parity shim: wraps any callable as a Preprocessing."""

    def __init__(self, transformer):
        self.transformer = transformer

    def apply(self, x):
        return self.transformer(x)


class SampleToMiniBatch(Preprocessing):
    """Batches an iterable of Samples into MiniBatches. Parity:
    ``MTSampleToMiniBatch`` (feature/common/MTSampleToMiniBatch.scala),
    on one thread."""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder

    def apply(self, x):
        raise TypeError("SampleToMiniBatch operates on iterators; "
                        "call it, don't apply it")

    def __call__(self, samples: Iterable[Sample]):
        buf: List[Sample] = []
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._stack(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._stack(buf)

    @staticmethod
    def _stack(buf: List[Sample]):
        from .feature_set import stack_samples

        xs, ys = stack_samples(buf)
        return MiniBatch(xs, ys, np.ones(len(buf), np.float32))


# ---------------------------------------------------------------------------
# Relations (QA ranking datasets) — feature/common/Relations.scala
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Relation:
    id1: str
    id2: str
    label: int


@dataclass(frozen=True)
class RelationPair:
    """id1 with one positive and one negative id2."""

    id1: str
    id2_positive: str
    id2_negative: str


class Relations:
    @staticmethod
    def read(path: str) -> List[Relation]:
        """Reads relations from csv (columns id1,id2,label, with or without
        header) or parquet (Relations.scala:40-76). pyarrow is imported
        only for parquet."""
        if path.endswith(".parquet"):
            return Relations.read_parquet(path)
        out = []
        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        if rows and rows[0][:3] in (["id1", "id2", "label"],):
            rows = rows[1:]
        for r in rows:
            if len(r) < 3:
                continue
            out.append(Relation(r[0], r[1], int(float(r[2]))))
        return out

    @staticmethod
    def read_parquet(path: str) -> List[Relation]:
        import pyarrow.parquet as pq

        tbl = pq.read_table(path)
        d = tbl.to_pydict()
        return [Relation(str(a), str(b), int(c))
                for a, b, c in zip(d["id1"], d["id2"], d["label"])]

    @staticmethod
    def generate_relation_pairs(relations: Sequence[Relation],
                                seed: Optional[int] = None
                                ) -> List[RelationPair]:
        """For each id1, pair every positive id2 with a random negative id2
        (Relations.scala:80-112)."""
        rng = random.Random(seed)
        by_id1: dict = {}
        for r in relations:
            pos, neg = by_id1.setdefault(r.id1, ([], []))
            (pos if r.label > 0 else neg).append(r.id2)
        pairs = []
        for id1, (pos, neg) in by_id1.items():
            if not neg:
                continue
            for p in pos:
                pairs.append(RelationPair(id1, p, rng.choice(neg)))
        return pairs
