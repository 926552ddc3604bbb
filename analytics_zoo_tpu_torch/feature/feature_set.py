"""FeatureSet: the train-time dataset abstraction.

Counterpart of ``analytics_zoo_tpu/feature/feature_set.py``, copied. The
reference (``zoo/.../feature/FeatureSet.scala``) is an RDD-backed dataset
with memory tiers (DRAM / PMEM / DIRECT / DISK_AND_DRAM) feeding
per-executor MiniBatch iterators. Here samples live in host RAM (numpy,
possibly memory-mapped), a Preprocessing chain runs per batch on a thread
or process pool (:class:`TransformedFeatureSet`, with the DRAM cache and
the disk-backed DIRECT arena beneath it), a background thread prefetches
minibatches, and the trainer stages each batch onto the card through
pinned buffers on a side stream (``pipeline/engine.py``), so the host to
card copy overlaps the previous step's compute. Nothing here imports
torch. Epoch orders (``np.random.default_rng(seed)`` shuffles the row
indices), cache replays, pad rows and the arena's file format are the JAX
package's bit for bit, so the same seed feeds both packages the same rows
in the same batches.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import logging
import math
import mmap as mmap_mod
import os
import queue
import sys
import tempfile
import threading
import time
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.feature")


class Sample:
    """One (features, labels) record; mirrors BigDL ``Sample`` marshalled via
    JTensor (pyzoo/zoo/common/utils.py:75)."""

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


class MiniBatch(tuple):
    """(inputs: tuple, targets, sample_weight)."""
    __slots__ = ()

    def __new__(cls, inputs, targets=None, weights=None):
        return super().__new__(cls, (tuple(inputs), targets, weights))

    def __getnewargs__(self):
        # without this, pickle rebuilds via MiniBatch.__new__(cls, self)
        # which re-nests the whole triple under ``inputs`` — silently
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

    def num_batches(self, batch_size: int, drop_remainder: bool) -> int:
        n = self.size()
        return n // batch_size if drop_remainder else math.ceil(n / batch_size)

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = True, pad_remainder: bool = False,
                seed: int = 0) -> Iterator[MiniBatch]:
        raise NotImplementedError

    def transform(self, preprocessing) -> "FeatureSet":
        return TransformedFeatureSet(self, preprocessing)

    def __len__(self):
        return self.size()

    # -- factories (parity with FeatureSet.rdd / ImageSet / python
    #    zoo.feature.common.FeatureSet) --------------------------------
    @staticmethod
    def array(features, labels=None, weights=None) -> "ArrayFeatureSet":
        return ArrayFeatureSet(features, labels, weights)

    @staticmethod
    def sample_rdd(samples: Sequence[Sample], **kw) -> "ArrayFeatureSet":
        return FeatureSet.samples(samples)

    @staticmethod
    def samples(samples: Sequence[Sample]) -> "ArrayFeatureSet":
        feats, labels = stack_samples(samples)
        return ArrayFeatureSet(
            list(feats) if len(feats) > 1 else feats[0], labels)

    @staticmethod
    def generator(fn: Callable[[], Iterator], size: int,
                  batch_size_hint: Optional[int] = None):
        return GeneratorFeatureSet(fn, size)

    @staticmethod
    def rdd(data, memory_type: str = "DRAM", **kw) -> "FeatureSet":
        """Memory-tier factory (parity: ``FeatureSet.rdd``
        ``feature/FeatureSet.scala:423-455`` with DRAM | PMEM | DIRECT |
        DISK_AND_DRAM(n)).

        ``data``: a FeatureSet, a sequence of Samples, or for
        DISK_AND_DRAM a list of ``.npz`` shard paths. PMEM and DIRECT
        both map to the native host arena (``utils/csrc/zoo_data.cpp``)
        — off-GC staging RAM replaces Optane. A full arena
        (``MemoryError``) stages the arrays through disk-backed mmaps
        instead and says so in the log; a failed build of the arena's
        library raises.
        """
        mt = str(memory_type).upper()
        if mt.startswith("DISK_AND_DRAM"):
            num_slice = 1
            if "(" in mt:
                num_slice = int(mt.split("(")[1].rstrip(")"))
            return DiskFeatureSet(list(data), num_slice=num_slice)
        if isinstance(data, FeatureSet):
            fs = data
        else:
            fs = FeatureSet.samples(list(data))
        if mt in ("PMEM", "DIRECT"):
            if isinstance(fs, TransformedFeatureSet):
                # DIRECT tier for transformed pipelines = disk-backed
                # mmap'd arena beneath the DRAM prefix: batches past
                # cache_bytes spill to one file every process on the
                # host shares (docs/data-pipeline.md)
                fs.cache(
                    int(kw.get("cache_bytes", DEFAULT_DRAM_CACHE_BYTES)),
                    arena_path=kw.get("arena_path") or default_arena_path(),
                    arena_bytes=kw.get("arena_bytes"))
                return fs
            if isinstance(fs, ArrayFeatureSet):
                try:
                    return DirectFeatureSet(fs.features, fs.labels,
                                            fs.weights)
                except MemoryError as e:
                    # native arena full: stage the arrays through
                    # disk-backed mmaps instead of silently staying in
                    # the GC'd DRAM heap
                    logger.warning("DIRECT tier: %s; staging the arrays "
                                   "through memory-mapped files", e)
                    return MmapFeatureSet(fs.features, fs.labels,
                                          fs.weights,
                                          dir=kw.get("arena_path"))
        if mt == "DRAM" and isinstance(fs, TransformedFeatureSet):
            # DRAM tier = memoize the transformed batches (reference keeps
            # the post-transform MiniBatches resident; raw tiers already
            # live in host RAM here, so only transforms benefit)
            fs.cache(int(kw.get("cache_bytes", DEFAULT_DRAM_CACHE_BYTES)))
        return fs

    @staticmethod
    def disk(paths: Sequence[str], num_slice: int = 1) -> "DiskFeatureSet":
        return DiskFeatureSet(list(paths), num_slice=num_slice)

    @staticmethod
    def from_dataset(uri: str, columns: Optional[Sequence[str]] = None,
                     label_col: Optional[str] = None, num_slice: int = 1,
                     process_index: Optional[int] = None,
                     num_processes: Optional[int] = None
                     ) -> "FeatureSet":
        """Distributed ingestion over a partitioned dataset directory
        (parquet/arrow/npz/csv shards; ``file``/``hdfs``/``gs``/``s3``
        URIs): each host streams a disjoint, deterministic, size-balanced
        shard subset (see :mod:`feature.dataset`)."""
        from .dataset import ShardedDatasetFeatureSet
        return ShardedDatasetFeatureSet(
            uri, columns=columns, label_col=label_col, num_slice=num_slice,
            process_index=process_index, num_processes=num_processes)

    @staticmethod
    def files(paths: Sequence[str], num_slice: int = 1,
              columns: Optional[Sequence[str]] = None,
              label_col: Optional[str] = None,
              shard_per_host: bool = True) -> "ShardedFileFeatureSet":
        """Sharded npz/csv/parquet files, striped one stripe per host."""
        return ShardedFileFeatureSet(
            list(paths), num_slice=num_slice, columns=columns,
            label_col=label_col, shard_per_host=shard_per_host)


class ArrayFeatureSet(FeatureSet):
    """In-memory (host-RAM tier) dataset of numpy arrays."""

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


class DirectFeatureSet(ArrayFeatureSet):
    """Samples staged in the native host arena (off-GC, 64-byte aligned).

    The PMEM/DIRECT tier equivalent (``feature/pmem/NativeArray.scala`` +
    ``PersistentMemoryAllocator.java:19``): sample bytes live outside the
    Python heap in one contiguous slab, and batch slices are zero-copy
    numpy views into it. The library builds at first use
    (``utils/native_loader.py``); a failed build raises.
    """

    def __init__(self, features, labels=None, weights=None):
        from ..utils.native_loader import load_zoo_data

        lib = load_zoo_data()  # builds at first use, or raises
        feats = [np.asarray(f) for f in (
            features if isinstance(features, (list, tuple)) else [features])]
        labs = None
        if labels is not None:
            labs = [np.asarray(l) for l in (
                labels if isinstance(labels, (list, tuple)) else [labels])]
        def aligned(a):  # arena rounds every allocation up to 64 bytes
            return (a.nbytes + 63) & ~63

        total = sum(aligned(a) for a in feats) + \
            sum(aligned(a) for a in (labs or []))
        self._arena = lib.arena(max(total + 64, 4096))
        staged_feats = [self._arena.store(a).numpy() for a in feats]
        staged_labs = [self._arena.store(a).numpy() for a in labs] \
            if labs is not None else None
        super().__init__(staged_feats, staged_labs, weights)

    memory_type = "DIRECT"


class MmapFeatureSet(ArrayFeatureSet):
    """DIRECT-tier fallback when the native arena is full: arrays are
    staged to ``.npy`` files and reopened ``mmap_mode="r"``, so sample
    bytes live in the page cache (off the GC'd Python heap, shared
    across processes mapping the same staging dir) instead of silently
    staying DRAM-resident."""

    def __init__(self, features, labels=None, weights=None,
                 dir: Optional[str] = None):
        self.staging_dir = dir or tempfile.mkdtemp(prefix="zoo_mmap_")
        os.makedirs(self.staging_dir, exist_ok=True)

        def stage(tag, a):
            a = np.asarray(a)
            p = os.path.join(self.staging_dir, f"{tag}.npy")
            np.save(p, a)
            return np.load(p, mmap_mode="r")

        feats = [np.asarray(f) for f in (
            features if isinstance(features, (list, tuple)) else [features])]
        staged_feats = [stage(f"x{i}", a) for i, a in enumerate(feats)]
        staged_labs = None
        if labels is not None:
            labs = [np.asarray(l) for l in (
                labels if isinstance(labels, (list, tuple)) else [labels])]
            staged_labs = [stage(f"y{i}", a) for i, a in enumerate(labs)]
        super().__init__(staged_feats, staged_labs, weights)

    memory_type = "DIRECT"


class DiskFeatureSet(FeatureSet):
    """Sliced-epoch dataset over ``.npz`` shards.

    Parity: ``DiskFeatureSet`` / DISK_AND_DRAM(n) (FeatureSet.scala:332)
    — only ``num_slice`` shards are resident at a time; an epoch streams
    through all shards. Shards hold arrays ``x0..xK`` (features) and
    optional ``y0..yK`` (labels).
    """

    def __init__(self, paths: Sequence[str], num_slice: int = 1):
        self.paths = list(paths)
        self.num_slice = max(1, num_slice)
        self._size_cache: Optional[List[int]] = None

    def _load_shard(self, path: str) -> Dict[str, np.ndarray]:
        """path -> {'x0'..: features, 'y0'..: labels}; overridable for
        other on-disk formats (ShardedFileFeatureSet). Paths go through
        utils.file_io, so hdfs://-style URIs work once a filesystem is
        registered (Utils/File parity)."""
        from ..utils import file_io
        import io as _io

        with np.load(_io.BytesIO(file_io.read_bytes(path))) as z:
            return {k: z[k] for k in z.files}

    def _load_group(self, group) -> List[Dict[str, np.ndarray]]:
        """Load one resident slice's shards, concurrently when the shared
        worker resolver says the host has headroom (shard reads are
        IO-bound, so threads overlap them even under the GIL); order is
        preserved."""
        paths = [self.paths[int(pi)] for pi in group]
        if len(paths) <= 1:
            return [self._load_shard(p) for p in paths]
        from .host_pipeline import resolve_transform_workers
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, min(len(paths), resolve_transform_workers(None)))
        if workers == 1:
            return [self._load_shard(p) for p in paths]
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="zoo-shard") as pool:
            return list(pool.map(self._load_shard, paths))

    @property
    def _sizes(self) -> List[int]:
        if self._size_cache is None:
            self._size_cache = [self._load_shard(p)["x0"].shape[0]
                                for p in self.paths]
        return self._size_cache

    @staticmethod
    def write_shard(path: str, features, labels=None):
        """Helper to produce shard files in the expected layout."""
        feats = features if isinstance(features, (list, tuple)) \
            else [features]
        arrays = {f"x{i}": np.asarray(a) for i, a in enumerate(feats)}
        if labels is not None:
            labs = labels if isinstance(labels, (list, tuple)) else [labels]
            arrays.update({f"y{i}": np.asarray(a)
                           for i, a in enumerate(labs)})
        np.savez(path, **arrays)

    def size(self):
        return sum(self._sizes)

    def batches(self, batch_size, shuffle=False, drop_remainder=True,
                pad_remainder=False, seed=0):
        order = np.arange(len(self.paths))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        def numkey(k):
            return (k[0], int(k[1:]))

        carry: Optional[List[List[np.ndarray]]] = None  # [xs, ys]
        groups = [order[s:s + self.num_slice]
                  for s in range(0, len(order), self.num_slice)]
        sizes_seen: Dict[int, int] = {}
        for gi, group in enumerate(groups):
            feats_acc: Dict[str, List[np.ndarray]] = {}
            for pi, shard in zip(group, self._load_group(group)):
                sizes_seen[int(pi)] = int(shard["x0"].shape[0])
                for k, v in shard.items():
                    feats_acc.setdefault(k, []).append(v)
            if self._size_cache is None and \
                    len(sizes_seen) == len(self.paths):
                # size() after one epoch costs nothing: sizes were
                # collected while streaming (no second full read)
                self._size_cache = [sizes_seen[i]
                                    for i in range(len(self.paths))]
            merged = {k: np.concatenate(v) for k, v in feats_acc.items()}
            xs = [merged[k] for k in sorted(merged, key=numkey)
                  if k.startswith("x")]
            ys = [merged[k] for k in sorted(merged, key=numkey)
                  if k.startswith("y")]
            if carry is not None:  # remainder samples from the last group
                xs = [np.concatenate([c, a]) for c, a in zip(carry[0], xs)]
                if ys:
                    ys = [np.concatenate([c, a])
                          for c, a in zip(carry[1], ys)]
            last = gi == len(groups) - 1
            n = xs[0].shape[0]
            # keep the tail for the next group so drop_remainder only
            # applies once per epoch, matching a flat dataset's count
            keep = n if last else (n // batch_size) * batch_size
            carry = None if last else [[a[keep:] for a in xs],
                                       [a[keep:] for a in ys]]
            slice_fs = ArrayFeatureSet([a[:keep] for a in xs],
                                       [a[:keep] for a in ys] if ys
                                       else None)
            yield from slice_fs.batches(
                batch_size, shuffle=shuffle,
                drop_remainder=drop_remainder,
                pad_remainder=pad_remainder, seed=seed + gi)


class GeneratorFeatureSet(FeatureSet):
    def __init__(self, fn, size):
        self.fn = fn
        self._size = size

    def size(self):
        return self._size

    def batches(self, batch_size, shuffle=False, drop_remainder=True,
                pad_remainder=False, seed=0):
        buf_x, buf_y = [], []
        for item in self.fn():
            x, y = item if isinstance(item, tuple) and len(item) == 2 \
                else (item, None)
            buf_x.append(x)
            buf_y.append(y)
            if len(buf_x) == batch_size:
                yield _stack_batch(buf_x, buf_y, batch_size)
                buf_x, buf_y = [], []
        if buf_x and not drop_remainder:
            yield _stack_batch(buf_x, buf_y, batch_size if pad_remainder
                               else len(buf_x), pad=pad_remainder)


def stack_samples(samples: Sequence[Sample]):
    """Stack Samples into (features_tuple, labels); the single shared
    batching helper (used by FeatureSet.samples and SampleToMiniBatch)."""
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


def minibatch_len(batch: MiniBatch) -> int:
    return len(batch.weights) if batch.weights is not None else \
        len(batch.inputs[0])


def pad_minibatch(batch: MiniBatch, target: int) -> MiniBatch:
    """Pad a MiniBatch to ``target`` samples by repeating the last sample
    with zero weight. Loss/metrics are weight-aware so the padding does not
    bias them; note BatchNorm running stats are NOT weight-aware — training
    batch sizes should be a multiple of the data-parallel size to avoid
    padded samples entering normalization statistics."""
    n = minibatch_len(batch)
    if target <= n:
        return batch
    reps = target - n

    def pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], reps, 0)])

    xs = tuple(pad(x) for x in batch.inputs)
    ys = batch.targets
    if ys is not None:
        ys = [pad(y) for y in ys] if isinstance(ys, (list, tuple)) \
            else pad(ys)
    w = batch.weights if batch.weights is not None else \
        np.ones(n, np.float32)
    w = np.concatenate([np.asarray(w), np.zeros(reps, np.float32)])
    return MiniBatch(xs, ys, w)


def _stack_batch(buf_x, buf_y, batch_size, pad=False):
    n = len(buf_x)
    multi = isinstance(buf_x[0], (list, tuple))
    if multi:
        xs = tuple(np.stack([b[i] for b in buf_x])
                   for i in range(len(buf_x[0])))
    else:
        xs = (np.stack(buf_x),)
    ys = None
    if buf_y[0] is not None:
        ys = np.stack(buf_y)
    batch = MiniBatch(xs, ys, np.ones(n, np.float32))
    if pad and n < batch_size:
        batch = pad_minibatch(batch, batch_size)
    return batch


DEFAULT_DRAM_CACHE_BYTES = 2 << 30  # 2 GiB; FeatureSet.rdd cache_bytes kw


class TransformStats:
    """Thread-safe counters for host-side transform cost.

    One instance lives on each TransformedFeatureSet (``stats()``); the
    staged host pipeline reads the same counters for its telemetry, so
    "seconds spent transforming" is reported once no matter how many
    workers ran the Preprocessing chain.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.seconds = 0.0
        self.cache_hits = 0
        self.arena_hits = 0
        self.worker_busy: Dict[int, float] = {}
        self.worker_items: Dict[int, int] = {}

    def record(self, seconds: float, batches: int = 1):
        with self._lock:
            self.batches += batches
            self.seconds += seconds

    def record_hit(self, batches: int = 1):
        with self._lock:
            self.cache_hits += batches

    def record_arena_hit(self, batches: int = 1):
        with self._lock:
            self.arena_hits += batches
            self.cache_hits += batches

    def record_worker(self, wid: int, seconds: float, items: int = 1):
        """Per-worker busy time (process backend reports it from the
        worker side, so queue/hand-off overhead is excluded)."""
        with self._lock:
            self.worker_busy[wid] = self.worker_busy.get(wid, 0.0) + seconds
            self.worker_items[wid] = self.worker_items.get(wid, 0) + items

    def worker_busy_snapshot(self) -> Dict[int, float]:
        """Cumulative busy seconds per worker; the InfeedMonitor diffs
        snapshots across a logging window for utilization telemetry."""
        with self._lock:
            return dict(self.worker_busy)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"batches_transformed": self.batches,
                    "transform_seconds": round(self.seconds, 6),
                    "cache_hits": self.cache_hits,
                    "arena_hits": self.arena_hits,
                    "worker_items": dict(self.worker_items)}


def minibatch_nbytes(batch: MiniBatch) -> int:
    """Host-RAM footprint of a MiniBatch (cache-budget accounting)."""

    def add(x):
        if x is None:
            return 0
        if isinstance(x, (list, tuple)):
            return sum(add(v) for v in x)
        return np.asarray(x).nbytes

    return add(tuple(batch))


def default_arena_path() -> str:
    """Where the DIRECT arena lives when the caller doesn't say:
    ``ZOO_TPU_DIRECT_ARENA`` if set, else a per-user file in the temp
    dir — stable across processes of the same user, so pool workers and
    serving workers share one cache by default."""
    p = os.environ.get("ZOO_TPU_DIRECT_ARENA")
    if p:
        return p
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"zoo_tpu_{uid}.arena")


class DirectArena:
    """Disk-backed memory-mapped cache arena — the real DIRECT tier.

    The DRAM tier memoizes transformed batches in the Python heap; this
    arena is the next rung of the reference's memory-tier ladder
    (FeatureSet.scala DIRECT/PMEM): batches past ``cache_bytes`` spill
    to one append-only file that every process on the host can mmap, so
    N infeed/serving workers share ONE transformed copy of the dataset
    instead of N.

    On-disk format (all host-endian, numpy dtype strings):

    - ``<path>`` — array bytes back-to-back, each 64-byte aligned, in
      epoch order. Append-only; never rewritten in place.
    - ``<path>.index.json`` — the only source of truth for what's
      readable: per-signature batch metas (absolute offset, shape,
      dtype per array + the MiniBatch structure template) plus an LRU
      list. Committed atomically (tmp + rename) *after* the data file
      is flushed, so concurrent readers see complete epochs or nothing.
    - ``<path>.lock`` — single-writer lockfile (O_EXCL, pid inside;
      stale locks from dead writers are stolen). Readers never lock.

    Same signature machinery as the DRAM tier: a signature is the batch
    geometry ``(batch_size, drop_remainder, pad_remainder)`` plus a
    dataset fingerprint; LRU eviction applies when the byte budget is
    exceeded (logical: the entry leaves the index; file space is
    reclaimed when the arena empties and is truncated).
    """

    def __init__(self, path: str, budget_bytes: Optional[int] = None):
        self.path = path
        self.index_path = path + ".index.json"
        self.lock_path = path + ".lock"
        self.budget = int(budget_bytes) if budget_bytes else None
        self._mm: Optional[mmap_mod.mmap] = None
        self._mm_size = 0
        self._index_mtime: Optional[float] = None
        self._index: Dict[str, Any] = {"version": 1, "next_offset": 0,
                                       "signatures": {}, "lru": []}
        self._load_index(force=True)

    # ---- index ------------------------------------------------------
    def _load_index(self, force: bool = False):
        try:
            st = os.stat(self.index_path)
        except OSError:
            return
        if not force and st.st_mtime_ns == self._index_mtime:
            return
        try:
            with open(self.index_path) as f:
                self._index = json.load(f)
            self._index_mtime = st.st_mtime_ns
        except (OSError, ValueError):
            pass  # mid-rename race: keep the previous view

    def _store_index(self):
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.index_path)
        try:
            self._index_mtime = os.stat(self.index_path).st_mtime_ns
        except OSError:
            pass

    # ---- read path --------------------------------------------------
    def has(self, sig_key: str, fingerprint: str) -> bool:
        self._load_index()
        entry = self._index["signatures"].get(sig_key)
        return entry is not None and entry["fp"] == fingerprint

    def batch_metas(self, sig_key: str) -> List[Dict[str, Any]]:
        entry = self._index["signatures"][sig_key]
        if sig_key in self._index["lru"]:
            self._index["lru"].remove(sig_key)
            self._index["lru"].append(sig_key)
        return entry["batches"]

    def _mapping(self) -> mmap_mod.mmap:
        need = int(self._index["next_offset"])
        if self._mm is None or self._mm_size < need:
            # the old mapping (if any) stays alive under existing views;
            # new reads go through the re-mmap covering the grown file
            with open(self.path, "rb") as f:
                self._mm = mmap_mod.mmap(f.fileno(), need,
                                         access=mmap_mod.ACCESS_READ)
            self._mm_size = need
        return self._mm

    def read_batch(self, meta: Dict[str, Any]) -> MiniBatch:
        """Rebuild one batch as zero-copy views into the arena mapping
        (read-only; the page cache is the shared cross-process copy)."""
        from .infeed_worker import rebuild_batch

        mm = self._mapping()
        arrays = []
        for off, shape, dt in meta["a"]:
            shape = tuple(shape)
            count = int(np.prod(shape)) if shape else 1
            arrays.append(np.frombuffer(
                mm, dtype=np.dtype(dt), count=count,
                offset=int(off)).reshape(shape))
        return rebuild_batch(meta["t"], arrays)

    # ---- write path -------------------------------------------------
    def try_writer(self, sig_key: str,
                   fingerprint: str) -> Optional["_ArenaWriter"]:
        """Acquire the single-writer role, or None (another live process
        is writing — the caller streams uncached; its epoch commits)."""
        try:
            fd = os.open(self.lock_path,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                with open(self.lock_path) as f:
                    pid = int(f.read().strip() or 0)
                os.kill(pid, 0)  # raises when the writer is gone
                return None
            except (OSError, ValueError):
                try:  # stale lock from a dead writer: steal it
                    os.unlink(self.lock_path)
                except OSError:
                    pass
                try:
                    fd = os.open(self.lock_path,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                except FileExistsError:
                    return None
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        self._load_index()
        return _ArenaWriter(self, sig_key, fingerprint)

    def _release_lock(self):
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass

    def _evict_over_budget(self, incoming: int,
                           allow_truncate: bool = True):
        if self.budget is None:
            return
        sigs = self._index["signatures"]

        def live() -> int:
            return sum(e["bytes"] for e in sigs.values())

        while self._index["lru"] and live() + incoming > self.budget:
            victim = self._index["lru"].pop(0)
            e = sigs.pop(victim, None)
            if e is not None:
                logger.info(
                    "DIRECT arena: evicted signature %s (%.1f MiB)",
                    victim, e["bytes"] / 2**20)
        if not sigs and allow_truncate:
            # the arena emptied: reclaim the file space for real (never
            # mid-commit — the incoming epoch's bytes sit at the tail)
            self._index["next_offset"] = 0
            try:
                with open(self.path, "r+b") as f:
                    f.truncate(0)
            except OSError:
                pass


class _ArenaWriter:
    """One epoch's append session against the arena (lock held)."""

    def __init__(self, arena: DirectArena, sig_key: str, fingerprint: str):
        self.arena = arena
        self.sig_key = sig_key
        self.fingerprint = fingerprint
        self.start_offset = int(arena._index["next_offset"])
        self.offset = self.start_offset
        self.metas: List[Dict[str, Any]] = []
        self.nbytes = 0
        self.ok = True
        self._done = False
        self._f = open(arena.path, "ab")
        if self._f.tell() > self.offset:
            # uncommitted garbage from an aborted writer: overwrite it
            self._f.close()
            self._f = open(arena.path, "r+b")
            self._f.truncate(self.offset)
            self._f = open(arena.path, "ab")

    def append(self, batch: MiniBatch):
        """Spill one transformed batch; a batch the flattener can't take
        (non-ndarray leaves) voids the whole session — a partial epoch
        in the index would replay as the whole dataset."""
        from .infeed_worker import flatten_batch, slot_nbytes

        if not self.ok:
            return
        arrays, template = flatten_batch(batch)
        if arrays is None:
            self.ok = False
            logger.warning("DIRECT arena: batch not arena-cacheable; "
                           "signature %s will not spill", self.sig_key)
            return
        metas = []
        for a in arrays:
            pad = -self._f.tell() % 64
            if pad:
                self._f.write(b"\0" * pad)
            off = self._f.tell()
            self._f.write(a.tobytes())
            metas.append([off, list(a.shape), a.dtype.str])
        self.metas.append({"t": template, "a": metas})
        self.nbytes += slot_nbytes(arrays)

    def commit(self) -> Optional[List[Dict[str, Any]]]:
        """Flush data, then atomically publish the signature. Returns
        the batch metas (readable immediately), or None if voided."""
        if self._done:
            return None
        self._done = True
        try:
            if not self.ok:
                self._f.close()
                return None
            self._f.flush()
            os.fsync(self._f.fileno())
            end = self._f.tell()
            self._f.close()
            idx = self.arena._index
            idx["signatures"].pop(self.sig_key, None)
            if self.sig_key in idx["lru"]:
                idx["lru"].remove(self.sig_key)
            self.arena._evict_over_budget(self.nbytes,
                                          allow_truncate=False)
            idx["signatures"][self.sig_key] = {
                "fp": self.fingerprint, "bytes": self.nbytes,
                "batches": self.metas}
            idx["lru"].append(self.sig_key)
            idx["next_offset"] = max(int(idx["next_offset"]), end)
            self.arena._store_index()
            return self.metas
        finally:
            self.arena._release_lock()

    def abort(self):
        """Interrupted epoch: drop the appended bytes (truncate back) and
        publish nothing."""
        if self._done:
            return
        self._done = True
        try:
            self._f.close()
            with open(self.arena.path, "r+b") as f:
                f.truncate(self.start_offset)
        except OSError:
            pass
        finally:
            self.arena._release_lock()


class TransformedFeatureSet(FeatureSet):
    """Applies a Preprocessing chain per batch on the host, off the hot path
    when wrapped by the prefetcher.

    ``num_workers > 0`` runs the chain for several batches concurrently on
    an ordered thread pool (MTSampleToMiniBatch parity); ``cache()`` turns
    on the DRAM tier (``FeatureSet.rdd(..., memory_type="DRAM")`` parity):
    transformed batches are memoized on the first complete epoch under a
    byte budget and replayed — batch-granular reshuffle by the epoch seed —
    on later epochs, with LRU eviction across batch signatures.
    """

    def __init__(self, base: FeatureSet, preprocessing,
                 num_workers: int = 0):
        self.base = base
        self.preprocessing = preprocessing
        self.num_workers = num_workers
        self._stats = TransformStats()
        self._cache_budget = 0  # bytes; 0 = DRAM tier off
        self._cache: "OrderedDict[tuple, Tuple[list, int]]" = OrderedDict()
        self._cache_used = 0
        self._cache_disabled: set = set()  # signatures over budget alone
        self._arena: Optional[DirectArena] = None
        self._arena_metas: Dict[tuple, List[Dict[str, Any]]] = {}
        self._fp: Optional[str] = None

    def size(self):
        return self.base.size()

    def stats(self) -> TransformStats:
        return self._stats

    def cache(self, max_bytes: int = DEFAULT_DRAM_CACHE_BYTES,
              arena_path: Optional[str] = None,
              arena_bytes: Optional[int] = None
              ) -> "TransformedFeatureSet":
        """Enable the cache-tier ladder: transformed batches memoize in
        host RAM up to ``max_bytes`` (the DRAM tier). With
        ``arena_path`` the DIRECT tier opens beneath it: *every* batch
        of a cached signature also lands in the disk arena — the
        cross-process source of truth — and replay serves the hot
        prefix from RAM with the spill tail mmap'd from the arena, so
        datasets past ``max_bytes`` still replay with zero
        re-transforms (and other processes on the host read the same
        arena instead of re-transforming their own copy)."""
        self._cache_budget = int(max_bytes)
        if arena_path:
            self._arena = DirectArena(arena_path, budget_bytes=arena_bytes)
        return self

    def _fingerprint(self) -> str:
        """Cheap dataset identity for cross-process arena hits: dataset
        type/size/geometry + the Preprocessing chain's type. Two
        processes building the same pipeline agree; a changed dataset
        or chain misses and re-transforms."""
        if self._fp is not None:
            return self._fp
        parts = [type(self.base).__name__, str(self.base.size()),
                 type(self.preprocessing).__name__]
        base = self.base
        if isinstance(base, ArrayFeatureSet):
            for a in base.features:
                parts.append(f"x{a.shape}{a.dtype}")
            for a in (base.labels or []):
                parts.append(f"y{a.shape}{a.dtype}")
        if isinstance(base, DiskFeatureSet):
            parts.extend(os.path.basename(p) for p in base.paths)
        self._fp = hashlib.sha1(
            "|".join(parts).encode()).hexdigest()[:16]
        return self._fp

    def _apply_timed(self, batch: MiniBatch) -> MiniBatch:
        t0 = time.perf_counter()
        out = self.preprocessing(batch)
        self._stats.record(time.perf_counter() - t0)
        return out

    def _evict_for(self, incoming_bytes: int):
        while self._cache and \
                self._cache_used + incoming_bytes > self._cache_budget:
            sig, (_, nbytes) = self._cache.popitem(last=False)
            self._cache_used -= nbytes
            logger.info(
                "DRAM cache: evicted signature %s (%.1f MiB) to fit "
                "%.1f MiB", sig, nbytes / 2**20, incoming_bytes / 2**20)

    def batches(self, batch_size, shuffle=False, drop_remainder=True,
                pad_remainder=False, seed=0, num_workers=None,
                backend=None):
        sig = (batch_size, bool(drop_remainder), bool(pad_remainder))
        sig_key = f"{batch_size}:{int(sig[1])}:{int(sig[2])}"
        caching = bool(self._cache_budget) or self._arena is not None
        if caching and sig in self._cache:
            # replay: DRAM hot prefix, arena-mmap'd spill tail
            cached, _ = self._cache[sig]
            self._cache.move_to_end(sig)  # LRU touch
            metas = self._arena_metas.get(sig, [])
            order = np.arange(max(len(metas), len(cached)))
            if shuffle:
                # sample-level shuffle happened before the transform was
                # memoized; replay epochs reshuffle at batch granularity
                # with the fresh epoch seed (documented tradeoff)
                np.random.default_rng(seed).shuffle(order)
            for i in order:
                if i < len(cached):
                    self._stats.record_hit()
                    yield cached[i]
                else:
                    self._stats.record_arena_hit()
                    yield self._arena.read_batch(metas[i])
            return
        if caching and self._arena is not None \
                and sig not in self._cache_disabled \
                and self._arena.has(sig_key, self._fingerprint()):
            # replay from the arena alone: another process (or an
            # earlier incarnation of this one) transformed this
            # signature — zero re-transforms, shared page-cache bytes
            metas = self._arena.batch_metas(sig_key)
            order = np.arange(len(metas))
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
            for i in order:
                self._stats.record_arena_hit()
                yield self._arena.read_batch(metas[i])
            return
        base_it = self.base.batches(
            batch_size, shuffle=shuffle, drop_remainder=drop_remainder,
            pad_remainder=pad_remainder, seed=seed)
        workers = self.num_workers if num_workers is None else num_workers
        if workers and workers < 0:
            from .host_pipeline import resolve_transform_workers
            workers = resolve_transform_workers(workers)
        if workers and workers > 0:
            from .host_pipeline import (ParallelTransformIterator,
                                        ProcessTransformPool,
                                        resolve_infeed_backend)
            if resolve_infeed_backend(backend, self.preprocessing) \
                    == "process":
                # the chain itself is pickled to the workers, not
                # _apply_timed (TransformStats holds a threading.Lock);
                # workers report their transform seconds back instead
                it: Iterator[MiniBatch] = ProcessTransformPool(
                    base_it, self.preprocessing, num_workers=workers,
                    stats=self._stats)
            else:
                it = ParallelTransformIterator(
                    base_it, self._apply_timed, num_workers=workers)
        else:
            it = (self._apply_timed(b) for b in base_it)
        if not caching or sig in self._cache_disabled:
            yield from it
            return
        writer = None
        if self._arena is not None:
            writer = self._arena.try_writer(sig_key, self._fingerprint())
        acc: Optional[List[MiniBatch]] = []
        acc_bytes = 0
        dram_full = False
        complete = False
        try:
            for out in it:
                if writer is not None:
                    # every batch of the signature goes to the arena —
                    # disk is the cross-process truth; DRAM memoizes
                    # only the hot prefix under the byte budget
                    writer.append(out)
                if acc is not None and not dram_full:
                    nb = minibatch_nbytes(out)
                    if acc_bytes + nb > self._cache_budget:
                        if writer is not None and writer.ok:
                            dram_full = True  # tail spills to the arena
                        elif self._arena is not None:
                            # transient: the arena writer was busy (or
                            # this batch isn't arena-cacheable); retry
                            # the spill on the next epoch
                            acc = None
                        else:
                            logger.info(
                                "DRAM cache: signature %s exceeds budget "
                                "(%.1f MiB > %.1f MiB); caching disabled "
                                "for it", sig, (acc_bytes + nb) / 2**20,
                                self._cache_budget / 2**20)
                            self._cache_disabled.add(sig)
                            acc = None
                    else:
                        acc_bytes += nb
                        acc.append(out)
                yield out
            complete = acc is not None or \
                (writer is not None and writer.ok)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            if complete:
                # only full epochs commit: an early break or error must
                # not memoize a truncated epoch as the whole dataset
                metas = writer.commit() if writer is not None else None
                if metas is not None:
                    self._arena_metas[sig] = metas
                if acc is not None and (metas is not None
                                        or not dram_full):
                    # a DRAM prefix whose arena tail failed to commit
                    # must not memoize: it would replay as the dataset
                    self._evict_for(acc_bytes)
                    self._cache[sig] = (acc, acc_bytes)
                    self._cache_used += acc_bytes
            elif writer is not None:
                writer.abort()


class ShardedFileFeatureSet(DiskFeatureSet):
    """Sharded files -> per-host streaming infeed.

    The SURVEY's hardest data-layer problem ((a): Spark-partition ->
    infeed streaming without host OOM): the reference hides it inside
    JVM-local MiniBatch iterators over cached RDD partitions
    (NNEstimator.scala:382 getDataSet + FeatureSet memory tiers). Here
    file shards play the role of partitions: each HOST keeps only the
    shards striped to it (``paths[i]`` with ``i % num_processes ==
    process_index``), an epoch streams ``num_slice`` shards at a time
    through the DiskFeatureSet machinery, and the engine's
    ``make_array_from_process_local_data`` path assembles the global batch
    — so no host ever materializes the dataset. Without an explicit
    ``process_index``/``num_processes`` the stripe comes from
    :func:`process_topology`.

    Formats: ``.npz`` (DiskFeatureSet layout), ``.csv`` (a header row,
    read with the standard library as pandas' ``read_csv`` reads numeric
    columns) and ``.parquet`` (pyarrow, imported only for it);
    ``columns`` selects feature columns, ``label_col`` the label.
    """

    def __init__(self, paths: Sequence[str], num_slice: int = 1,
                 columns: Optional[Sequence[str]] = None,
                 label_col: Optional[str] = None,
                 shard_per_host: bool = True,
                 process_index: Optional[int] = None,
                 num_processes: Optional[int] = None):
        if shard_per_host:
            if process_index is None or num_processes is None:
                process_index, num_processes = process_topology()
            if num_processes > 1:
                paths = [p for i, p in enumerate(paths)
                         if i % num_processes == process_index]
                if not paths:
                    raise ValueError(
                        f"no shards for process {process_index}: provide "
                        f">= {num_processes} files (one per host)")
        super().__init__(paths, num_slice=num_slice)
        self.columns = list(columns) if columns else None
        self.label_col = label_col

    def _load_shard(self, path: str) -> Dict[str, np.ndarray]:
        lower = path.lower()
        if lower.endswith(".npz"):
            return super()._load_shard(path)
        from ..utils import file_io

        if lower.endswith(".parquet") or lower.endswith(".pq"):
            names, columns = _parquet_columns(file_io.read_bytes(path))
        elif lower.endswith(".csv"):
            names, columns = _csv_columns(file_io.read_bytes(path))
        else:
            raise ValueError(f"unsupported shard format: {path}")
        cols = self.columns or [c for c in names if c != self.label_col]
        missing = [c for c in cols if c not in columns]
        if missing:
            raise KeyError(f"columns {missing} not in {path} (has {names})")
        out = {"x0": np.stack([np.asarray(columns[c], np.float32)
                               for c in cols], axis=1)}
        if self.label_col is not None and self.label_col in columns:
            out["y0"] = columns[self.label_col]
        return out


def process_topology() -> Tuple[int, int]:
    """(process_index, num_processes) of this host: the ``zoo-launch``
    environment contract (``ZOO_TPU_PROCESS_ID`` /
    ``ZOO_TPU_NUM_PROCESSES``) when set, else the rank and world size of
    an initialised ``torch.distributed``, else (0, 1)."""
    pid = os.environ.get("ZOO_TPU_PROCESS_ID")
    nproc = os.environ.get("ZOO_TPU_NUM_PROCESSES")
    if pid is not None and nproc is not None:
        return int(pid), int(nproc)
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def import_pyarrow(module: str = "pyarrow"):
    """``module`` of pyarrow, imported only for the parquet, arrow and
    feather formats; where pyarrow is missing, an ``ImportError`` that
    names it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"parquet, arrow and feather shards need pyarrow, and "
            f"{module} cannot be imported ({e}); npz and csv shards do "
            f"not need it") from e


def _parquet_columns(data: bytes):
    """A parquet file's column names and numpy columns."""
    import io as _io

    pq = import_pyarrow("pyarrow.parquet")
    table = pq.read_table(_io.BytesIO(data))
    return table.column_names, {
        c: table.column(c).to_numpy(zero_copy_only=False)
        for c in table.column_names}


def _csv_value(s: str):
    s = s.strip()
    if not s:
        return math.nan
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _csv_columns(data: bytes):
    """A csv file's header names and numpy columns, typed as pandas'
    ``read_csv`` types them: all-integer columns int64, numeric columns
    with a decimal point or an empty field float64 (an empty field NaN),
    anything else object."""
    import csv
    import io as _io

    rows = [r for r in csv.reader(_io.StringIO(data.decode("utf-8"))) if r]
    if not rows:
        raise ValueError("csv shard without a header row")
    names, body = rows[0], rows[1:]
    columns = {}
    for j, name in enumerate(names):
        vals = [_csv_value(r[j]) if j < len(r) else math.nan for r in body]
        if all(type(v) is int for v in vals):
            columns[name] = np.asarray(vals, np.int64)
        elif all(type(v) in (int, float) for v in vals):
            columns[name] = np.asarray(vals, np.float64)
        else:
            columns[name] = np.asarray(vals, object)
    return names, columns


# Live pipeline-stage registry: every closeable infeed stage
# (PrefetchIterator, ParallelTransformIterator, DeviceStagingIterator)
# registers itself so launcher-driven shutdown (zoo-launch SIGTERM ->
# launcher.worker handler) can close them all — a killed worker must not
# hang in concurrent.futures' atexit join on still-busy transform-pool
# threads. WeakSet: normal close()/GC drops entries automatically.
_LIVE_PIPELINES: "weakref.WeakSet" = weakref.WeakSet()


def register_pipeline(obj) -> None:
    """Track a closeable pipeline stage for process-wide teardown."""
    _LIVE_PIPELINES.add(obj)


def shutdown_all_pipelines() -> int:
    """Close every live pipeline stage; returns how many were closed.

    Idempotent and safe mid-stream: each stage's ``close()`` already
    handles being called while a producer is running.
    """
    closed = 0
    for obj in list(_LIVE_PIPELINES):
        try:
            obj.close()
            closed += 1
        except Exception:  # noqa: BLE001 - teardown must not raise
            logger.warning("pipeline close failed during shutdown",
                           exc_info=True)
        _LIVE_PIPELINES.discard(obj)
    return closed


class PrefetchIterator:
    """Background-thread prefetch of host minibatches (double buffering the
    host side; the trainer's pinned staging overlaps the device side).
    Replaces the reference's PMEM/DRAM cache tiers + MTSampleToMiniBatch."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.done = object()
        self.error = None
        self._stopped = False
        register_pipeline(self)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for item in self.it:
                while not self._stopped:
                    try:
                        self.q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stopped:
                    return
        except BaseException as e:  # propagate to consumer
            self.error = e
        finally:
            while not self._stopped:
                try:
                    self.q.put(self.done, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self, timeout: float = 5.0):
        """Unblock and discard the producer (call when abandoning the
        iterator mid-stream, e.g. early end-trigger or step failure).

        Joins the worker (bounded wait) so a producer blocked in ``put``
        cannot re-insert items after the drain, then closes the upstream
        iterator — only once the worker is provably out of it (closing a
        generator mid-execution from another thread raises ValueError).
        """
        self._stopped = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout)
        try:  # drop anything re-inserted between drain and worker exit
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        upstream_close = getattr(self.it, "close", None)
        if upstream_close is not None and not self.thread.is_alive():
            upstream_close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stopped:
            raise StopIteration
        if self.error is not None:
            # surface producer failure immediately rather than after the
            # already-queued batches and the done sentinel drain out
            self._stopped = True
            err, self.error = self.error, None
            raise err
        item = self.q.get()
        if item is self.done:
            self._stopped = True
            if self.error is not None:
                err, self.error = self.error, None
                raise err
            raise StopIteration
        return item
