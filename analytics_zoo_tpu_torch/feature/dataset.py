"""Distributed dataset ingestion: a partitioned parquet/arrow directory
becomes a per-host disjoint shard stream.

Counterpart of ``analytics_zoo_tpu/feature/dataset.py``, copied: the same
discovery, the same size-balanced assignment and the same column layout.
``pyarrow`` is imported only for parquet, arrow and feather shards
(``feature_set.import_pyarrow``: a missing pyarrow raises an
``ImportError`` that names it); npz and csv shards need none. The host's
place without an explicit one is ``feature_set.process_topology``: the
``zoo-launch`` environment, then an initialised ``torch.distributed``.

Reference analogue: ``NNEstimator.scala:382-414`` turns a Spark DataFrame
into a cached, partitioned FeatureSet whose MiniBatch iterators are
executor-local (``FeatureSet.scala:423-455``) — shard locality is the
platform seam that makes "point the estimator at a cluster-sized table"
work.  Here the "table" is a directory of shard files (the layout
every Spark/Beam/Ray job already writes), discovered through
:mod:`utils.file_io` — so ``file:``/``hdfs:``/``gs:``/``s3:`` URIs all
work once a filesystem is registered with ``file_io`` — and
each host reads a **disjoint, deterministic, size-balanced** subset of the
shards derived from ``(process_id, num_processes)``.  Record batches then
stream through the existing staged host pipeline (transform pool -> DRAM
cache tier -> device-ahead staging) with epoch reshuffle at shard
granularity and the InfeedWait/InputBound telemetry intact.

Entry points::

    fs = FeatureSet.from_dataset("hdfs://warehouse/clicks", label_col="y")

Under ``zoo-launch --hosts N`` every process computes the same assignment
from the same sorted listing, so no coordination is needed to agree on
who reads what.
"""

from __future__ import annotations

import heapq
import logging
import posixpath
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..utils import file_io
from .feature_set import (ShardedFileFeatureSet, import_pyarrow,
                          process_topology)

logger = logging.getLogger("analytics_zoo_tpu_torch.feature")

#: shard file extensions recognized during directory discovery, in the
#: order the reference ecosystem emits them (Spark parquet part files,
#: arrow/feather IPC, the rebuild's own npz spill shards, csv exports)
SHARD_EXTENSIONS = (".parquet", ".pq", ".arrow", ".feather", ".npz", ".csv")


class DatasetShard(NamedTuple):
    """One discovered shard file: URI + size in bytes (0 if unknown)."""

    path: str
    size: int


def discover_shards(uri: str,
                    extensions: Sequence[str] = SHARD_EXTENSIONS
                    ) -> List[DatasetShard]:
    """List the shard files of a dataset URI, sorted by name.

    ``uri`` may be a single shard file or a directory of them.  Hidden
    entries and Spark/Hadoop markers (``_SUCCESS``, ``.crc``, anything
    ``_``/``.``-prefixed) are skipped.  The listing is sorted so every
    host that can see the same store derives the same shard order — the
    precondition for coordination-free assignment.
    """
    uri = uri.rstrip("/")
    if not file_io.exists(uri):
        raise FileNotFoundError(f"dataset uri does not exist: {uri}")
    lower = uri.lower()
    if any(lower.endswith(ext) for ext in extensions):
        return [DatasetShard(uri, file_size(uri))]
    names = [n for n in file_io.listdir(uri)
             if not n.startswith(("_", "."))
             and any(n.lower().endswith(ext) for ext in extensions)]
    shards = [DatasetShard(f"{uri}/{n}", 0) for n in sorted(names)]
    if not shards:
        raise ValueError(
            f"no dataset shards under {uri!r}: expected files with one of "
            f"{list(extensions)} (Spark-style partitioned directory or a "
            f"single shard file)")
    return [DatasetShard(s.path, file_size(s.path)) for s in shards]


def file_size(uri: str) -> int:
    """Size in bytes through the file_io seam; 0 when the backing
    filesystem cannot answer (assignment then falls back to counts)."""
    try:
        return file_io.file_size(uri)
    except Exception:  # noqa: BLE001 - size is a balance hint only
        return 0


def assign_shards(sizes: Sequence[int],
                  num_processes: int) -> List[List[int]]:
    """Deterministic, disjoint, size-balanced shard assignment.

    Greedy LPT: visit shards largest-first (ties broken by index) and
    give each to the currently lightest-loaded host (ties broken by
    host id).  Guarantees:

    - **disjoint + covering**: every shard index appears in exactly one
      host's list;
    - **deterministic**: a pure function of ``(sizes, num_processes)`` —
      every host computes the same answer with no coordination;
    - **balanced within one shard**: max and min host loads differ by at
      most the largest single shard (with equal sizes, shard *counts*
      differ by at most one).

    Unknown sizes (0) are treated as equal so assignment degrades to
    balanced round-robin counts.  ``n_shards < num_processes`` leaves the
    surplus hosts with empty lists — callers decide whether that is an
    error (a training host with nothing to feed must not silently sit in
    a collective).
    """
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    sizes = [int(s) for s in sizes]
    if any(s < 0 for s in sizes):
        raise ValueError("negative shard size")
    if sizes and all(s == 0 for s in sizes):
        sizes = [1] * len(sizes)
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    # heap of (load, shards_held, host) — shards_held keeps equal-size
    # datasets round-robin instead of piling early shards on host 0
    heap = [(0, 0, p) for p in range(num_processes)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(num_processes)]
    for i in order:
        load, held, p = heapq.heappop(heap)
        assignment[p].append(i)
        heapq.heappush(heap, (load + max(sizes[i], 1), held + 1, p))
    # each host streams its shards in listing order (epoch reshuffle is a
    # seeded permutation on top, identical across runs with the same seed)
    return [sorted(a) for a in assignment]


class ShardedDatasetFeatureSet(ShardedFileFeatureSet):
    """A partitioned dataset directory streamed with per-host shard sets.

    Builds on :class:`ShardedFileFeatureSet` (per-shard streaming, epoch
    reshuffle at shard granularity, ``num_slice`` residency bound) but
    replaces the modulo stripe with the size-balanced
    :func:`assign_shards` plan over a *discovered* listing, and adds
    arrow IPC (`.arrow`/`.feather`) plus list-column parquet support.

    ``columns``/``label_col`` select features/label; by default every
    non-label column is a feature.  Scalar numeric columns are packed
    into one ``(n, k)`` float32 matrix; a list/tensor-valued column
    becomes its own feature tensor (stacked along the batch dim).
    """

    def __init__(self, uri: str,
                 columns: Optional[Sequence[str]] = None,
                 label_col: Optional[str] = None,
                 num_slice: int = 1,
                 process_index: Optional[int] = None,
                 num_processes: Optional[int] = None):
        shards = discover_shards(uri)
        if process_index is None or num_processes is None:
            process_index, num_processes = process_topology()
        if not 0 <= process_index < num_processes:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"num_processes {num_processes}")
        plan = assign_shards([s.size for s in shards], num_processes)
        mine = plan[process_index]
        if not mine:
            raise ValueError(
                f"no shards for process {process_index}/{num_processes}: "
                f"dataset {uri!r} has only {len(shards)} shard(s); "
                f"repartition it into >= {num_processes} files (one per "
                f"host) or launch fewer hosts")
        super().__init__([shards[i].path for i in mine],
                         num_slice=num_slice, columns=columns,
                         label_col=label_col, shard_per_host=False)
        self.uri = uri
        self.process_index = process_index
        self.num_processes = num_processes
        self.all_shards = shards
        self.local_shards = [posixpath.basename(shards[i].path)
                             for i in mine]
        local_bytes = sum(shards[i].size for i in mine)
        logger.info(
            "dataset %s: process %d/%d assigned %d/%d shards (%s; %.1f MB "
            "of %.1f MB)", uri, process_index, num_processes, len(mine),
            len(shards), ",".join(self.local_shards), local_bytes / 1e6,
            sum(s.size for s in shards) / 1e6)

    def _load_shard(self, path: str) -> Dict[str, np.ndarray]:
        lower = path.lower()
        if lower.endswith((".parquet", ".pq")):
            import io as _io

            pq = import_pyarrow("pyarrow.parquet")
            table = pq.read_table(_io.BytesIO(file_io.read_bytes(path)))
            return self._table_to_arrays(table)
        if lower.endswith((".arrow", ".feather")):
            import io as _io

            pa = import_pyarrow("pyarrow")
            buf = _io.BytesIO(file_io.read_bytes(path))
            try:
                table = import_pyarrow("pyarrow.ipc").open_file(
                    buf).read_all()
            except pa.ArrowInvalid:
                buf.seek(0)  # stream-format IPC (and feather v1) fallback
                table = import_pyarrow("pyarrow.feather").read_table(buf)
            return self._table_to_arrays(table)
        return super()._load_shard(path)  # npz / csv

    def _table_to_arrays(self, table) -> Dict[str, np.ndarray]:
        """pyarrow Table -> the DiskFeatureSet ``{'x0'.., 'y0'}`` layout.

        Scalar numeric columns merge (in schema order) into one float32
        matrix; list-valued columns each become a stacked tensor of their
        own so image/sequence features survive ingestion.
        """
        cols = list(self.columns) if self.columns else \
            [c for c in table.column_names if c != self.label_col]
        missing = [c for c in cols if c not in table.column_names]
        if missing:
            raise ValueError(
                f"columns {missing} not in dataset (has "
                f"{table.column_names})")
        scalars: List[np.ndarray] = []
        tensors: List[np.ndarray] = []
        for c in cols:
            a = table.column(c).to_numpy(zero_copy_only=False)
            if a.dtype == object:  # list<...> column: per-row tensors
                tensors.append(np.stack(
                    [np.asarray(v, np.float32) for v in a]))
            else:
                scalars.append(np.asarray(a, np.float32))
        xs: List[np.ndarray] = []
        if scalars:
            xs.append(scalars[0][:, None] if len(scalars) == 1
                      else np.stack(scalars, axis=1))
        xs.extend(tensors)
        if not xs:
            raise ValueError(f"no feature columns selected from {cols}")
        out = {f"x{i}": a for i, a in enumerate(xs)}
        if self.label_col is not None and \
                self.label_col in table.column_names:
            y = table.column(self.label_col).to_numpy(zero_copy_only=False)
            if y.dtype == object:
                y = np.stack([np.asarray(v, np.float32) for v in y])
            out["y0"] = y
        return out


def write_parquet_shards(uri: str, features: np.ndarray,
                         labels: Optional[np.ndarray] = None,
                         num_shards: int = 8,
                         feature_prefix: str = "f",
                         label_col: str = "label") -> List[str]:
    """Write ``(features, labels)`` as a partitioned parquet directory —
    the fixture-side helper for smokes/tests and the inverse of
    :func:`discover_shards` (scalar feature columns ``f0..fK``)."""
    pa = import_pyarrow("pyarrow")
    pq = import_pyarrow("pyarrow.parquet")
    features = np.asarray(features)
    if features.ndim == 1:
        features = features[:, None]
    n = features.shape[0]
    file_io.makedirs(uri)
    bounds = np.linspace(0, n, num_shards + 1).astype(int)
    paths = []
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        cols = {f"{feature_prefix}{j}": features[lo:hi, j]
                for j in range(features.shape[1])}
        if labels is not None:
            cols[label_col] = np.asarray(labels)[lo:hi]
        table = pa.table(cols)
        path = f"{uri.rstrip('/')}/part-{s:05d}.parquet"
        import io as _io

        buf = _io.BytesIO()
        pq.write_table(table, buf)
        file_io.write_bytes(path, buf.getvalue())
        paths.append(path)
    return paths
