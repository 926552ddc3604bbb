"""Sharded (multi-process) checkpoint format: per-process shard files +
manifest.

Counterpart of ``analytics_zoo_tpu/utils/sharded_checkpoint.py``, in its
file format byte for byte in layout, so either package reads the other's
files:

* ``{name}[.{tag}].shard{p}.npz`` — written by process ``p``: the regions
  of the leaves it writes, plus a ``__meta__`` JSON entry mapping npz keys
  to (leaf index, global region); a ``.crc32c`` sidecar holds its
  checksum;
* ``{name}[.{tag}].manifest.json`` — written by process 0 after a
  barrier: leaf count, each leaf's global shape and dtype, the shard-file
  names and their checksums;
* ``sharded.commit`` — the tag of the one complete, mutually consistent
  params/state/optim/meta set, written last (atomic rename).

Every rank of the port holds the replicated state whole, so by default
process 0 writes every leaf and the other processes write empty shard
files (JAX's ``replica_id == 0`` rule for a fully replicated array);
``save_shards(pieces=...)`` writes a process's regions of a leaf split
across processes. Restore is layout-agnostic (*resharding load*): the
piece catalogs of all shard files are read, and each requested region is
assembled from whichever saved pieces overlap it — a whole leaf, or with
``regions`` any block of it — so a checkpoint written under one layout
loads under any other. A shard file missing, or pieces that do not cover
a region, raise.

All file IO routes through :mod:`utils.file_io`. Writes are atomic (tmp +
rename).
"""

from __future__ import annotations

import io
import json
import posixpath
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults, file_io
from .crc32c import crc32c

MANIFEST_SUFFIX = ".manifest.json"
CHECKSUM_SUFFIX = ".crc32c"


class ChecksumError(RuntimeError):
    """A checkpoint file's bytes do not match its recorded crc32c/size."""


def _join(directory: str, fname: str) -> str:
    scheme, rest = file_io.split_scheme(directory)
    joined = posixpath.join(rest, fname)
    return joined if scheme == "file" else f"{scheme}://{joined}"


def _norm_index(index, shape) -> List[Tuple[int, int]]:
    """A shard's ``index`` (tuple of slices) -> [(start, stop)] per dim."""
    out = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError(f"strided shard index unsupported: {sl}")
        out.append((start, stop))
    return out


def process_topology() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _leaf_pieces(leaf, process_index: int
                 ) -> List[Tuple[List[Tuple[int, int]], np.ndarray]]:
    """The (region, data) pieces a process writes for one whole leaf:
    every rank holds the replicated leaf, and exactly one writes it
    (process 0), as JAX's ``replica_id == 0`` rule gives for a fully
    replicated array."""
    if process_index != 0:
        return []
    arr = np.asarray(leaf)
    return [([(0, d) for d in arr.shape], arr)]


def _shard_fname(name: str, tag: Optional[str], proc: int) -> str:
    return (f"{name}.shard{proc}.npz" if tag is None
            else f"{name}.{tag}.shard{proc}.npz")


def _manifest_name(name: str, tag: Optional[str]) -> str:
    return (name + MANIFEST_SUFFIX if tag is None
            else f"{name}.{tag}{MANIFEST_SUFFIX}")


COMMIT_FILE = "sharded.commit"


def write_commit(directory: str, tag: str) -> None:
    """The cross-group commit point: a multi-group checkpoint (params +
    state + optim + meta) is valid only once this file names its tag.
    Written LAST (atomic rename) — a crash between the per-group manifest
    writes leaves the previous commit pointing at the previous tag's
    complete, mutually-consistent file set, never a new-params/old-optim
    mix."""
    tmp = _join(directory, COMMIT_FILE + ".tmp")
    with file_io.open_file(tmp, "wb") as f:
        f.write(tag.encode())
    file_io.rename(tmp, _join(directory, COMMIT_FILE))


def read_commit(directory: str) -> Optional[str]:
    uri = _join(directory, COMMIT_FILE)
    if not file_io.exists(uri):
        return None
    with file_io.open_file(uri, "rb") as f:
        return f.read().decode().strip() or None


def gc_stale(directory: str, names: Sequence[str],
             keep_tag: Optional[str]) -> None:
    """Best-effort removal of shard/manifest files from tags other than
    ``keep_tag`` (call AFTER write_commit). A reader racing the GC with
    the old commit fails loudly (FileNotFoundError), never silently."""
    try:
        entries = file_io.listdir(directory)
    except OSError:
        return
    keep = set()
    for name in names:
        keep.add(_manifest_name(name, keep_tag))
        keep.update(f for f in entries
                    if f.startswith(f"{name}.{keep_tag}.shard")
                    or (keep_tag is None and
                        f.startswith(f"{name}.shard")))
    for fname in entries:
        base = fname[:-len(CHECKSUM_SUFFIX)] \
            if fname.endswith(CHECKSUM_SUFFIX) else fname
        stale_shard = any(
            base.startswith(f"{name}.") and ".shard" in base and
            base.endswith(".npz") for name in names)
        stale_manifest = any(
            base.startswith(f"{name}.") and
            base.endswith(MANIFEST_SUFFIX) for name in names)
        if (stale_shard or stale_manifest) and base not in keep:
            try:
                file_io.remove(_join(directory, fname))
            except OSError:
                pass


def save_shards(directory: str, name: str, leaves: Sequence[Any],
                tag: Optional[str] = None,
                process_index: Optional[int] = None,
                pieces: Optional[Sequence[Tuple[int, Any, Any]]] = None
                ) -> None:
    """Write this process's shard file for ``leaves`` (atomic). Call on
    EVERY process, then :func:`write_manifest` on process 0 after a
    barrier. Pass a per-save ``tag`` (e.g. the step) when overwriting a
    checkpoint in place: tagged saves write NEW files, so a crash mid-save
    leaves the previous manifest pointing at its own complete file set
    instead of a silent old/new mix.

    By default process 0 writes every leaf whole (replicated state) and
    the others write an empty file. ``pieces`` — (leaf index, region
    ``[(start, stop), ...]``, data) triples — writes those regions
    instead: a process's part of a leaf split across processes.
    ``process_index`` defaults to the ``torch.distributed`` rank."""
    proc = process_topology()[0] if process_index is None \
        else int(process_index)
    if pieces is None:
        pieces = [(li, region, data) for li, leaf in enumerate(leaves)
                  for region, data in _leaf_pieces(leaf, proc)]
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Dict[str, Any]] = {}
    counts: Dict[int, int] = {}
    for li, region, data in pieces:
        pi = counts.get(li, 0)
        counts[li] = pi + 1
        key = f"l{li}p{pi}"
        arrays[key] = np.asarray(data)
        meta[key] = {"leaf": int(li),
                     "region": [[int(a), int(b)] for a, b in region]}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    data = buf.getvalue()
    fname = _shard_fname(name, tag, proc)
    tmp = _join(directory, fname + ".tmp")
    file_io.makedirs(directory)
    faults.checked_write(tmp, data, file_io.write_bytes)
    file_io.rename(tmp, _join(directory, fname))
    # per-shard checksum sidecar: each writer records its own file's
    # crc32c so process 0's manifest can embed checksums for ALL shard
    # files (it never sees the other processes' bytes) — the barrier
    # before write_manifest guarantees sidecars exist by then
    file_io.write_bytes_atomic(
        _join(directory, fname + CHECKSUM_SUFFIX),
        json.dumps({"crc32c": crc32c(data), "size": len(data)}).encode())


def write_manifest(directory: str, name: str, leaves: Sequence[Any],
                   n_shard_files: Optional[int] = None,
                   tag: Optional[str] = None) -> None:
    """Process 0 writes the group manifest after all its shard files
    exist. With a ``tag``, the manifest is tag-scoped and the checkpoint
    only becomes visible at :func:`write_commit`; untagged manifests are
    self-commiting (single-group module users)."""
    if process_topology()[0] != 0:
        return
    n_files = n_shard_files if n_shard_files is not None \
        else process_topology()[1]
    shard_files = [_shard_fname(name, tag, p) for p in range(n_files)]
    checksums = {}
    for fname in shard_files:
        sidecar = _join(directory, fname + CHECKSUM_SUFFIX)
        try:
            checksums[fname] = json.loads(file_io.read_bytes(sidecar))
        except (OSError, ValueError):
            pass  # pre-checksum writer or lost sidecar: loads unvalidated
    manifest = {
        "n_leaves": len(leaves),
        "leaves": [{"shape": list(np.shape(leaf)),
                    "dtype": np.dtype(
                        getattr(leaf, "dtype", np.float32)).name}
                   for leaf in leaves],
        "shard_files": shard_files,
        "checksums": checksums,
    }
    fname = _manifest_name(name, tag)
    tmp = _join(directory, fname + ".tmp")
    with file_io.open_file(tmp, "wb") as f:
        f.write(json.dumps(manifest).encode())
    file_io.rename(tmp, _join(directory, fname))


def exists(directory: str, name: str, tag: Optional[str] = None) -> bool:
    return file_io.exists(_join(directory, _manifest_name(name, tag)))


def _validate_bytes(uri: str, data: bytes,
                    expected: Optional[Dict[str, Any]]) -> None:
    if expected is None:
        return
    if len(data) != int(expected.get("size", len(data))) \
            or crc32c(data) != int(expected["crc32c"]):
        raise ChecksumError(
            f"checksum mismatch for {uri}: file is corrupt "
            f"(expected crc32c={expected['crc32c']} "
            f"size={expected.get('size')}, got crc32c={crc32c(data)} "
            f"size={len(data)})")


class _PieceCatalog:
    """Lazy view over all shard files: which saved regions cover each leaf,
    reading piece data on demand (NpzFile reads members lazily)."""

    def __init__(self, directory: str, manifest: Dict[str, Any]):
        self.manifest = manifest
        self.by_leaf: Dict[int, List[Tuple[List[Tuple[int, int]],
                                           Dict[str, Any], str]]] = {}
        self._files = []
        checksums = manifest.get("checksums", {})
        for fname in manifest["shard_files"]:
            uri = _join(directory, fname)
            if not file_io.exists(uri):
                raise FileNotFoundError(
                    f"sharded checkpoint incomplete: missing {uri}")
            scheme, local = file_io.split_scheme(uri)
            expected = checksums.get(fname)
            if scheme == "file":
                # NpzFile reads zip members lazily: each process touches
                # only the bytes of the pieces overlapping ITS regions,
                # not the whole checkpoint — checksum validation is
                # deferred to the first piece actually read from the file
                npz = np.load(local, allow_pickle=False)
                validated = expected is None
            else:
                # non-seekable remote streams: buffer through memory —
                # the bytes are in hand, so validate eagerly
                raw = file_io.read_bytes(uri)
                _validate_bytes(uri, raw, expected)
                npz = np.load(io.BytesIO(raw), allow_pickle=False)
                validated = True
            entry = {"npz": npz, "uri": uri, "expected": expected,
                     "validated": validated}
            self._files.append(entry)
            meta = json.loads(bytes(npz["__meta__"]).decode())
            for key, info in meta.items():
                self.by_leaf.setdefault(info["leaf"], []).append(
                    ([(int(a), int(b)) for a, b in info["region"]],
                     entry, key))

    @staticmethod
    def _checked(entry: Dict[str, Any]):
        """First touch of a lazily-opened shard file: verify its bytes
        against the manifest checksum before trusting any member."""
        if not entry["validated"]:
            _validate_bytes(entry["uri"], file_io.read_bytes(entry["uri"]),
                            entry["expected"])
            entry["validated"] = True
        return entry["npz"]

    def read_region(self, leaf_i: int, index, shape, dtype) -> np.ndarray:
        """Assemble the requested region of leaf ``leaf_i`` from whatever
        saved pieces overlap it (the resharding core)."""
        region = _norm_index(index, shape) if shape else []
        out_shape = [stop - start for start, stop in region]
        out = np.empty(out_shape, dtype)
        covered = 0
        for piece_region, entry, key in self.by_leaf.get(leaf_i, ()):
            inter = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                     in zip(region, piece_region)]
            if any(start >= stop for start, stop in inter):
                continue
            data = self._checked(entry)[key]
            src = tuple(slice(start - p0, stop - p0) for (start, stop),
                        (p0, _) in zip(inter, piece_region))
            dst = tuple(slice(start - r0, stop - r0) for (start, stop),
                        (r0, _) in zip(inter, region))
            out[dst] = data[src]
            covered += int(np.prod([stop - start for start, stop in inter]))
        if not region:    # scalar leaf
            pieces = self.by_leaf.get(leaf_i, ())
            if not pieces:
                raise ValueError(f"leaf {leaf_i}: no saved pieces")
            return np.asarray(self._checked(pieces[0][1])[pieces[0][2]],
                              dtype)
        if covered != int(np.prod(out_shape)):
            raise ValueError(
                f"leaf {leaf_i}: saved pieces cover {covered} of "
                f"{int(np.prod(out_shape))} elements of region {region} — "
                f"checkpoint incomplete or corrupt")
        return out


def _slices(region) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in region)


def load_shards(directory: str, name: str,
                dtypes: Optional[Sequence[Any]] = None,
                tag: Optional[str] = None,
                regions: Optional[Sequence[Any]] = None
                ) -> List[np.ndarray]:
    """Load a sharded checkpoint's leaves as numpy arrays: leaf ``i``
    whole, or with ``regions[i]`` (a tuple of slices, None for the whole
    leaf) that block of it. The saved layout need not match: each region
    is assembled from the saved pieces that overlap it, and a region they
    do not cover raises."""
    with file_io.open_file(_join(directory, _manifest_name(name, tag)),
                           "rb") as f:
        manifest = json.loads(f.read().decode())
    n = manifest["n_leaves"]
    if regions is not None and len(regions) != n:
        raise ValueError(f"checkpoint has {n} leaves, caller expects "
                         f"{len(regions)}")
    if dtypes is not None and len(dtypes) != n:
        raise ValueError(f"checkpoint has {n} leaves, caller expects "
                         f"{len(dtypes)}")
    catalog = _PieceCatalog(directory, manifest)
    out = []
    for li, info in enumerate(manifest["leaves"]):
        shape = tuple(info["shape"])
        dtype = np.dtype(dtypes[li]) if dtypes is not None \
            else np.dtype(info["dtype"])
        index = regions[li] if regions is not None and \
            regions[li] is not None else tuple(slice(0, d) for d in shape)
        out.append(catalog.read_region(li, index, shape, dtype))
    return out


def load_regions(directory: str, name: str,
                 wanted: Sequence[Optional[Sequence[Sequence[Tuple[int,
                                                                   int]]]]],
                 dtypes: Optional[Sequence[Any]] = None,
                 tag: Optional[str] = None,
                 shapes: Optional[Sequence[Tuple[int, ...]]] = None
                 ) -> List[List[np.ndarray]]:
    """Load regions of a sharded checkpoint's leaves: ``wanted[i]`` is a
    list of regions (``[(start, stop), ...]`` a dimension) of leaf ``i``,
    or None for the whole leaf; returns a list of arrays a leaf, one a
    region. Each region is assembled from the saved pieces that overlap
    it, whatever layout wrote them (a rank reads its blocks, never the
    whole leaf). With ``shapes`` the leaves' whole shapes are checked
    against the manifest's first."""
    with file_io.open_file(_join(directory, _manifest_name(name, tag)),
                           "rb") as f:
        manifest = json.loads(f.read().decode())
    n = manifest["n_leaves"]
    if len(wanted) != n:
        raise ValueError(f"checkpoint has {n} leaves, caller expects "
                         f"{len(wanted)}")
    if shapes is not None:
        for i, (info, shape) in enumerate(zip(manifest["leaves"], shapes)):
            if tuple(info["shape"]) != tuple(shape):
                raise ValueError(f"leaf {i}: the checkpoint holds shape "
                                 f"{tuple(info['shape'])}, expected "
                                 f"{tuple(shape)}")
    catalog = _PieceCatalog(directory, manifest)
    out = []
    for li, info in enumerate(manifest["leaves"]):
        shape = tuple(info["shape"])
        dtype = np.dtype(dtypes[li]) if dtypes is not None \
            else np.dtype(info["dtype"])
        regions = wanted[li] if wanted[li] is not None else \
            [[(0, d) for d in shape]]
        out.append([catalog.read_region(li, _slices(region), shape, dtype)
                    for region in regions])
    return out


__all__ = ["COMMIT_FILE", "ChecksumError", "exists", "gc_stale",
           "load_regions", "load_shards", "process_topology", "read_commit", "save_shards",
           "write_commit", "write_manifest"]
