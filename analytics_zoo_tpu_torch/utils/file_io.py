"""Scheme-dispatching file IO (Utils/File parity).

Counterpart of ``analytics_zoo_tpu/utils/file_io.py``, copied.

The reference routes all persistence through Hadoop-FS-aware helpers
(``common/Utils.scala`` / ``utils/File.scala``: the same ``saveBytes`` /
``readBytes`` works on ``file:``, ``hdfs:``, ``s3:`` URIs). TPU-native
equivalent: one registry of filesystem handlers keyed by URI scheme.
``file://`` / bare paths use the local filesystem; deployments register
their store (GCS via ``gcsfs``, HDFS via ``pyarrow.fs`` ...) with
:func:`register_filesystem` — this image has no egress, so no remote
handler ships enabled, but every consumer (checkpoints, FeatureSet shards,
model save/load) goes through this seam instead of ``open``.
"""

from __future__ import annotations

import glob as _glob
import os
import random
import time
import uuid
from typing import Callable, Dict, List, Tuple

from . import faults

_SCHEMES: Dict[str, "FileSystem"] = {}


class FileIORetryExhausted(OSError):
    """A transient-looking IO error persisted through every retry attempt.

    Carries the terminal cause as ``__cause__``; ``attempts`` records how
    many tries were made."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


# Errors that retrying cannot fix: wrong path, wrong permissions, wrong
# kind of node. Everything else OSError-shaped (remote-scheme timeouts,
# connection resets, injected TransientFault) is considered transient.
_PERMANENT_ERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                     NotADirectoryError, FileExistsError)


def _retry_attempts() -> int:
    return max(1, int(os.environ.get("ZOO_TPU_FILE_RETRIES", "4")))


def _retry_backoff_s() -> float:
    return float(os.environ.get("ZOO_TPU_FILE_RETRY_BACKOFF_S", "0.05"))


def _with_retries(op: Callable[[], "object"], what: str):
    """Run ``op`` with bounded retries + jittered exponential backoff on
    transient IO errors (remote schemes hiccup; local disks mostly don't,
    but the policy is uniform). Permanent errors propagate immediately;
    persistent transients surface as :class:`FileIORetryExhausted`."""
    attempts = _retry_attempts()
    base = _retry_backoff_s()
    last: Exception = None  # type: ignore[assignment]
    for attempt in range(1, attempts + 1):
        try:
            return op()
        except _PERMANENT_ERRORS:
            raise
        except OSError as exc:
            last = exc
            if attempt == attempts:
                break
            delay = min(2.0, base * (2 ** (attempt - 1)))
            time.sleep(delay * random.uniform(0.5, 1.0))
    raise FileIORetryExhausted(
        f"{what} still failing after {attempts} attempt(s): {last}",
        attempts) from last


class FileSystem:
    """Minimal filesystem interface; subclass + register for remote FS."""

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str):
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def glob(self, pattern: str) -> List[str]:
        raise NotImplementedError

    def remove(self, path: str):
        raise NotImplementedError

    def rename(self, src: str, dst: str):
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def remove_tree(self, path: str):
        """Remove a directory and its contents (one level by default —
        deep stores override)."""
        for name in self.listdir(path):
            self.remove(path.rstrip("/") + "/" + name)


class LocalFileSystem(FileSystem):
    def open(self, path: str, mode: str = "rb"):
        if "w" in mode or "a" in mode:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(pattern))

    def remove(self, path: str):
        os.remove(path)

    def rename(self, src: str, dst: str):
        os.replace(src, dst)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def remove_tree(self, path: str):
        import shutil
        shutil.rmtree(path)


def register_filesystem(scheme: str, fs: FileSystem):
    """Install a handler for ``scheme://`` URIs (hdfs, gs, s3 ...)."""
    _SCHEMES[scheme.lower()] = fs


def split_scheme(uri: str) -> Tuple[str, str]:
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme.lower(), rest
    return "file", uri


def get_filesystem(uri: str) -> Tuple[FileSystem, str]:
    scheme, rest = split_scheme(uri)
    if scheme == "file":
        return _SCHEMES["file"], rest
    fs = _SCHEMES.get(scheme)
    if fs is None:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(register one with utils.file_io.register_filesystem; "
            f"known: {sorted(_SCHEMES)})")
    return fs, rest


# module-level convenience (the Utils.File call surface)
def open_file(uri: str, mode: str = "rb"):
    fs, path = get_filesystem(uri)
    return fs.open(path, mode)


def exists(uri: str) -> bool:
    fs, path = get_filesystem(uri)
    return fs.exists(path)


def makedirs(uri: str):
    fs, path = get_filesystem(uri)
    fs.makedirs(path)


def glob(pattern: str) -> List[str]:
    fs, path = get_filesystem(pattern)
    scheme, _ = split_scheme(pattern)
    prefix = "" if scheme == "file" else f"{scheme}://"
    return [prefix + p for p in fs.glob(path)]


def rename(src: str, dst: str):
    """Atomic (where the backing store allows) replace of ``dst`` with
    ``src``; both must be on the same filesystem scheme."""
    fs, src_path = get_filesystem(src)
    fs2, dst_path = get_filesystem(dst)
    if fs is not fs2:
        raise ValueError(f"cross-scheme rename: {src} -> {dst}")
    fs.rename(src_path, dst_path)


def remove(uri: str):
    fs, path = get_filesystem(uri)
    fs.remove(path)


def listdir(uri: str) -> List[str]:
    fs, path = get_filesystem(uri)
    return fs.listdir(path)


def remove_tree(uri: str):
    """Remove a directory subtree (checkpoint retention pruning)."""
    fs, path = get_filesystem(uri)
    fs.remove_tree(path)


def file_size(uri: str) -> int:
    """Size in bytes (shard-balance hint for dataset ingestion)."""
    fs, path = get_filesystem(uri)
    return int(fs.size(path))


def read_bytes(uri: str) -> bytes:
    def _op() -> bytes:
        faults.check("file-io")
        with open_file(uri, "rb") as f:
            return f.read()

    return _with_retries(_op, f"read {uri}")


def write_bytes(uri: str, data: bytes):
    def _op():
        faults.check("file-io")
        with open_file(uri, "wb") as f:
            f.write(data)

    _with_retries(_op, f"write {uri}")


def write_bytes_atomic(uri: str, data: bytes):
    """Write to a same-directory temp file, then rename into place —
    readers never observe a partial file (the serving model-registry
    manifest, checkpoint manifests, and the ``latest`` pointer depend
    on this)."""
    fs, path = get_filesystem(uri)

    def _op():
        faults.check("file-io")
        tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            with fs.open(tmp, "wb") as f:
                f.write(data)
            fs.rename(tmp, path)
        except OSError:
            try:
                fs.remove(tmp)
            except OSError:
                pass
            raise

    _with_retries(_op, f"atomic write {uri}")


register_filesystem("file", LocalFileSystem())
