"""pyarrow.fs-backed remote filesystem handlers for :mod:`file_io`.

Counterpart of ``analytics_zoo_tpu/utils/arrow_fs.py``. Parity: the reference's IO is Hadoop-FS-aware end to end —
``common/Utils.scala`` ``saveBytes``/``readBytes`` work on ``file:``/
``hdfs:``/``s3:`` URIs (``zoo/src/main/scala/com/intel/analytics/zoo/
common/Utils.scala``). The rebuild's seam is
:func:`file_io.register_filesystem`; this module supplies the concrete
remote implementation over ``pyarrow.fs`` so checkpoints, FeatureSet
shards and model IO work off-box::

    from analytics_zoo_tpu_torch.utils.arrow_fs import (
        register_arrow_filesystem)
    register_arrow_filesystem("hdfs", host="namenode", port=8020)
    # or: register_arrow_filesystem("gs") / ("s3")
    trainer.save_checkpoint("hdfs://checkpoints/run1")

Any ``pyarrow.fs.FileSystem`` instance can be adapted (tests pass a
``LocalFileSystem`` under a mock scheme), and so can any object with
its methods: the adapter reads ``FileInfo.type`` by its value and builds
a ``FileSelector`` from pyarrow only where pyarrow is installed. Only
:func:`make_arrow_filesystem` needs pyarrow itself.
"""

from __future__ import annotations

import fnmatch
import io
import posixpath
from types import SimpleNamespace
from typing import List

from . import file_io

# pyarrow.fs.FileType's values
_NOT_FOUND, _FILE = 0, 2


def _selector(base_dir: str, recursive: bool):
    """A ``pyarrow.fs.FileSelector``, or an object with its fields when
    pyarrow is not installed."""
    try:
        from pyarrow.fs import FileSelector
    except ImportError:
        return SimpleNamespace(base_dir=base_dir, recursive=recursive,
                               allow_not_found=False)
    return FileSelector(base_dir, recursive=recursive)


class ArrowFileSystem(file_io.FileSystem):
    """Adapter: a ``pyarrow.fs.FileSystem`` behind the file_io interface."""

    def __init__(self, arrow_fs):
        self.fs = arrow_fs

    def open(self, path: str, mode: str = "rb"):
        binary = "b" in mode
        if "w" in mode:
            parent = posixpath.dirname(path)
            if parent:
                self.makedirs(parent)
            stream = self.fs.open_output_stream(path)
        elif "a" in mode:
            stream = self.fs.open_append_stream(path)
        else:
            stream = self.fs.open_input_file(path)
        if binary:
            return stream
        return io.TextIOWrapper(stream)

    def exists(self, path: str) -> bool:
        return int(self.fs.get_file_info([path])[0].type) != _NOT_FOUND

    def makedirs(self, path: str):
        self.fs.create_dir(path, recursive=True)

    def listdir(self, path: str) -> List[str]:
        infos = self.fs.get_file_info(_selector(path, recursive=False))
        return sorted(posixpath.basename(info.path) for info in infos)

    def glob(self, pattern: str) -> List[str]:
        """pyarrow has no native glob: list the deepest non-wild parent
        recursively and fnmatch (sufficient for the shard/checkpoint
        patterns the framework emits)."""
        parts = pattern.split("/")
        base_parts = []
        for part in parts:
            if any(c in part for c in "*?["):
                break
            base_parts.append(part)
        base = "/".join(base_parts) or "/"
        info = self.fs.get_file_info([base])[0]
        if int(info.type) == _NOT_FOUND:
            return []
        if int(info.type) == _FILE:
            return [base] if fnmatch.fnmatch(base, pattern) else []
        infos = self.fs.get_file_info(_selector(base, recursive=True))
        return sorted(i.path for i in infos
                      if fnmatch.fnmatch(i.path, pattern))

    def remove(self, path: str):
        self.fs.delete_file(path)

    def size(self, path: str) -> int:
        info = self.fs.get_file_info([path])[0]
        if int(info.type) == _NOT_FOUND:
            raise FileNotFoundError(path)
        return int(info.size or 0)

    def rename(self, src: str, dst: str):
        self.fs.move(src, dst)


def make_arrow_filesystem(scheme: str, **kwargs):
    """Construct the pyarrow filesystem for a scheme: ``hdfs`` (kwargs:
    host, port, user, ...), ``gs``/``gcs``, ``s3``."""
    from pyarrow import fs as pafs

    scheme = scheme.lower()
    if scheme == "hdfs":
        return pafs.HadoopFileSystem(**(kwargs or {"host": "default"}))
    if scheme in ("gs", "gcs"):
        return pafs.GcsFileSystem(**kwargs)
    if scheme == "s3":
        return pafs.S3FileSystem(**kwargs)
    raise ValueError(f"no pyarrow filesystem for scheme {scheme!r}")


def register_arrow_filesystem(scheme: str, arrow_fs=None,
                              **kwargs) -> ArrowFileSystem:
    """Adapt + register a pyarrow filesystem for ``scheme://`` URIs. With
    no ``arrow_fs``, one is constructed from the scheme (hdfs/gs/s3)."""
    if arrow_fs is None:
        arrow_fs = make_arrow_filesystem(scheme, **kwargs)
    adapted = ArrowFileSystem(arrow_fs)
    file_io.register_filesystem(scheme, adapted)
    return adapted
