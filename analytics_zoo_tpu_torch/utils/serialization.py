"""Pytree checkpoint IO in the JAX package's file format.

Counterpart of ``analytics_zoo_tpu/utils/serialization.py``. A tree is
nested dicts, lists and tuples whose leaves are tensors, numpy arrays or
Python numbers (JAX pytrees there). The bytes are the JAX package's: an
``.npz`` holding each leaf under ``arr::<path>`` (the dict keys and
sequence indices from the root, joined by "/", dict keys sorted as
``jax.tree_util`` flattens them) plus a JSON skeleton of the structure
(the ``.treedef`` sidecar), so either package reads what the other
wrote. :func:`leaves_bytes` stores a bare leaf list as ``leaf<i>``: the
optimizer state, whose order ``utils/jax_weights.py`` fixes to optax's.

The ``.npz`` is written here by a zip writer with a fixed timestamp
(``numpy.savez`` stamps the current time), so the same tree gives the
same bytes and the same crc32c in every run; ``numpy.load`` reads it as
any ``.npz``.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor on any device is copied to
    the host)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: List[str], out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], prefix + [str(key)], out)
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            _flatten(val, prefix + [str(i)], out)
    elif tree is not None:
        out["/".join(prefix)] = tree


def _skel(x):
    if isinstance(x, dict):
        return {k: _skel(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return {"__seq__": type(x).__name__, "items": [_skel(v) for v in x]}
    return None


class _ByteBuffer:
    """An in-memory file over a growable numpy byte array, for
    ``zipfile``: the bulk bytes are copied by numpy, which releases the
    GIL (``io.BytesIO`` copies holding it), so an async checkpoint's
    serialisation leaves the training loop's thread free."""

    def __init__(self, capacity: int):
        self.buf = np.empty(max(int(capacity), 64), np.uint8)
        self.pos = self.size = 0

    def write(self, data) -> int:
        src = data.reshape(-1).view(np.uint8) if isinstance(
            data, np.ndarray) else np.frombuffer(data, np.uint8)
        end = self.pos + src.size
        if end > self.buf.size:
            grown = np.empty(max(end, 2 * self.buf.size), np.uint8)
            grown[:self.size] = self.buf[:self.size]
            self.buf = grown
        self.buf[self.pos:end] = src
        self.pos = end
        self.size = max(self.size, end)
        return src.size

    def tell(self) -> int:
        return self.pos

    def seek(self, pos: int, whence: int = 0) -> int:
        self.pos = pos if whence == 0 else (
            self.pos + pos if whence == 1 else self.size + pos)
        return self.pos

    def flush(self):
        pass

    def value(self) -> memoryview:
        return memoryview(self.buf[:self.size])


def npz_bytes(named: Iterable[Tuple[str, Any]]) -> memoryview:
    """An uncompressed ``.npz`` of ``(key, array)`` pairs, in that order,
    with a fixed timestamp on every member, as a read-only buffer (a
    memoryview over the bytes; ``bytes(...)`` copies it)."""
    arrays = []
    for key, val in named:
        arr = to_numpy(val)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        arrays.append((key, arr))
    out = _ByteBuffer(sum(a.nbytes for _, a in arrays) +
                      1024 * len(arrays) + 4096)
    with zipfile.ZipFile(out, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays:
            info = zipfile.ZipInfo(f"{key}.npy", date_time=_ZIP_TIME)
            info.external_attr = 0o600 << 16
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(arr.reshape(-1).view(np.uint8))
    return out.value()


def pytree_bytes(tree) -> Tuple[memoryview, bytes]:
    """``(npz buffer, treedef bytes)`` of ``tree``, without touching
    disk."""
    flat: Dict[str, Any] = {}
    _flatten(tree, [], flat)
    data = npz_bytes((f"arr::{k}", v) for k, v in flat.items())
    return data, json.dumps(_skel(tree)).encode()


def _unflatten(skel, flat, prefix):
    if isinstance(skel, dict) and "__seq__" in skel:
        items = [_unflatten(s, flat, prefix + [str(i)])
                 for i, s in enumerate(skel["items"])]
        return tuple(items) if skel["__seq__"] == "tuple" else items
    if isinstance(skel, dict):
        return {k: _unflatten(v, flat, prefix + [k]) for k, v in skel.items()}
    arr = flat["/".join(prefix)]
    return arr[()] if arr.ndim == 0 else arr


def pytree_from_bytes(data: bytes, treedef: bytes):
    """The tree :func:`pytree_bytes` (or the JAX package's) wrote, with
    numpy leaves; 0-d arrays come back as numpy scalars."""
    with np.load(io.BytesIO(data), allow_pickle=False) as npz:
        flat = {k[len("arr::"):]: npz[k] for k in npz.files}
    return _unflatten(json.loads(treedef.decode()), flat, prefix=[])


def save_pytree(path: str, tree) -> None:
    from . import file_io

    data, treedef = pytree_bytes(tree)
    file_io.write_bytes(path, data)
    file_io.write_bytes(path + ".treedef", treedef)


def load_pytree(path: str):
    from . import file_io

    return pytree_from_bytes(file_io.read_bytes(path),
                             file_io.read_bytes(path + ".treedef"))


def leaves_bytes(leaves: List[Any]) -> memoryview:
    """An ``.npz`` of ``leaf0``, ``leaf1``, ... in list order."""
    return npz_bytes((f"leaf{i}", leaf) for i, leaf in enumerate(leaves))


def leaves_from_bytes(data: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as npz:
        return [npz[f"leaf{i}"] for i in range(len(npz.files))]


def save_leaves(path: str, leaves: List[Any]) -> None:
    from . import file_io

    file_io.write_bytes(path if path.endswith(".npz") else path + ".npz",
                        leaves_bytes(leaves))


def load_leaves(path: str) -> List[np.ndarray]:
    from . import file_io

    return leaves_from_bytes(file_io.read_bytes(path))
