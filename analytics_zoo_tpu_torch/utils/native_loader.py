"""ctypes loader for the port's native host-side libraries.

Counterpart of ``analytics_zoo_tpu/utils/native_loader.py``. Each C++
source under ``utils/csrc/`` (``crc32c.cpp``, ``zoo_data.cpp``,
``zoo_image.cpp``) is
compiled with ``g++ -O3`` at first use into ``build/torch_native/`` at
the root of the checkout, under a name that holds a hash of the source
and the flags (an edited source rebuilds), and loaded over its plain C
interface. The build writes a temporary file and renames it into place,
so processes that build at once never load a half-written library. A
failed build raises :class:`NativeCompileError`: nothing falls back
quietly to a slower path.

:func:`load_zoo_data` wraps ``zoo_data.cpp``: the TFRecord reader
(``read_tfrecord``) and the host arena (:class:`HostArena`, the
PMEM/DIRECT memory tier's staging slab); :func:`load_zoo_image` wraps
``zoo_image.cpp``: the JPEG decoder and encoder and the PNG unfilter of
``feature/image/codec.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class NativeCompileError(RuntimeError):
    """A native source failed to build (or no C++ compiler was found)."""


def _build(source: Path, target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeCompileError(f"g++ not found: the port builds "
                                 f"{source} at first use")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
    res = subprocess.run([cxx] + CXX_FLAGS + [str(source), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeCompileError(f"building {source.name} failed:\n"
                                 f"{res.stderr}")
    os.replace(tmp, target)


def build_library(source: Path, stem: str) -> ctypes.CDLL:
    """``source`` built (once per process, and once per source hash on
    disk) into ``build/torch_native/<stem>.<hash>.so`` and loaded."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
            h.update(source.read_bytes())
            target = BUILD_DIR / f"{stem}.{h.hexdigest()[:16]}.so"
            if not target.exists():
                _build(source, target)
            lib = _libs[stem] = ctypes.CDLL(str(target))
        return lib


class ZooDataLib:
    """Typed wrapper over the built ``zoo_data.cpp``."""

    def __init__(self, lib: ctypes.CDLL):
        lib.zoo_tfrecord_open.restype = ctypes.c_void_p
        lib.zoo_tfrecord_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_char_p]
        lib.zoo_tfrecord_count.restype = ctypes.c_uint64
        lib.zoo_tfrecord_count.argtypes = [ctypes.c_void_p]
        lib.zoo_tfrecord_payload.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.zoo_tfrecord_payload.argtypes = [ctypes.c_void_p]
        lib.zoo_tfrecord_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
        lib.zoo_tfrecord_offsets.argtypes = [ctypes.c_void_p]
        lib.zoo_tfrecord_close.restype = None
        lib.zoo_tfrecord_close.argtypes = [ctypes.c_void_p]
        lib.zoo_arena_create.restype = ctypes.c_void_p
        lib.zoo_arena_create.argtypes = [ctypes.c_uint64]
        lib.zoo_arena_alloc.restype = ctypes.c_uint64
        lib.zoo_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.zoo_arena_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.zoo_arena_base.argtypes = [ctypes.c_void_p]
        lib.zoo_arena_capacity.restype = ctypes.c_uint64
        lib.zoo_arena_capacity.argtypes = [ctypes.c_void_p]
        lib.zoo_arena_used.restype = ctypes.c_uint64
        lib.zoo_arena_used.argtypes = [ctypes.c_void_p]
        lib.zoo_arena_reset.restype = None
        lib.zoo_arena_reset.argtypes = [ctypes.c_void_p]
        lib.zoo_arena_destroy.restype = None
        lib.zoo_arena_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib

    # -- tfrecord --------------------------------------------------------
    def read_tfrecord(self, path: str,
                      verify_crc: bool = False) -> Iterator[bytes]:
        """The record payloads of a TFRecord file; the file is parsed
        (and with ``verify_crc`` every payload checked) before the first
        record is yielded. A bad length checksum always raises."""
        err = ctypes.create_string_buffer(256)
        handle = self._lib.zoo_tfrecord_open(
            os.fsencode(path), int(verify_crc), err)
        if not handle:
            raise IOError(err.value.decode() or f"cannot read {path}")
        try:
            n = self._lib.zoo_tfrecord_count(handle)
            offsets = self._lib.zoo_tfrecord_offsets(handle)
            if n and offsets[n]:
                base = ctypes.addressof(
                    self._lib.zoo_tfrecord_payload(handle).contents)
            for i in range(n):
                start, end = offsets[i], offsets[i + 1]
                yield ctypes.string_at(base + start, end - start) \
                    if end > start else b""
        finally:
            self._lib.zoo_tfrecord_close(handle)

    # -- arena -----------------------------------------------------------
    def arena(self, capacity: int) -> "HostArena":
        return HostArena(self, capacity)


class HostArena:
    """Host-RAM staging arena (the PMEM/DIRECT tier equivalent): one
    64-byte-aligned slab, bump-allocated."""

    def __init__(self, lib: ZooDataLib, capacity: int):
        self._lib = lib._lib
        self._handle = self._lib.zoo_arena_create(int(capacity))
        if not self._handle:
            raise MemoryError(f"cannot allocate {capacity}-byte arena")

    @property
    def capacity(self) -> int:
        return self._lib.zoo_arena_capacity(self._handle)

    @property
    def used(self) -> int:
        return self._lib.zoo_arena_used(self._handle)

    def _base(self) -> int:
        return ctypes.addressof(
            self._lib.zoo_arena_base(self._handle).contents)

    def store(self, data) -> "ArenaView":
        """Copy a numpy array (or bytes) into the arena; a view of it."""
        arr = np.ascontiguousarray(data)
        off = self._lib.zoo_arena_alloc(self._handle, arr.nbytes)
        if off == 2 ** 64 - 1:
            raise MemoryError(f"arena full: {arr.nbytes} bytes do not fit "
                              f"({self.used} of {self.capacity} used)")
        if arr.nbytes:
            ctypes.memmove(self._base() + off, arr.ctypes.data, arr.nbytes)
        return ArenaView(self, off, arr.shape, arr.dtype)

    def view(self, offset: int, shape, dtype) -> np.ndarray:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = (ctypes.c_uint8 * nbytes).from_address(self._base() + offset)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def reset(self):
        self._lib.zoo_arena_reset(self._handle)

    def close(self):
        if self._handle:
            self._lib.zoo_arena_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class ArenaView:
    """A (shape, dtype) window into a :class:`HostArena`."""

    def __init__(self, arena: HostArena, offset: int, shape, dtype):
        self.arena = arena
        self.offset = offset
        self.shape = tuple(shape)
        self.dtype = dtype

    def numpy(self) -> np.ndarray:
        return self.arena.view(self.offset, self.shape, self.dtype)


_zoo_data: Optional[ZooDataLib] = None


def load_zoo_data() -> ZooDataLib:
    """The TFRecord reader and host arena, built on first use; raises
    :class:`NativeCompileError` when the build fails."""
    global _zoo_data
    if _zoo_data is None:
        _zoo_data = ZooDataLib(build_library(CSRC / "zoo_data.cpp",
                                             "libzoo_torch_data"))
    return _zoo_data


_zoo_image: Optional[ctypes.CDLL] = None


def load_zoo_image() -> ctypes.CDLL:
    """The image codec's native library (``zoo_image.cpp``) with its
    argument types set, built on first use; raises
    :class:`NativeCompileError` when the build fails."""
    global _zoo_image
    if _zoo_image is None:
        lib = build_library(CSRC / "zoo_image.cpp", "libzoo_torch_image")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.zoo_image_free.restype = None
        lib.zoo_image_free.argtypes = [ctypes.c_void_p]
        lib.zoo_jpeg_decode.restype = ctypes.c_void_p
        lib.zoo_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ip, ip, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.zoo_jpeg_encode.restype = ctypes.c_void_p
        lib.zoo_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_uint64),
                                        ctypes.c_char_p, ctypes.c_int]
        lib.zoo_png_unfilter.restype = ctypes.c_int
        lib.zoo_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_uint64,
                                         ctypes.c_int, u8p, ctypes.c_char_p,
                                         ctypes.c_int]
        _zoo_image = lib
    return _zoo_image
