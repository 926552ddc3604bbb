"""CRC32C (Castagnoli) for the checkpoint store and the TensorBoard writer.

Counterpart of ``analytics_zoo_tpu/utils/crc32c.py`` (``crc32c``,
``masked_crc``). The checksum is computed by a slice-by-8 C++ loop
(``csrc/crc32c.cpp``, the JAX package's ``native/zoo_data.cpp`` loop),
compiled with ``g++ -O3`` at first use into ``build/torch_native/`` at
the root of the checkout and loaded with :mod:`ctypes`
(:mod:`native_loader`: a temporary file renamed into place, so processes
that build at once never load a half-written library). A failed build
raises: the
pure-Python table loop (:func:`crc32c_reference`) runs at some 10-20 MB/s
and stays only as the plain version the tests compare against.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from .native_loader import CSRC, build_library

_MASK_DELTA = 0xA282EAD8
_TABLE: Optional[List[int]] = None


def library() -> ctypes.CDLL:
    """The native crc32c library, built on first use
    (``native_loader.build_library``)."""
    lib = build_library(CSRC / "crc32c.cpp", "libzoo_torch_crc32c")
    lib.zoo_torch_crc32c.restype = ctypes.c_uint32
    lib.zoo_torch_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_uint32]
    return lib


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes, bytearray, a contiguous memoryview or
    numpy array), continuing from ``crc``. Reads the buffer in place."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.reshape(-1).view(np.uint8)
    return int(library().zoo_torch_crc32c(buf.ctypes.data, buf.size,
                                          crc & 0xFFFFFFFF))


def masked_crc(data) -> int:
    """The masked CRC32C of TFRecord framing (TensorBoard event files)."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + _MASK_DELTA) & 0xFFFFFFFF


def _table() -> List[int]:
    global _TABLE
    if _TABLE is None:
        out = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            out.append(crc)
        _TABLE = out
    return _TABLE


def crc32c_reference(data: bytes, crc: int = 0) -> int:
    """The plain table-driven loop, one byte at a time (the JAX package's
    fallback): the reference the native loop is held against."""
    table = _table()
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
