"""TFRecord reading/writing.

Counterpart of ``analytics_zoo_tpu/feature/tfrecord.py``. The reference
ingests TFRecords through the ``org.tensorflow:tensorflow-hadoop``
InputFormat (``tf_dataset.py:456-501``). Here the wire format (length ∥
masked-crc32c(length) ∥ payload ∥ masked-crc32c(payload)) is read by the
C++ reader of ``utils/csrc/zoo_data.cpp`` (built at first use; a failed
build raises) and written with the port's native crc32c.
:func:`read_tfrecord_reference`, the JAX package's pure-Python loop, stays
only as the plain version the tests hold the reader against.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator

from ..utils.crc32c import masked_crc
from ..utils.native_loader import load_zoo_data


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file (the native reader:
    a bad length checksum always raises, a bad payload checksum with
    ``verify_crc``)."""
    yield from load_zoo_data().read_tfrecord(path, verify_crc)


def read_tfrecord_reference(path: str,
                            verify_crc: bool = False) -> Iterator[bytes]:
    """The plain Python reader (the JAX package's fallback loop)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if verify_crc and masked_crc(header[:8]) != len_crc:
                raise IOError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated TFRecord in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc(data) != data_crc:
                raise IOError(f"corrupt TFRecord data crc in {path}")
            yield data


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    """Write records in TFRecord framing; returns count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc(rec)))
            n += 1
    return n
