"""Minimal TensorBoard event writer — no TF dependency.

Counterpart of ``analytics_zoo_tpu/utils/tensorboard.py``, copied: either
package reads the other's event files.

The reference ships a from-scratch TensorBoard writer in Scala
(``zoo/.../tensorboard/FileWriter.scala:32``, ``Summary.scala``); this is the
same idea in Python: hand-encoded Event protobufs in TFRecord framing with
masked crc32c, giving ``TrainSummary``/``ValidationSummary`` parity
(Topology.scala:204-243) without importing TensorFlow on the hot path.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

from .crc32c import crc32c, masked_crc as _masked_crc  # noqa: F401


# ---------------------------------------------------------------------------
# protobuf wire-format helpers
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _pb_int64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _pb_string(field: int, value: str) -> bytes:
    return _pb_bytes(field, value.encode("utf-8"))


def _event(wall_time: float, step: int, *, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _pb_double(1, wall_time) + _pb_int64(2, step)
    if file_version is not None:
        msg += _pb_string(3, file_version)
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_string(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)  # Summary.value (repeated field 1)


class FileWriter:
    """Appends Event records to an events file (thread-safe)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write_event(_event(time.time(), 0,
                                 file_version="brain.Event:2"))

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        rec = header + struct.pack("<I", _masked_crc(header)) + payload + \
            struct.pack("<I", _masked_crc(payload))
        with self._lock:
            self._f.write(rec)
            self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_event(_event(time.time(), int(step),
                                 summary=_scalar_summary(tag, value)))

    def close(self):
        self._f.close()


class TrainSummary(FileWriter):
    """Parity with BigDL TrainSummary as wired by ``setTensorBoard``
    (Topology.scala:204-243): scalars Loss / LearningRate / Throughput."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "train"))


class ValidationSummary(FileWriter):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "validation"))


def read_scalars(path_or_dir: str, tag: Optional[str] = None):
    """Read scalar events back (parity with tensorboard/FileReader.scala).

    Returns list of (step, wall_time, tag, value).
    """
    import glob
    paths = [path_or_dir]
    if os.path.isdir(path_or_dir):
        paths = sorted(glob.glob(os.path.join(path_or_dir,
                                              "events.out.tfevents.*")))
    out = []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        off = 0
        while off + 12 <= len(data):
            (length,) = struct.unpack_from("<Q", data, off)
            payload = data[off + 12: off + 12 + length]
            off += 12 + length + 4
            out.extend(_parse_event(payload, tag))
    return out


def _parse_event(payload: bytes, want_tag):
    # minimal proto parse: wall_time(1,double) step(2,varint) summary(5,bytes)
    wall, step, summ = 0.0, 0, None
    off = 0
    while off < len(payload):
        key, off = _read_varint(payload, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(payload, off)
            if field == 2:
                step = val
        elif wire == 1:
            if field == 1:
                (wall,) = struct.unpack_from("<d", payload, off)
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(payload, off)
            if field == 5:
                summ = payload[off:off + ln]
            off += ln
        else:
            break
    results = []
    if summ:
        soff = 0
        while soff < len(summ):
            key, soff = _read_varint(summ, soff)
            field, wire = key >> 3, key & 7
            if wire == 2:
                ln, soff = _read_varint(summ, soff)
                if field == 1:
                    tag_, val_ = _parse_value(summ[soff:soff + ln])
                    if tag_ is not None and (want_tag is None or
                                             tag_ == want_tag):
                        results.append((step, wall, tag_, val_))
                soff += ln
            elif wire == 0:
                _, soff = _read_varint(summ, soff)
            elif wire == 5:
                soff += 4
            elif wire == 1:
                soff += 8
            else:
                break
    return results


def _parse_value(buf: bytes):
    tag, val = None, None
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, off = _read_varint(buf, off)
            if field == 1:
                tag = buf[off:off + ln].decode("utf-8", "replace")
            off += ln
        elif wire == 5:
            if field == 2:
                (val,) = struct.unpack_from("<f", buf, off)
            off += 4
        elif wire == 0:
            _, off = _read_varint(buf, off)
        elif wire == 1:
            off += 8
        else:
            break
    return tag, val


def _read_varint(buf: bytes, off: int):
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
