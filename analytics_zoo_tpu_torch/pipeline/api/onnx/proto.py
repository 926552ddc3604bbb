"""Self-contained ONNX protobuf wire-format codec.

A copy of ``analytics_zoo_tpu/pipeline/api/onnx/proto.py`` (struct and
numpy only). The reference imports ONNX graphs through the ``onnx``
python package (``pyzoo/zoo/pipeline/api/onnx/onnx_loader.py``); both
packages read the protobuf wire format directly instead, with no
``onnx`` package: a decoder/encoder specialized to the handful of ONNX
messages the importer needs (ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto). The schemas below mirror
onnx/onnx.proto field numbers, which are frozen by protobuf
compatibility rules.

The encoder lets tests and ``chip_smoke.py`` write real ``.onnx`` files
without the onnx package.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# ---------------------------------------------------------------------------
# low-level wire helpers
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed(value: int) -> int:
    """Interpret a decoded varint as int64."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# schemas: field -> (name, kind, repeated). kind: 'int' 'float' 'string'
# 'bytes' or a nested schema name.
# ---------------------------------------------------------------------------

SCHEMAS: Dict[str, Dict[int, Tuple[str, str, bool]]] = {
    "ModelProto": {
        1: ("ir_version", "int", False),
        2: ("producer_name", "string", False),
        7: ("graph", "GraphProto", False),
        8: ("opset_import", "OperatorSetIdProto", True),
    },
    "OperatorSetIdProto": {
        1: ("domain", "string", False),
        2: ("version", "int", False),
    },
    "GraphProto": {
        1: ("node", "NodeProto", True),
        2: ("name", "string", False),
        5: ("initializer", "TensorProto", True),
        11: ("input", "ValueInfoProto", True),
        12: ("output", "ValueInfoProto", True),
    },
    "NodeProto": {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", "AttributeProto", True),
        7: ("domain", "string", False),
    },
    "AttributeProto": {
        1: ("name", "string", False),
        2: ("f", "float32", False),
        3: ("i", "int", False),
        4: ("s", "bytes", False),
        5: ("t", "TensorProto", False),
        7: ("floats", "float32", True),
        8: ("ints", "int", True),
        9: ("strings", "bytes", True),
        20: ("type", "int", False),
    },
    "TensorProto": {
        1: ("dims", "int", True),
        2: ("data_type", "int", False),
        4: ("float_data", "float32", True),
        5: ("int32_data", "int", True),
        7: ("int64_data", "int", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        10: ("double_data", "float64", True),
    },
    "ValueInfoProto": {
        1: ("name", "string", False),
        2: ("type", "TypeProto", False),
    },
    "TypeProto": {
        1: ("tensor_type", "TypeProtoTensor", False),
    },
    "TypeProtoTensor": {
        1: ("elem_type", "int", False),
        2: ("shape", "TensorShapeProto", False),
    },
    "TensorShapeProto": {
        1: ("dim", "ShapeDimension", True),
    },
    "ShapeDimension": {
        1: ("dim_value", "int", False),
        2: ("dim_param", "string", False),
    },
}

# ONNX TensorProto.DataType -> numpy
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


class Msg(dict):
    """Decoded message: dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


def decode(buf: bytes, schema: str = "ModelProto") -> Msg:
    fields = SCHEMAS[schema]
    out = Msg()
    for name, kind, repeated in fields.values():
        if repeated:
            out[name] = []
    for field, wire, val in _iter_fields(buf):
        if field not in fields:
            continue
        name, kind, repeated = fields[field]
        if kind == "int":
            if wire == _LEN:  # packed repeated varints
                vals, pos = [], 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(_signed(v))
                out[name].extend(vals)
                continue
            parsed: Any = _signed(val) if wire == _VARINT else \
                struct.unpack("<q", val)[0]
        elif kind == "float32":
            if wire == _LEN:  # packed floats
                out[name].extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
                continue
            parsed = struct.unpack("<f", val)[0]
        elif kind == "float64":
            if wire == _LEN:
                out[name].extend(
                    struct.unpack(f"<{len(val) // 8}d", val))
                continue
            parsed = struct.unpack("<d", val)[0]
        elif kind == "string":
            parsed = val.decode("utf-8")
        elif kind == "bytes":
            parsed = bytes(val)
        else:  # nested message
            parsed = decode(val, kind)
        if repeated:
            out[name].append(parsed)
        else:
            out[name] = parsed
    return out


def encode(msg: Dict[str, Any], schema: str = "ModelProto") -> bytes:
    fields = SCHEMAS[schema]
    by_name = {name: (num, kind, rep)
               for num, (name, kind, rep) in fields.items()}
    out = bytearray()

    def emit(num: int, kind: str, value: Any):
        if kind == "int":
            out.extend(_write_varint(num << 3 | _VARINT))
            out.extend(_write_varint(int(value)))
        elif kind == "float32":
            out.extend(_write_varint(num << 3 | _I32))
            out.extend(struct.pack("<f", float(value)))
        elif kind == "float64":
            out.extend(_write_varint(num << 3 | _I64))
            out.extend(struct.pack("<d", float(value)))
        elif kind in ("string", "bytes"):
            data = value.encode("utf-8") if isinstance(value, str) else value
            out.extend(_write_varint(num << 3 | _LEN))
            out.extend(_write_varint(len(data)))
            out.extend(data)
        else:
            data = encode(value, kind)
            out.extend(_write_varint(num << 3 | _LEN))
            out.extend(_write_varint(len(data)))
            out.extend(data)

    for name, value in msg.items():
        if name not in by_name or value is None:
            continue
        num, kind, repeated = by_name[name]
        if repeated:
            for item in value:
                emit(num, kind, item)
        else:
            emit(num, kind, value)
    return bytes(out)


# ---------------------------------------------------------------------------
# tensor <-> numpy
# ---------------------------------------------------------------------------


def tensor_to_numpy(t: Msg) -> np.ndarray:
    dtype = DTYPES.get(t.get("data_type", 1), np.float32)
    dims = [int(d) for d in t.get("dims", [])]
    raw = t.get("raw_data")
    if raw:
        if t.get("data_type") == 16:
            # bfloat16 raw bytes: widen bit patterns to float32
            bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32)
            arr = (bits << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=dtype)
    elif t.get("float_data"):
        arr = np.asarray(t["float_data"], dtype=dtype)
    elif t.get("int64_data"):
        arr = np.asarray(t["int64_data"], dtype=dtype)
    elif t.get("int32_data"):
        code = t.get("data_type", 1)
        if code in (10, 16):
            # fp16/bf16 tensors store uint16 bit patterns in int32_data
            bits = np.asarray(t["int32_data"], dtype=np.uint16)
            arr = bits.view(np.float16) if code == 10 else \
                bits.astype(np.uint32) << 16
            if code == 16:
                arr = arr.view(np.float32)
        else:
            arr = np.asarray(t["int32_data"], dtype=dtype)
    elif t.get("double_data"):
        arr = np.asarray(t["double_data"], dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return arr.reshape(dims) if dims else arr.reshape(())


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> Dict[str, Any]:
    arr = np.asarray(arr)
    code = DTYPE_CODES.get(arr.dtype)
    if code is None:
        arr = arr.astype(np.float32)
        code = 1
    msg: Dict[str, Any] = {"dims": list(arr.shape), "data_type": code,
                           "raw_data": arr.tobytes()}
    if name:
        msg["name"] = name
    return msg


# AttributeProto.type codes
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def attr_value(a: Msg) -> Any:
    """Collapse an AttributeProto to its python value."""
    t = a.get("type", 0)
    if t == ATTR_FLOAT:
        return a.get("f", 0.0)
    if t == ATTR_INT:
        return a.get("i", 0)
    if t == ATTR_STRING:
        return a.get("s", b"").decode("utf-8")
    if t == ATTR_TENSOR:
        return tensor_to_numpy(a["t"])
    if t == ATTR_FLOATS:
        return list(a.get("floats", []))
    if t == ATTR_INTS:
        return list(a.get("ints", []))
    if t == ATTR_STRINGS:
        return [s.decode("utf-8") for s in a.get("strings", [])]
    # untyped (hand-built tests): best effort
    for key in ("t", "s", "f", "i"):
        if key in a:
            return attr_value(Msg(a, type={"t": ATTR_TENSOR, "s": ATTR_STRING,
                                           "f": ATTR_FLOAT,
                                           "i": ATTR_INT}[key]))
    if a.get("ints"):
        return list(a["ints"])
    if a.get("floats"):
        return list(a["floats"])
    return None


def make_attr(name: str, value: Any) -> Dict[str, Any]:
    """Build an AttributeProto dict from a python value."""
    if isinstance(value, bool):
        return {"name": name, "type": ATTR_INT, "i": int(value)}
    if isinstance(value, (int, np.integer)):
        return {"name": name, "type": ATTR_INT, "i": int(value)}
    if isinstance(value, float):
        return {"name": name, "type": ATTR_FLOAT, "f": value}
    if isinstance(value, str):
        return {"name": name, "type": ATTR_STRING, "s": value.encode()}
    if isinstance(value, np.ndarray):
        return {"name": name, "type": ATTR_TENSOR,
                "t": numpy_to_tensor(value)}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            return {"name": name, "type": ATTR_INTS,
                    "ints": [int(v) for v in value]}
        if all(isinstance(v, float) for v in value):
            return {"name": name, "type": ATTR_FLOATS,
                    "floats": list(value)}
    raise TypeError(f"unsupported attribute {name}={value!r}")


def make_value_info(name: str, shape, elem_type: int = 1) -> Dict[str, Any]:
    dims = [{"dim_param": "batch"} if d is None else {"dim_value": int(d)}
            for d in shape]
    return {"name": name,
            "type": {"tensor_type": {"elem_type": elem_type,
                                     "shape": {"dim": dims}}}}
