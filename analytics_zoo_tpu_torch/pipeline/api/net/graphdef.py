"""TensorFlow's GraphDef and SavedModel files, read and written without
TensorFlow.

The JAX package reads a frozen graph through TensorFlow's own protobuf
classes (``GraphDef.ParseFromString``) and decodes its attributes with
``tensor_util.MakeNdarray`` and ``tf.dtypes.as_dtype``. The card's machine
has neither TensorFlow nor ``protobuf``, so the port reads the wire
format itself, over the codec of ``pipeline/api/onnx/proto.py``: the
schemas below mirror ``tensorflow/core/framework/{graph,node_def,
attr_value,tensor,tensor_shape,types,versions}.proto`` and
``tensorflow/core/protobuf/{saved_model,meta_graph}.proto``, whose field
numbers protobuf's compatibility rules freeze. Only the fields the
importer and the exporter use are listed; any other field is skipped.
``GraphDef.library`` (functions) is skipped, as the JAX package ignores
it.

A decoded message is a :class:`~..onnx.proto.Msg` (a dict with attribute
access); a ``map<string, V>`` field decodes to a dict. Byte fields are
``memoryview`` slices of the file's buffer, so a 100 MB ``tensor_content``
is never copied before :func:`make_ndarray` hands it to numpy.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence

import numpy as np

from ..onnx.proto import (_I32, _I64, _LEN, _VARINT, Msg, _iter_fields,
                          _read_varint, _signed, _write_varint)

# -- DataType (types.proto) ---------------------------------------------------

DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_STRING, DT_INT64, DT_BOOL, DT_BFLOAT16, DT_UINT16 = 7, 9, 10, 14, 17
DT_HALF, DT_RESOURCE, DT_UINT32, DT_UINT64 = 19, 20, 22, 23

#: DataType code -> numpy dtype. bfloat16 has no numpy type: its values
#: decode widened (exactly) to float32, and ``Cast`` to it is torch's
NUMPY_DTYPES = {
    DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
    DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8,
    DT_STRING: object, DT_INT64: np.int64, DT_BOOL: np.bool_,
    DT_UINT16: np.uint16, DT_HALF: np.float16, DT_UINT32: np.uint32,
    DT_UINT64: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in NUMPY_DTYPES.items()
               if v is not object}
#: the ``_ref`` variants of old graphs are the code plus 100
REF_OFFSET = 100

# -- schemas ------------------------------------------------------------------
# field -> (name, kind, repeated). kind: 'int' (varint, int64), 'bool',
# 'float32', 'float64', 'string', 'bytes', a nested schema name, or
# 'map:<schema>' (map<string, schema>: entries of key 1, value 2)

SCHEMAS: Dict[str, Dict[int, tuple]] = {
    "GraphDef": {
        1: ("node", "NodeDef", True),
        3: ("version", "int", False),
        4: ("versions", "VersionDef", False),
    },
    "VersionDef": {
        1: ("producer", "int", False),
        2: ("min_consumer", "int", False),
        3: ("bad_consumers", "int", True),
    },
    "NodeDef": {
        1: ("name", "string", False),
        2: ("op", "string", False),
        3: ("input", "string", True),
        4: ("device", "string", False),
        5: ("attr", "map:AttrValue", False),
    },
    "AttrValue": {
        1: ("list", "ListValue", False),
        2: ("s", "bytes", False),
        3: ("i", "int", False),
        4: ("f", "float32", False),
        5: ("b", "bool", False),
        6: ("type", "int", False),
        7: ("shape", "TensorShapeProto", False),
        8: ("tensor", "TensorProto", False),
        9: ("placeholder", "string", False),
    },
    "ListValue": {
        2: ("s", "bytes", True),
        3: ("i", "int", True),
        4: ("f", "float32", True),
        5: ("b", "bool", True),
        6: ("type", "int", True),
        7: ("shape", "TensorShapeProto", True),
        8: ("tensor", "TensorProto", True),
    },
    "TensorProto": {
        1: ("dtype", "int", False),
        2: ("tensor_shape", "TensorShapeProto", False),
        3: ("version_number", "int", False),
        4: ("tensor_content", "bytes", False),
        5: ("float_val", "float32", True),
        6: ("double_val", "float64", True),
        7: ("int_val", "int", True),
        8: ("string_val", "bytes", True),
        10: ("int64_val", "int", True),
        11: ("bool_val", "bool", True),
        13: ("half_val", "int", True),
        16: ("uint32_val", "int", True),
        17: ("uint64_val", "uint", True),
    },
    "TensorShapeProto": {
        2: ("dim", "Dim", True),
        3: ("unknown_rank", "bool", False),
    },
    "Dim": {
        1: ("size", "int", False),
        2: ("name", "string", False),
    },
    "SavedModel": {
        1: ("saved_model_schema_version", "int", False),
        2: ("meta_graphs", "MetaGraphDef", True),
    },
    "MetaGraphDef": {
        1: ("meta_info_def", "MetaInfoDef", False),
        2: ("graph_def", "GraphDef", False),
        5: ("signature_def", "map:SignatureDef", False),
    },
    "MetaInfoDef": {
        1: ("meta_graph_version", "string", False),
        4: ("tags", "string", True),
        5: ("tensorflow_version", "string", False),
        6: ("tensorflow_git_version", "string", False),
    },
    "SignatureDef": {
        1: ("inputs", "map:TensorInfo", False),
        2: ("outputs", "map:TensorInfo", False),
        3: ("method_name", "string", False),
    },
    "TensorInfo": {
        1: ("name", "string", False),
        2: ("dtype", "int", False),
        3: ("tensor_shape", "TensorShapeProto", False),
    },
}

_FIXED = {"float32": ("<f", 4), "float64": ("<d", 8)}


def _varints(val) -> List[int]:
    vals, pos, n = [], 0, len(val)
    while pos < n:
        v, pos = _read_varint(val, pos)
        vals.append(v)
    return vals


def _scalar(kind: str, wire: int, val):
    if kind in _FIXED:
        fmt, _ = _FIXED[kind]
        return struct.unpack(fmt, val)[0]
    if kind == "int":
        return _signed(val) if wire == _VARINT else \
            struct.unpack("<q", val)[0]
    if kind == "uint":
        return val
    if kind == "bool":
        return bool(val)
    if kind == "string":
        return bytes(val).decode("utf-8")
    if kind == "bytes":
        return val
    raise ValueError(kind)


def decode(buf, schema: str = "GraphDef") -> Msg:
    """The message ``schema`` encoded in ``buf`` (bytes or memoryview)."""
    fields = SCHEMAS[schema]
    out = Msg()
    for name, kind, repeated in fields.values():
        if repeated:
            out[name] = []
        elif kind.startswith("map:"):
            out[name] = {}
    for field, wire, val in _iter_fields(memoryview(buf)):
        spec = fields.get(field)
        if spec is None:
            continue
        name, kind, repeated = spec
        if kind.startswith("map:"):
            entry = {k: v for k, _, v in _iter_fields(val)}
            key = bytes(entry.get(1, b"")).decode("utf-8")
            out[name][key] = decode(entry.get(2, b""), kind[4:])
        elif kind in SCHEMAS:
            msg = decode(val, kind)
            if repeated:
                out[name].append(msg)
            else:
                out[name] = msg
        elif repeated and wire == _LEN and kind not in ("string", "bytes"):
            # a packed run of numbers
            if kind in _FIXED:
                fmt, size = _FIXED[kind]
                out[name].extend(np.frombuffer(
                    val, np.dtype(fmt)).tolist())
            else:
                out[name].extend(_scalar(kind, _VARINT, v)
                                 for v in _varints(val))
        elif repeated:
            out[name].append(_scalar(kind, wire, val))
        else:
            out[name] = _scalar(kind, wire, val)
    return out


def encode(msg: Dict[str, Any], schema: str = "GraphDef") -> bytes:
    """``msg`` (a dict of field names) in the wire format of ``schema``;
    repeated numbers are written packed, as protobuf 3 writes them."""
    fields = SCHEMAS[schema]
    by_name = {name: (num, kind, rep)
               for num, (name, kind, rep) in fields.items()}
    out = bytearray()

    def length_delimited(num, data):
        out.extend(_write_varint(num << 3 | _LEN))
        out.extend(_write_varint(len(data)))
        out.extend(data)

    def number(kind, value) -> bytes:
        if kind in _FIXED:
            return struct.pack(_FIXED[kind][0], float(value))
        return _write_varint(int(value))

    for name, value in msg.items():
        if name not in by_name or value is None:
            continue
        num, kind, repeated = by_name[name]
        if kind.startswith("map:"):
            for key in sorted(value):
                entry = bytearray()
                k = key.encode("utf-8")
                entry.extend(_write_varint(1 << 3 | _LEN))
                entry.extend(_write_varint(len(k)) + k)
                v = encode(value[key], kind[4:])
                entry.extend(_write_varint(2 << 3 | _LEN))
                entry.extend(_write_varint(len(v)) + v)
                length_delimited(num, bytes(entry))
        elif kind in SCHEMAS:
            for item in (value if repeated else [value]):
                length_delimited(num, encode(item, kind))
        elif kind in ("string", "bytes"):
            for item in (value if repeated else [value]):
                length_delimited(num, item.encode("utf-8")
                                 if isinstance(item, str) else bytes(item))
        elif repeated:
            if len(value):
                length_delimited(num, b"".join(number(kind, v)
                                               for v in value))
        else:
            wire = _I32 if kind == "float32" else \
                _I64 if kind == "float64" else _VARINT
            out.extend(_write_varint(num << 3 | wire))
            out.extend(number(kind, value))
    return bytes(out)


# -- tensors ------------------------------------------------------------------


def shape_of(shape_msg) -> List[int]:
    """A TensorShapeProto's dims (-1 where unknown)."""
    return [int(d.get("size", 0)) for d in (shape_msg or {}).get("dim", [])]


def _half_bits(vals, code):
    bits = np.asarray(vals, np.int64).astype(np.uint16)
    if code == DT_HALF:
        return bits.view(np.float16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def make_ndarray(t) -> np.ndarray:
    """A TensorProto as numpy, as ``tensor_util.MakeNdarray`` gives it:
    ``tensor_content`` taken as raw little-endian bytes (one slice, never
    a Python loop); otherwise the typed values, the last one repeated to
    fill the shape; no values at all is zeros. ``half_val`` holds fp16
    and bfloat16 bit patterns in int32s; bfloat16 widens to float32."""
    code = int(t.get("dtype", DT_FLOAT)) % REF_OFFSET
    shape = shape_of(t.get("tensor_shape"))
    n = int(np.prod(shape)) if shape else 1
    content = t.get("tensor_content")
    if code == DT_BFLOAT16:
        if content:
            bits = np.frombuffer(content, "<u2").astype(np.uint32)
            return (bits << 16).view(np.float32).reshape(shape)
        vals = _half_bits(t.get("half_val", []), code)
        return _fill(vals, n, np.float32, shape)
    if code not in NUMPY_DTYPES:
        raise ValueError(f"tensor of DataType {code} is not supported")
    dtype = np.dtype(NUMPY_DTYPES[code])
    if code == DT_STRING:
        vals = [bytes(s) for s in t.get("string_val", [])]
        arr = np.empty(len(vals), object)
        arr[:] = vals
        return _fill(arr, n, object, shape)
    if content:
        return np.frombuffer(content, dtype.newbyteorder("<")).astype(
            dtype, copy=False).reshape(shape)
    if code == DT_HALF:
        vals = _half_bits(t.get("half_val", []), code)
    elif code in (DT_FLOAT,):
        vals = t.get("float_val", [])
    elif code == DT_DOUBLE:
        vals = t.get("double_val", [])
    elif code == DT_INT64:
        vals = t.get("int64_val", [])
    elif code == DT_BOOL:
        vals = t.get("bool_val", [])
    elif code == DT_UINT32:
        vals = t.get("uint32_val", [])
    elif code == DT_UINT64:
        vals = t.get("uint64_val", [])
    else:
        vals = t.get("int_val", [])
    return _fill(np.asarray(vals).astype(dtype), n, dtype, shape)


def _fill(vals, n, dtype, shape):
    if len(vals) == n:
        return np.asarray(vals, dtype).reshape(shape)
    out = np.zeros(n, dtype)
    if len(vals):
        out[:len(vals)] = vals
        out[len(vals):] = vals[-1]
    return out.reshape(shape)


def tensor_proto(arr) -> Dict[str, Any]:
    """A TensorProto dict of numpy ``arr`` (its bytes as
    ``tensor_content``)."""
    arr = np.asarray(arr)
    code = DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"no DataType for {arr.dtype}")
    return {"dtype": code,
            "tensor_shape": {"dim": [{"size": int(d)} for d in arr.shape]},
            "tensor_content": np.ascontiguousarray(
                arr, arr.dtype.newbyteorder("<")).tobytes()}


def shape_proto(shape: Sequence) -> Dict[str, Any]:
    """A TensorShapeProto dict; None dims are -1 (unknown)."""
    return {"dim": [{"size": -1 if d is None else int(d)} for d in shape]}


# -- attributes ---------------------------------------------------------------


def attr_value(av) -> Any:
    """An AttrValue as the JAX importer's ``_attrs`` decodes it: ``i``,
    ``f``, ``b``, ``type`` as numbers, ``s`` as text, ``tensor`` as numpy,
    ``shape`` as its dims, a list as its first non-empty list of ``i``,
    ``f``, ``b`` or ``s`` (``[]`` otherwise). None where no value is
    set."""
    for key in ("i", "f", "b", "type"):
        if key in av:
            return av[key]
    if "s" in av:
        return bytes(av["s"]).decode("utf-8", "replace")
    if "tensor" in av:
        return make_ndarray(av["tensor"])
    if "shape" in av:
        return shape_of(av["shape"])
    if "list" in av:
        lst = av["list"]
        for key in ("i", "f", "b", "s"):
            if lst.get(key):
                return [bytes(v) for v in lst[key]] if key == "s" \
                    else list(lst[key])
        return []
    return None


def node_attrs(node) -> Dict[str, Any]:
    """All of a NodeDef's attributes, decoded by :func:`attr_value`."""
    out = {}
    for key, av in node.get("attr", {}).items():
        val = attr_value(av)
        if val is not None:
            out[key] = val
    return out


def make_attr(value) -> Dict[str, Any]:
    """An AttrValue dict for a python value: bool, int, float, str
    (bytes), numpy array (tensor), or a list of ints."""
    if isinstance(value, bool):
        return {"b": value}
    if isinstance(value, (int, np.integer)):
        return {"i": int(value)}
    if isinstance(value, float):
        return {"f": value}
    if isinstance(value, (str, bytes)):
        return {"s": value.encode("utf-8") if isinstance(value, str)
                else value}
    if isinstance(value, np.ndarray):
        return {"tensor": tensor_proto(value)}
    if isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, np.integer)) for v in value):
        return {"list": {"i": [int(v) for v in value]}}
    raise TypeError(f"unsupported attribute value {value!r}")


def type_attr(code: int) -> Dict[str, Any]:
    return {"type": int(code)}


# -- files --------------------------------------------------------------------


def parse_graph_def(raw) -> Msg:
    """A GraphDef from its serialized bytes, or from an object with
    ``SerializeToString`` (TensorFlow's own GraphDef)."""
    if hasattr(raw, "SerializeToString"):
        raw = raw.SerializeToString()
    return decode(raw, "GraphDef")


def read_saved_model(path: str) -> Msg:
    """The SavedModel message of ``path/saved_model.pb``."""
    import os

    with open(os.path.join(path, "saved_model.pb"), "rb") as f:
        return decode(f.read(), "SavedModel")
