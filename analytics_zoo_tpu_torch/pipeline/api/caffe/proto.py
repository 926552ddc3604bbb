"""Caffe protobuf wire-format codec (binary ``.caffemodel`` / NetParameter).

A copy of ``analytics_zoo_tpu/pipeline/api/caffe/proto.py``. The
reference parses these with the bundled caffe protos
(``zoo/.../models/caffe/CaffeLoader.scala:718`` — ``Caffe.NetParameter``
via ``CodedInputStream``); both packages read the protobuf wire format
directly, with no ``caffe_pb2``, with schemas restricted to the messages
the importer consumes. Field numbers mirror BVLC caffe's ``caffe.proto``
and are frozen by protobuf compatibility rules.

Both V2 (``layer``, field 100) and V1 (``layers``, field 2) layer formats
are decoded — the reference ships a converter per vintage
(``LayerConverter.scala`` / ``V1LayerConverter.scala``). Unlike the JAX
copy, a packed float field decodes to a numpy array and a numpy array
encodes packed from its bytes, so a ResNet-50's 25.6M weights read and
write in a fraction of a second.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

from ..onnx.proto import Msg, _iter_fields, _read_varint, _signed, \
    _LEN, _VARINT, _I64, _I32

# field -> (name, kind, repeated); kind: int/float32/float64/string/bytes/
# bool or nested schema name
SCHEMAS: Dict[str, Dict[int, Tuple[str, str, bool]]] = {
    "NetParameter": {
        1: ("name", "string", False),
        2: ("layers", "V1LayerParameter", True),     # deprecated V1
        3: ("input", "string", True),
        4: ("input_dim", "int", True),
        8: ("input_shape", "BlobShape", True),
        100: ("layer", "LayerParameter", True),
    },
    "LayerParameter": {
        1: ("name", "string", False),
        2: ("type", "string", False),
        3: ("bottom", "string", True),
        4: ("top", "string", True),
        10: ("phase", "int", False),
        7: ("blobs", "BlobProto", True),
        8: ("include", "NetStateRule", True),
        9: ("exclude", "NetStateRule", True),
        104: ("concat_param", "ConcatParameter", False),
        106: ("convolution_param", "ConvolutionParameter", False),
        108: ("dropout_param", "DropoutParameter", False),
        110: ("eltwise_param", "EltwiseParameter", False),
        117: ("inner_product_param", "InnerProductParameter", False),
        118: ("lrn_param", "LRNParameter", False),
        121: ("pooling_param", "PoolingParameter", False),
        122: ("power_param", "PowerParameter", False),
        123: ("relu_param", "ReLUParameter", False),
        125: ("softmax_param", "SoftmaxParameter", False),
        126: ("slice_param", "SliceParameter", False),
        131: ("prelu_param", "PReLUParameter", False),
        133: ("reshape_param", "ReshapeParameter", False),
        135: ("flatten_param", "FlattenParameter", False),
        139: ("batch_norm_param", "BatchNormParameter", False),
        140: ("elu_param", "ELUParameter", False),
        142: ("scale_param", "ScaleParameter", False),
        143: ("input_param", "InputParameter", False),
    },
    "V1LayerParameter": {
        2: ("bottom", "string", True),
        3: ("top", "string", True),
        4: ("name", "string", False),
        5: ("type", "int", False),                   # LayerType enum
        6: ("blobs", "BlobProto", True),
        32: ("include", "NetStateRule", True),
        33: ("exclude", "NetStateRule", True),
        9: ("concat_param", "ConcatParameter", False),
        10: ("convolution_param", "ConvolutionParameter", False),
        12: ("dropout_param", "DropoutParameter", False),
        24: ("eltwise_param", "EltwiseParameter", False),
        17: ("inner_product_param", "InnerProductParameter", False),
        18: ("lrn_param", "LRNParameter", False),
        19: ("pooling_param", "PoolingParameter", False),
        21: ("power_param", "PowerParameter", False),
        30: ("relu_param", "ReLUParameter", False),
        39: ("softmax_param", "SoftmaxParameter", False),
        31: ("slice_param", "SliceParameter", False),
    },
    "NetStateRule": {
        1: ("phase", "int", False),
    },
    "BlobShape": {
        1: ("dim", "int", True),
    },
    "BlobProto": {
        7: ("shape", "BlobShape", False),
        5: ("data", "float32", True),
        8: ("double_data", "float64", True),
        1: ("num", "int", False),
        2: ("channels", "int", False),
        3: ("height", "int", False),
        4: ("width", "int", False),
    },
    "ConvolutionParameter": {
        1: ("num_output", "int", False),
        2: ("bias_term", "bool", False),
        3: ("pad", "int", True),
        4: ("kernel_size", "int", True),
        5: ("group", "int", False),
        6: ("stride", "int", True),
        9: ("pad_h", "int", False),
        10: ("pad_w", "int", False),
        11: ("kernel_h", "int", False),
        12: ("kernel_w", "int", False),
        13: ("stride_h", "int", False),
        14: ("stride_w", "int", False),
        16: ("axis", "int", False),
        18: ("dilation", "int", True),
    },
    "PoolingParameter": {
        1: ("pool", "int", False),                   # MAX=0 AVE=1
        2: ("kernel_size", "int", False),
        3: ("stride", "int", False),
        4: ("pad", "int", False),
        5: ("kernel_h", "int", False),
        6: ("kernel_w", "int", False),
        7: ("stride_h", "int", False),
        8: ("stride_w", "int", False),
        9: ("pad_h", "int", False),
        10: ("pad_w", "int", False),
        12: ("global_pooling", "bool", False),
        13: ("round_mode", "int", False),            # CEIL=0 FLOOR=1
    },
    "InnerProductParameter": {
        1: ("num_output", "int", False),
        2: ("bias_term", "bool", False),
        5: ("axis", "int", False),
        6: ("transpose", "bool", False),
    },
    "BatchNormParameter": {
        1: ("use_global_stats", "bool", False),
        2: ("moving_average_fraction", "float32", False),
        3: ("eps", "float32", False),
    },
    "ScaleParameter": {
        1: ("axis", "int", False),
        2: ("num_axes", "int", False),
        4: ("bias_term", "bool", False),
    },
    "EltwiseParameter": {
        1: ("operation", "int", False),              # PROD=0 SUM=1 MAX=2
        2: ("coeff", "float32", True),
    },
    "ConcatParameter": {
        1: ("concat_dim", "int", False),             # deprecated
        2: ("axis", "int", False),
    },
    "LRNParameter": {
        1: ("local_size", "int", False),
        2: ("alpha", "float32", False),
        3: ("beta", "float32", False),
        4: ("norm_region", "int", False),            # ACROSS=0 WITHIN=1
        5: ("k", "float32", False),
    },
    "DropoutParameter": {
        1: ("dropout_ratio", "float32", False),
    },
    "SoftmaxParameter": {
        2: ("axis", "int", False),
    },
    "ReLUParameter": {
        1: ("negative_slope", "float32", False),
    },
    "PowerParameter": {
        1: ("power", "float32", False),
        2: ("scale", "float32", False),
        3: ("shift", "float32", False),
    },
    "PReLUParameter": {
        2: ("channel_shared", "bool", False),
    },
    "ELUParameter": {
        1: ("alpha", "float32", False),
    },
    "FlattenParameter": {
        1: ("axis", "int", False),
        2: ("end_axis", "int", False),
    },
    "ReshapeParameter": {
        1: ("shape", "BlobShape", False),
        2: ("axis", "int", False),
        3: ("num_axes", "int", False),
    },
    "SliceParameter": {
        1: ("slice_dim", "int", False),              # deprecated
        2: ("slice_point", "int", True),
        3: ("axis", "int", False),
    },
    "InputParameter": {
        1: ("shape", "BlobShape", True),
    },
}

# V1 LayerType enum -> V2 string type
V1_LAYER_TYPES = {
    1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution", 5: "Data",
    6: "Dropout", 7: "EuclideanLoss", 8: "Flatten", 11: "Im2col",
    12: "ImageData", 14: "InnerProduct", 15: "LRN", 17: "Pooling",
    18: "ReLU", 19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss",
    22: "Split", 23: "TanH", 24: "WindowData", 25: "Eltwise", 26: "Power",
    28: "HingeLoss", 30: "ArgMax", 31: "Threshold", 33: "Slice",
    34: "MVN", 35: "AbsVal", 36: "Silence", 37: "ContrastiveLoss",
    38: "Exp", 39: "Deconvolution",
}


def decode(buf: bytes, schema: str = "NetParameter") -> Msg:
    """Generic decoder over the caffe SCHEMAS (same machinery as the ONNX
    codec, parameterized by schema table)."""
    fields = SCHEMAS[schema]
    out = Msg()
    for name, kind, repeated in fields.values():
        if repeated:
            out[name] = []
    for field, wire, val in _iter_fields(buf):
        if field not in fields:
            continue
        name, kind, repeated = fields[field]
        if kind in ("int", "bool"):
            if wire == _LEN:                       # packed varints
                vals, pos = [], 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(_signed(v))
                out[name].extend(vals)
                continue
            parsed: Any = _signed(val) if wire == _VARINT else \
                struct.unpack("<q", val)[0]
            if kind == "bool":
                parsed = bool(parsed)
        elif kind in ("float32", "float64"):
            code = "<f4" if kind == "float32" else "<f8"
            if wire == _LEN:                       # packed floats
                # kept as an array: a blob of millions of weights would
                # not fit a list of Python floats in any reasonable time
                packed = np.frombuffer(val, code)
                out[name] = packed.copy() if not len(out[name]) else \
                    np.concatenate([np.asarray(out[name], code), packed])
                continue
            parsed = struct.unpack("<f" if kind == "float32" else "<d",
                                   val)[0]
        elif kind == "string":
            parsed = val.decode("utf-8", errors="replace")
        elif kind == "bytes":
            parsed = bytes(val)
        else:                                      # nested message
            parsed = decode(val, kind)
        if repeated:
            out[name].append(parsed)
        else:
            out[name] = parsed
    return out


def blob_to_numpy(blob: Msg) -> np.ndarray:
    """BlobProto -> numpy, honoring the modern ``shape`` and the legacy
    (num, channels, height, width) dims."""
    if blob.get("double_data"):
        arr = np.asarray(blob["double_data"], np.float64).astype(np.float32)
    else:
        arr = np.asarray(blob.get("data", []), np.float32)
    shape = None
    if isinstance(blob.get("shape"), dict) and blob["shape"].get("dim"):
        shape = tuple(int(d) for d in blob["shape"]["dim"])
    else:
        legacy = [blob.get(k) for k in ("num", "channels", "height",
                                        "width")]
        if any(v is not None for v in legacy):
            shape = tuple(int(v) if v is not None else 1 for v in legacy)
            while len(shape) > 1 and shape[0] == 1 and \
                    int(np.prod(shape[1:])) == arr.size:
                shape = shape[1:]
    if shape is not None and int(np.prod(shape)) == arr.size:
        return arr.reshape(shape)
    return arr


# --- minimal encoder (tests fabricate .caffemodel files with it) ---------

def _write_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode(msg: Dict[str, Any], schema: str = "NetParameter") -> bytes:
    fields = SCHEMAS[schema]
    by_name = {name: (num, kind, rep)
               for num, (name, kind, rep) in fields.items()}
    out = bytearray()

    def emit(num: int, kind: str, value: Any):
        if kind in ("int", "bool"):
            out.extend(_write_varint(num << 3 | _VARINT))
            out.extend(_write_varint(int(value)))
        elif kind == "float32":
            out.extend(_write_varint(num << 3 | _I32))
            out.extend(struct.pack("<f", float(value)))
        elif kind == "float64":
            out.extend(_write_varint(num << 3 | _I64))
            out.extend(struct.pack("<d", float(value)))
        elif kind == "string":
            raw = value.encode("utf-8")
            out.extend(_write_varint(num << 3 | _LEN))
            out.extend(_write_varint(len(raw)))
            out.extend(raw)
        else:
            raw = encode(value, kind)
            out.extend(_write_varint(num << 3 | _LEN))
            out.extend(_write_varint(len(raw)))
            out.extend(raw)

    for name, value in msg.items():
        if name not in by_name:
            raise KeyError(f"{schema} has no field {name}")
        num, kind, rep = by_name[name]
        if rep and kind in ("float32", "float64") and \
                isinstance(value, np.ndarray):
            # a numpy array of a repeated float field is written packed,
            # straight from its bytes
            raw = np.ascontiguousarray(
                value, "<f4" if kind == "float32" else "<f8").tobytes()
            out.extend(_write_varint(num << 3 | _LEN))
            out.extend(_write_varint(len(raw)))
            out.extend(raw)
            continue
        values = value if rep else [value]
        for v in values:
            emit(num, kind, v)
    return bytes(out)
