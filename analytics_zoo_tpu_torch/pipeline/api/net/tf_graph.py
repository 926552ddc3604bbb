"""TF GraphDef -> torch translator.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/tf_graph.py``
(parity: ``zoo/.../pipeline/api/net/TFNet.scala``, which runs frozen TF
graphs through libtensorflow on the host). The GraphDef is translated
node by node into torch ops, so an imported graph runs on the card with
the rest of the model; float Consts are trainable parameters, and
autograd gives their gradients. The registry holds exactly the JAX
package's 110 op names: a graph with any other op (``Einsum``,
``Erfc``) raises :class:`UnsupportedTFGraph` in both packages.

The graph is read by the port's own protobuf reader (``graphdef.py``);
TensorFlow is never imported here. Each node's attributes are decoded
once, at construction.

Host values. Integer Consts stay numpy, and an op whose inputs are all
host values (numpy arrays, Python numbers) runs on the CPU and hands back
numpy, as the JAX package folds them under ``ensure_compile_time_eval``:
``Shape`` of a card tensor is numpy, so ``Shape`` -> ``StridedSlice`` ->
``Pack`` -> ``Reshape`` never reaches the card, and shape arguments are
read on the host with no device sync. Inside the graph a float64 value
computes as float32, as JAX computes it with 64-bit types off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.conv import conv_explicit, pad_spatial, same_pads
from . import graphdef as gd

TF_REGISTRY: Dict[str, Callable] = {}


class UnsupportedTFGraph(Exception):
    pass


def tf_op(*names):
    def deco(fn):
        for n in names:
            TF_REGISTRY[n] = fn
        return fn
    return deco


# -- host and device values ---------------------------------------------------

_HOST = (np.ndarray, np.generic, int, float, bool)

#: DataType -> the torch dtype a ``Cast`` gives (float64 computes as
#: float32, see the module docstring)
TORCH_DTYPES = {
    gd.DT_FLOAT: torch.float32, gd.DT_DOUBLE: torch.float32,
    gd.DT_INT32: torch.int32, gd.DT_UINT8: torch.uint8,
    gd.DT_INT16: torch.int16, gd.DT_INT8: torch.int8,
    gd.DT_INT64: torch.int64, gd.DT_BOOL: torch.bool,
    gd.DT_BFLOAT16: torch.bfloat16, gd.DT_HALF: torch.float16,
}


def to_tensor(v, device=None) -> torch.Tensor:
    """A host value as a tensor (float64 as float32), on ``device``."""
    if isinstance(v, torch.Tensor):
        return v if device is None or v.device == device else v.to(device)
    arr = np.asarray(v)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.uint16 or arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    t = torch.from_numpy(np.array(arr))
    return t if device is None else t.to(device)


def _tensors(vals) -> List[torch.Tensor]:
    """``vals`` as tensors on one device: that of the first tensor off
    the CPU, else the CPU."""
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)
                   and v.device.type != "cpu"), torch.device("cpu"))
    return [to_tensor(v, device) for v in vals]


def _ints(v) -> List[int]:
    """A shape-like operand as Python ints (read on the host)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _int(v) -> int:
    (i,) = _ints(v)
    return i


def _float(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.detach().cpu().reshape(-1)[0])
    return float(np.asarray(v).reshape(-1)[0])


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t        # no numpy type: stays a (CPU) tensor
        return t.detach().numpy()
    return np.asarray(t)


def _nhwc_pool_args(attrs):
    fmt = attrs.get("data_format", "NHWC")
    ks, st = attrs["ksize"], attrs["strides"]
    if fmt == "NHWC":
        return (ks[1], ks[2]), (st[1], st[2]), fmt
    return (ks[2], ks[3]), (st[2], st[3]), fmt


# -- structural ---------------------------------------------------------------


@tf_op("Identity", "StopGradient", "PreventGradient", "CheckNumerics",
       "EnsureShape", "Snapshot", "ReadVariableOp")
def _identity(attrs, ins):
    # ReadVariableOp: the resource placeholder's value IS the variable's
    # (capture-based lowering feeds variable tensors straight in).
    # StopGradient is the identity, gradient included, as in the JAX
    # package
    return [ins[0]]


@tf_op("IdentityN")
def _identity_n(attrs, ins):
    return list(ins)


@tf_op("NoOp")
def _noop(attrs, ins):
    return []


# -- math ---------------------------------------------------------------------


def _floordiv(a, b):
    # floats: floor(a / b), whose gradient is zero as jnp's is
    return torch.floor(a / b) if a.is_floating_point() else \
        torch.floor_divide(a, b)


_BINOPS = {
    "Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "Div": torch.true_divide,
    "RealDiv": torch.true_divide, "FloorDiv": _floordiv,
    "Maximum": torch.maximum, "Minimum": torch.minimum, "Pow": torch.pow,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "Greater": torch.gt, "GreaterEqual": torch.ge, "Less": torch.lt,
    "LessEqual": torch.le, "Equal": torch.eq, "NotEqual": torch.ne,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
    # jnp.mod is the floor modulo (the sign of the divisor), as TF's
    "Mod": torch.remainder,
}


def _common(a, b):
    """Two operands on one device, in one dtype where they differ in kind
    the way jnp promotes (a tensor's dtype wins over a host scalar's)."""
    a, b = _tensors([a, b])
    if a.dtype != b.dtype and not (a.dtype == torch.bool or
                                   b.dtype == torch.bool):
        dt = torch.promote_types(a.dtype, b.dtype)
        if a.dim() == 0 and b.dim() > 0 and (
                a.is_floating_point() == b.is_floating_point()):
            dt = b.dtype
        elif b.dim() == 0 and a.dim() > 0 and (
                a.is_floating_point() == b.is_floating_point()):
            dt = a.dtype
        a, b = a.to(dt), b.to(dt)
    return a, b


for _n, _f in _BINOPS.items():
    TF_REGISTRY[_n] = (lambda attrs, ins, _f=_f: [_f(*_common(ins[0],
                                                              ins[1]))])


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _reciprocal(x):
    return 1.0 / x


_UNOPS = {
    "Relu": torch.relu, "Relu6": _relu6, "Elu": F.elu, "Selu": torch.selu,
    "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "Softsign": F.softsign, "Exp": torch.exp, "Log": torch.log,
    "Log1p": torch.log1p, "Neg": torch.neg, "Abs": torch.abs,
    "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt, "Square": torch.square,
    "Sign": torch.sign, "Floor": torch.floor, "Ceil": torch.ceil,
    "Round": torch.round, "Erf": torch.erf, "Sin": torch.sin, "Cos": torch.cos,
    "LogicalNot": torch.logical_not, "Reciprocal": _reciprocal,
    "ZerosLike": torch.zeros_like, "OnesLike": torch.ones_like,
    "Tan": torch.tan, "Atan": torch.atan,
}

_INT_OK = {"Neg", "Abs", "Sign", "Square", "ZerosLike", "OnesLike",
           "LogicalNot", "Relu"}


def _unop(name, fn):
    def impl(attrs, ins):
        (x,) = _tensors(ins[:1])
        if not x.is_floating_point() and name not in _INT_OK:
            x = x.float()
        return [fn(x)]
    return impl


for _n, _f in _UNOPS.items():
    TF_REGISTRY[_n] = _unop(_n, _f)


@tf_op("LeakyRelu")
def _leaky_relu(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [F.leaky_relu(x, attrs.get("alpha", 0.2))]


@tf_op("AddN")
def _addn(attrs, ins):
    xs = _tensors(ins)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return [out]


@tf_op("MatMul")
def _matmul(attrs, ins):
    a, b = _tensors(ins)
    if attrs.get("transpose_a"):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b"):
        b = b.transpose(-1, -2)
    return [torch.matmul(a, b)]


@tf_op("BatchMatMul", "BatchMatMulV2")
def _batch_matmul(attrs, ins):
    a, b = _tensors(ins)
    if attrs.get("adj_x"):
        a = a.transpose(-1, -2)
    if attrs.get("adj_y"):
        b = b.transpose(-1, -2)
    return [torch.matmul(a, b)]


@tf_op("BiasAdd")
def _bias_add(attrs, ins):
    x, b = _tensors(ins)
    if attrs.get("data_format", "NHWC") == "NCHW" and x.dim() > 2:
        return [x + b.reshape((1, -1) + (1,) * (x.dim() - 2))]
    return [x + b]


@tf_op("Softmax")
def _softmax(attrs, ins):
    (x,) = _tensors(ins)
    return [torch.softmax(x, dim=-1)]


@tf_op("LogSoftmax")
def _log_softmax(attrs, ins):
    (x,) = _tensors(ins)
    return [torch.log_softmax(x, dim=-1)]


@tf_op("Select", "SelectV2")
def _select(attrs, ins):
    c, a, b = _tensors(ins)
    a, b = _common(a, b)
    return [torch.where(c.bool(), a, b)]


@tf_op("SparseSoftmaxCrossEntropyWithLogits")
def _sparse_softmax_xent(attrs, ins):
    logits, labels = _tensors(ins)
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels[..., None])[..., 0]
    backprop = torch.softmax(logits, dim=-1) - F.one_hot(
        labels, logits.shape[-1]).to(logits.dtype)
    return [-picked, backprop]


@tf_op("SoftmaxCrossEntropyWithLogits")
def _softmax_xent(attrs, ins):
    logits, labels = _tensors(ins)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.sum(labels * logp, dim=-1)
    backprop = torch.softmax(logits, dim=-1) - labels
    return [loss, backprop]


@tf_op("Cast")
def _cast(attrs, ins):
    code = int(attrs["DstT"]) % gd.REF_OFFSET
    if code not in TORCH_DTYPES:
        raise UnsupportedTFGraph(f"Cast to DataType {code}")
    (x,) = _tensors(ins)
    return [x.to(TORCH_DTYPES[code])]


# -- reductions ---------------------------------------------------------------


def _tf_reduce(kind):
    def impl(attrs, ins):
        (x,) = _tensors(ins[:1])
        axes = [a % x.dim() if x.dim() else a for a in _ints(ins[1])]
        keep = bool(attrs.get("keep_dims", attrs.get("keepdims", False)))
        dims = tuple(axes) if axes else tuple(range(x.dim()))
        if kind == "mean":
            if not x.is_floating_point():
                x = x.float()
            return [torch.mean(x, dim=dims, keepdim=keep) if dims
                    else x.clone()]
        if not dims:
            return [x.clone()]
        if kind == "sum":
            return [torch.sum(x, dim=dims, keepdim=keep)]
        if kind == "max":
            return [torch.amax(x, dim=dims, keepdim=keep)]
        if kind == "min":
            return [torch.amin(x, dim=dims, keepdim=keep)]
        # prod, all, any take one dim at a time
        fn = {"prod": torch.prod, "all": torch.all, "any": torch.any}[kind]
        out = x.bool() if kind in ("all", "any") else x
        for d in sorted(dims, reverse=True):
            out = fn(out, dim=d, keepdim=keep)
        return [out]
    return impl


TF_REGISTRY["Mean"] = _tf_reduce("mean")
TF_REGISTRY["Sum"] = _tf_reduce("sum")
TF_REGISTRY["Max"] = _tf_reduce("max")
TF_REGISTRY["Min"] = _tf_reduce("min")
TF_REGISTRY["Prod"] = _tf_reduce("prod")
TF_REGISTRY["All"] = _tf_reduce("all")
TF_REGISTRY["Any"] = _tf_reduce("any")


@tf_op("ArgMax")
def _argmax(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [torch.argmax(x, dim=_int(ins[1]))]


@tf_op("ArgMin")
def _argmin(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [torch.argmin(x, dim=_int(ins[1]))]


# -- conv / pool --------------------------------------------------------------


def _spatial(fmt, vals):
    return (vals[1], vals[2]) if fmt == "NHWC" else (vals[2], vals[3])


def _tf_pads(attrs, sizes, window, strides, dilation=(1, 1)):
    """(before, after) pads of the two spatial dims: SAME as XLA's (TF's),
    VALID none, EXPLICIT from ``explicit_paddings`` at the layout's H, W
    positions."""
    pad = attrs.get("padding", "VALID")
    if pad == "EXPLICIT":
        ep = attrs.get("explicit_paddings", [])
        idx = (4, 6) if attrs.get("data_format", "NHWC") == "NCHW" \
            else (2, 4)
        return [(int(ep[i]), int(ep[i + 1])) for i in idx]
    if pad == "SAME":
        return same_pads(sizes, window, strides, dilation)
    return [(0, 0), (0, 0)]


def _first(x, fmt):
    return x.movedim(-1, 1) if fmt == "NHWC" else x


def _last(y, fmt):
    return y.movedim(1, -1) if fmt == "NHWC" else y


@tf_op("Conv2D")
def _conv2d(attrs, ins):
    x, w = _tensors(ins)           # w: HWIO
    fmt = attrs.get("data_format", "NHWC")
    st = _spatial(fmt, attrs["strides"])
    dl = _spatial(fmt, attrs.get("dilations", [1, 1, 1, 1]))
    xc = _first(x, fmt)
    pads = _tf_pads(attrs, xc.shape[2:], w.shape[:2], st, dl)
    y = conv_explicit(xc, w.permute(3, 2, 0, 1), st, pads, dl)
    return [_last(y, fmt)]


@tf_op("DepthwiseConv2dNative")
def _depthwise(attrs, ins):
    x, w = _tensors(ins)           # w: (H, W, C_in, multiplier)
    fmt = attrs.get("data_format", "NHWC")
    st = _spatial(fmt, attrs["strides"])
    h, w_, cin, mult = w.shape
    # output channel c * mult + m reads input channel c (TF's order); the
    # dilations are ignored, as in the JAX package
    kernel = w.permute(2, 3, 0, 1).reshape(cin * mult, 1, h, w_)
    xc = _first(x, fmt)
    pads = _tf_pads(attrs, xc.shape[2:], (h, w_), st)
    y = conv_explicit(xc, kernel, st, pads, groups=cin)
    return [_last(y, fmt)]


def _tf_pool(attrs, x, avg=False):
    (kh, kw), (sh, sw), fmt = _nhwc_pool_args(attrs)
    xc = _first(x, fmt)
    pads = same_pads(xc.shape[2:], (kh, kw), (sh, sw)) \
        if attrs.get("padding", "VALID") == "SAME" else [(0, 0), (0, 0)]
    if not avg:
        y = F.max_pool2d(pad_spatial(xc, pads, -float("inf")), (kh, kw),
                         (sh, sw))
    else:
        def window_sums(t):
            return F.avg_pool2d(pad_spatial(t, pads), (kh, kw), (sh, sw),
                                divisor_override=1)
        y = window_sums(xc)
        if any(p for pair in pads for p in pair):
            # SAME divides by the count of unpadded cells
            y = y / window_sums(torch.ones(
                (1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                device=x.device))
        else:
            y = y / (kh * kw)
    return _last(y, fmt)


@tf_op("MaxPool")
def _maxpool(attrs, ins):
    (x,) = _tensors(ins)
    return [_tf_pool(attrs, x)]


@tf_op("AvgPool")
def _avgpool(attrs, ins):
    (x,) = _tensors(ins)
    return [_tf_pool(attrs, x, avg=True)]


@tf_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(attrs, ins):
    # inference normalization whatever is_training says, as in the JAX
    # package; the five extra outputs are the statistics
    x, scale, offset, mean, var = _tensors(ins[:5])
    eps = attrs.get("epsilon", 1e-3)
    fmt = attrs.get("data_format", "NHWC")
    shape = (1, -1, 1, 1) if fmt == "NCHW" else (1, 1, 1, -1)
    inv = torch.rsqrt(var + eps) * scale
    out = x * inv.reshape(shape) + (offset - mean * inv).reshape(shape)
    return [out, mean, var, mean, var, mean]


# -- shape manipulation -------------------------------------------------------


@tf_op("Shape")
def _shape(attrs, ins):
    return [np.asarray(tuple(ins[0].shape), np.int32)]


@tf_op("Rank")
def _rank(attrs, ins):
    return [np.asarray(np.ndim(ins[0]) if not isinstance(
        ins[0], torch.Tensor) else ins[0].dim(), np.int32)]


@tf_op("Size")
def _size(attrs, ins):
    return [np.asarray(int(np.prod(tuple(ins[0].shape))), np.int32)]


@tf_op("Reshape")
def _reshape(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [x.reshape(_ints(ins[1]))]


@tf_op("Squeeze")
def _squeeze(attrs, ins):
    (x,) = _tensors(ins)
    dims = attrs.get("squeeze_dims") or attrs.get("axis") or None
    if not dims:
        return [x.squeeze()]
    return [x.squeeze(tuple(int(d) for d in dims))]


@tf_op("ExpandDims")
def _expand_dims(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [x.unsqueeze(_int(ins[1]))]


@tf_op("ConcatV2")
def _concat(attrs, ins):
    return [torch.cat(_tensors(ins[:-1]), dim=_int(ins[-1]))]


@tf_op("Pack")
def _pack(attrs, ins):
    xs = _tensors(ins)
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [torch.stack([x.to(dt) for x in xs],
                        dim=int(attrs.get("axis", 0)))]


@tf_op("Unpack")
def _unpack(attrs, ins):
    (x,) = _tensors(ins)
    axis = int(attrs.get("axis", 0))
    num = int(attrs["num"])
    return [p.squeeze(axis) for p in torch.tensor_split(x, num, dim=axis)]


@tf_op("Split")
def _split(attrs, ins):
    (x,) = _tensors(ins[1:])
    return list(torch.tensor_split(x, int(attrs["num_split"]),
                                   dim=_int(ins[0])))


@tf_op("SplitV")
def _splitv(attrs, ins):
    (x,) = _tensors(ins[:1])
    points = np.cumsum(_ints(ins[1]))[:-1].tolist()
    return list(torch.tensor_split(x, points, dim=_int(ins[2])))


@tf_op("Transpose")
def _transpose(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [x.permute(_ints(ins[1]))]


def _index_pad(x, pads, mode):
    """``x`` padded by reflection ("REFLECT", the edge not repeated) or
    mirroring ("SYMMETRIC", the edge repeated) along every dim, as
    ``jnp.pad``'s modes do: one gather per padded dim."""
    for d, (a, b) in enumerate(pads):
        if not (a or b):
            continue
        n = x.shape[d]
        idx = np.arange(-a, n + b)
        if mode == "REFLECT":
            period = 2 * (n - 1) if n > 1 else 1
            idx = np.abs(idx) % period
            idx = np.where(idx >= n, period - idx, idx)
        else:
            period = 2 * n
            idx = idx % period
            idx = np.where(idx >= n, period - 1 - idx, idx)
        x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


@tf_op("Pad", "PadV2", "MirrorPad")
def _pad(attrs, ins):
    (x,) = _tensors(ins[:1])
    flat = _ints(ins[1])
    pads = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
    if attrs.get("mode") in ("REFLECT", "SYMMETRIC"):
        return [_index_pad(x, pads, attrs["mode"])]
    cval = _float(ins[2]) if len(ins) > 2 else 0.0
    spec = [p for before_after in reversed(pads) for p in before_after]
    return [F.pad(x, spec, value=cval) if any(spec) else x]


def _stepped(x, d, start, stop, step):
    """``x[..., start:stop:step, ...]`` along dim ``d``; a negative step
    flips the dim first (torch slices only forwards)."""
    n = x.shape[d]
    b, e, s = slice(start, stop, step).indices(n)
    if s > 0:
        return x[(slice(None),) * d + (slice(b, e, s),)]
    count = len(range(b, e, s))
    if count == 0:
        return x.narrow(d, 0, 0)
    first = n - 1 - b
    return x.flip(d)[(slice(None),) * d +
                     (slice(first, first + (count - 1) * -s + 1, -s),)]


@tf_op("StridedSlice")
def _strided_slice(attrs, ins):
    (x,) = _tensors(ins[:1])
    begin, end, strides = _ints(ins[1]), _ints(ins[2]), _ints(ins[3])
    bm = int(attrs.get("begin_mask", 0))
    em = int(attrs.get("end_mask", 0))
    ellipsis = int(attrs.get("ellipsis_mask", 0))
    new_axis = int(attrs.get("new_axis_mask", 0))
    shrink = int(attrs.get("shrink_axis_mask", 0))
    if ellipsis or new_axis:
        raise UnsupportedTFGraph("StridedSlice ellipsis/new_axis mask")
    dropped = []
    for i in range(len(begin)):
        if shrink & (1 << i):
            n = x.shape[i]
            idx = begin[i] + n if begin[i] < 0 else begin[i]
            x = x.narrow(i, idx, 1)
            dropped.append(i)
            continue
        b = None if bm & (1 << i) else begin[i]
        e = None if em & (1 << i) else end[i]
        x = _stepped(x, i, b, e, strides[i])
    if dropped:
        x = x.squeeze(tuple(dropped))
    return [x]


@tf_op("Slice")
def _slice(attrs, ins):
    (x,) = _tensors(ins[:1])
    begin, size = _ints(ins[1]), _ints(ins[2])
    for i, (b, s) in enumerate(zip(begin, size)):
        x = x.narrow(i, b, x.shape[i] - b if s == -1 else s)
    return [x]


@tf_op("GatherV2", "Gather")
def _gather(attrs, ins):
    (x,) = _tensors(ins[:1])
    axis = _int(ins[2]) if len(ins) > 2 else 0
    axis = axis % x.dim()
    idx = to_tensor(ins[1], x.device).long()
    flat = x.index_select(axis, idx.reshape(-1))
    return [flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) +
                         tuple(x.shape[axis + 1:]))]


@tf_op("Tile")
def _tile(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [torch.tile(x, tuple(_ints(ins[1])))]


@tf_op("Fill")
def _fill(attrs, ins):
    (v,) = _tensors(ins[1:])
    return [v.reshape(()).expand(_ints(ins[0])).clone()]


@tf_op("Range")
def _range(attrs, ins):
    s, l, d = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
               .item() for v in ins)
    return [np.arange(s, l, d)]


@tf_op("BroadcastTo")
def _broadcast_to(attrs, ins):
    (x,) = _tensors(ins[:1])
    return [torch.broadcast_to(x, _ints(ins[1]))]


# -----------------------------------------------------------------------------
# GraphDef interpreter
# -----------------------------------------------------------------------------

_SOURCES = ("Const", "Placeholder", "PlaceholderWithDefault")


class TFGraphFunction:
    """A frozen GraphDef as ``fn(params, *inputs) -> outputs``.

    ``graph_def`` is the serialized GraphDef, TensorFlow's GraphDef
    object, or one :func:`graphdef.parse_graph_def` decoded. Float Const
    tensors are the (trainable) params, keyed by node name; with
    ``captures`` (placeholder name -> value of a tensor captured from
    outside a traced ``tf.function``) the captures are the params
    instead, and every Const stays baked."""

    def __init__(self, graph_def, input_names: List[str],
                 output_names: List[str],
                 captures: Optional[Dict[str, np.ndarray]] = None,
                 trainable_captures: Optional[List[str]] = None):
        if isinstance(graph_def, (bytes, bytearray, memoryview)) or \
                hasattr(graph_def, "SerializeToString"):
            graph_def = gd.parse_graph_def(graph_def)
        self.graph_def = graph_def
        self.input_names = [n.split(":")[0] for n in input_names]
        self.output_names = list(output_names)
        self.captures = {k: np.asarray(v) for k, v in
                         (captures or {}).items()}
        self.consts: Dict[str, np.ndarray] = {}
        self.steps: List[tuple] = []     # (name, op, attrs, input refs)
        unsupported = set()
        for n in graph_def["node"]:
            op = n.get("op", "")
            if op == "Const":
                self.consts[n["name"]] = gd.node_attrs(n)["value"]
            elif op not in _SOURCES and op not in TF_REGISTRY:
                unsupported.add(op)
            refs = []
            for ref in n.get("input", []):
                if ref.startswith("^"):
                    continue         # control edge
                name, _, idx = ref.partition(":")
                refs.append((name, int(idx) if idx else None))
            if op != "Const":
                self.steps.append((n["name"], op, gd.node_attrs(n)
                                   if op in TF_REGISTRY else {}, refs))
        if unsupported:
            raise UnsupportedTFGraph(
                f"unsupported TF ops: {sorted(unsupported)}")
        if captures:
            self.param_names = list(
                trainable_captures if trainable_captures is not None
                else captures)
        else:
            # trainable = float consts; ints/bools stay baked (shapes)
            self.param_names = [k for k, v in self.consts.items()
                                if np.issubdtype(v.dtype, np.floating)]

    def serialized(self) -> bytes:
        return gd.encode(self.graph_def, "GraphDef")

    def __getstate__(self):
        return {"graph": self.serialized(), "inputs": self.input_names,
                "outputs": self.output_names, "captures": self.captures,
                "params": self.param_names}

    def __setstate__(self, state):
        self.__init__(state["graph"], state["inputs"], state["outputs"],
                      captures=state["captures"] or None,
                      trainable_captures=state["params"]
                      if state["captures"] else None)

    @property
    def ops(self) -> List[str]:
        """The graph's op types, once each, sorted."""
        return sorted({op for _, op, _, _ in self.steps} |
                      ({"Const"} if self.consts else set()))

    def init_params(self) -> Dict[str, torch.Tensor]:
        """The params' import values as CPU tensors (float64 as
        float32)."""
        src = self.captures if self.captures else self.consts
        return {k: to_tensor(src[k]) for k in self.param_names}

    def __call__(self, params: Dict[str, Any], *inputs) -> List[Any]:
        env: Dict[str, Any] = {k: v for k, v in self.consts.items()
                               if k not in params}
        for k, v in self.captures.items():
            if k not in params:
                env[k] = v
        env.update(params)
        for name, x in zip(self.input_names, inputs):
            env[name] = x
        for name, op, attrs, refs in self.steps:
            if op in _SOURCES:
                if op == "PlaceholderWithDefault" and name not in env:
                    env[name] = self._get(env, refs[0])
                continue
            ins = [self._get(env, r) for r in refs]
            if ins and all(isinstance(v, _HOST) for v in ins):
                # every input on the host: fold it there, as JAX does
                with torch.no_grad():
                    outs = TF_REGISTRY[op](attrs, [to_tensor(v)
                                                   for v in ins])
                outs = [_to_numpy(o) for o in outs]
            else:
                outs = TF_REGISTRY[op](attrs, ins)
            env[name] = outs if len(outs) != 1 else outs[0]
        results = []
        for ref in self.output_names:
            name, _, idx = ref.partition(":")
            results.append(self._get(env, (name, int(idx) if idx
                                           else None)))
        return results

    @staticmethod
    def _get(env, ref):
        name, idx = ref
        val = env[name]
        if isinstance(val, list):
            val = val[idx or 0]
        return val


def graph_inputs_outputs(graph_def) -> tuple:
    """The frozen graph's default input names (its Placeholders) and
    output names (the nodes no other node consumes, but Consts and
    NoOps), as ``TFNet.from_frozen`` picks them."""
    nodes = graph_def["node"]
    inputs = [n["name"] for n in nodes if n.get("op") == "Placeholder"]
    consumed = {ref.partition(":")[0].lstrip("^")
                for n in nodes for ref in n.get("input", [])}
    outputs = [n["name"] for n in nodes if n["name"] not in consumed and
               n.get("op") not in ("Const", "NoOp")]
    return inputs, outputs
