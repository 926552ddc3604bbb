"""ONNX operator registry -> torch.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/ops.py``, op for op
and with its semantics (its LayerNormalization over the one ``axis``,
its ``Selu`` constants, SAME_UPPER/SAME_LOWER pads, TopK's ``axis`` and
``largest``). Each impl has the signature ``fn(attrs: dict, inputs:
list) -> list``; an input is a torch tensor, a numpy array (a host
constant, always so at a ``STATIC_ARGS`` position) or None. The loader
(``onnx_loader.py``) runs the shape machinery -- every node whose inputs
are all host constants, and Shape/Size -- once per input signature
through these same impls on CPU tensors, so at serving time only the ops
on activations run, on the device of the activations. Conv and
ConvTranspose call the library convolution (cuDNN on the card) through
``ops/conv.py``'s explicit-pad entry, as the JAX impls call
``lax.conv_general_dilated``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.conv import conv_explicit, conv_transpose_explicit

REGISTRY: Dict[str, Callable[[Dict[str, Any], List[Any]], List[Any]]] = {}

# input positions that must be host constants (shapes, axes, pads...)
STATIC_ARGS: Dict[str, tuple] = {
    "Reshape": (1,), "Expand": (1,), "Tile": (1,),
    "Slice": (1, 2, 3, 4), "Pad": (1, 2), "ConstantOfShape": (0,),
    "Unsqueeze": (1,), "Squeeze": (1,), "ReduceSum": (1,),
    "ReduceMean": (1,), "ReduceMax": (1,), "ReduceMin": (1,),
    "Split": (1,), "TopK": (1,), "Upsample": (1,), "Resize": (1, 2, 3),
}

# ONNX elem_type -> torch dtype (proto.DTYPES, as torch dtypes)
TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                5: torch.int16, 6: torch.int32, 7: torch.int64,
                9: torch.bool, 10: torch.float16, 11: torch.float64,
                16: torch.bfloat16}


def op(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ints(x):
    return [int(v) for v in _host(x).reshape(-1)]


def _axis_list(attrs, inputs, idx=1):
    if "axes" in attrs:
        return list(attrs["axes"])
    if len(inputs) > idx and inputs[idx] is not None:
        return _ints(inputs[idx])
    return None


def _device(inputs):
    for v in inputs:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _t(x, device=None):
    """``x`` as a tensor (a numpy constant copied to ``device``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.array(x, np.float32 if np.asarray(x).dtype == np.float64
                   else None)         # a writable copy; 0-d stays 0-d
    return torch.as_tensor(arr, device=device)


def _ts(inputs):
    """Every non-None input as a tensor on the first tensor's device."""
    dev = _device(inputs)
    return [None if v is None else _t(v, dev) for v in inputs]


def _norm_axis(axis, ndim):
    return axis % ndim if ndim else 0


# -- elementwise -----------------------------------------------------------

def _binary(fn):
    def impl(attrs, inputs):
        xs = _ts(inputs)
        out = fn(xs[0], xs[1])
        for extra in xs[2:]:
            out = fn(out, extra)
        return [out]
    return impl


def _promoted(fn):
    def call(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return fn(a.to(dt), b.to(dt))
    return call


for _name, _fn in [
    ("Add", torch.add), ("Sub", torch.sub), ("Mul", torch.mul),
    ("Div", torch.true_divide), ("Pow", torch.pow),
    ("Max", _promoted(torch.maximum)), ("Min", _promoted(torch.minimum)),
    ("Equal", torch.eq), ("Greater", torch.gt), ("Less", torch.lt),
    ("And", torch.logical_and), ("Or", torch.logical_or),
]:
    REGISTRY[_name] = _binary(_fn)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), with no threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


for _name, _fn in [
    ("Abs", torch.abs), ("Neg", torch.neg), ("Exp", torch.exp),
    ("Log", torch.log), ("Sqrt", torch.sqrt), ("Floor", torch.floor),
    ("Ceil", torch.ceil), ("Sin", torch.sin), ("Cos", torch.cos),
    ("Tanh", torch.tanh), ("Erf", torch.erf),
    ("Sigmoid", torch.sigmoid), ("Relu", torch.relu),
    ("Softplus", _softplus), ("Sign", torch.sign),
    ("Not", torch.logical_not), ("Reciprocal", lambda x: 1.0 / x),
    ("Softsign", F.softsign), ("Identity", lambda x: x),
]:
    REGISTRY[_name] = (lambda attrs, inputs, _fn=_fn:
                       [_fn(_t(inputs[0]))])


@op("Sum")
def _sum(attrs, inputs):
    xs = _ts(inputs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return [out]


@op("Mean")
def _mean(attrs, inputs):
    xs = _ts(inputs)
    return [sum(xs[1:], xs[0]) / len(xs)]


@op("Clip")
def _clip(attrs, inputs):
    xs = _ts(inputs)
    lo = attrs.get("min", xs[1] if len(xs) > 1 else None)
    hi = attrs.get("max", xs[2] if len(xs) > 2 else None)
    x = xs[0]
    if lo is not None:
        x = torch.maximum(x, _t(lo, x.device).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, _t(hi, x.device).to(x.dtype))
    return [x]


@op("LeakyRelu")
def _leaky(attrs, inputs):
    return [F.leaky_relu(_t(inputs[0]), attrs.get("alpha", 0.01))]


@op("Elu")
def _elu(attrs, inputs):
    return [F.elu(_t(inputs[0]), attrs.get("alpha", 1.0))]


@op("Selu")
def _selu(attrs, inputs):
    # jax.nn.selu's fixed constants (the JAX impl reads no attributes)
    return [F.selu(_t(inputs[0]))]


@op("PRelu")
def _prelu(attrs, inputs):
    x, slope = _ts(inputs)
    return [torch.where(x >= 0, x, slope * x)]


@op("HardSigmoid")
def _hard_sigmoid(attrs, inputs):
    a, b = attrs.get("alpha", 0.2), attrs.get("beta", 0.5)
    return [torch.clamp(a * _t(inputs[0]) + b, 0.0, 1.0)]


@op("Gelu")
def _gelu(attrs, inputs):
    approx = "tanh" if attrs.get("approximate", "none") == "tanh" \
        else "none"
    return [F.gelu(_t(inputs[0]), approximate=approx)]


@op("Softmax")
def _softmax(attrs, inputs):
    return [torch.softmax(_t(inputs[0]), dim=int(attrs.get("axis", -1)))]


@op("LogSoftmax")
def _log_softmax(attrs, inputs):
    return [torch.log_softmax(_t(inputs[0]),
                              dim=int(attrs.get("axis", -1)))]


@op("Cast")
def _cast(attrs, inputs):
    return [_t(inputs[0]).to(TORCH_DTYPES[int(attrs["to"])])]


@op("Where")
def _where(attrs, inputs):
    c, a, b = _ts(inputs)
    return [torch.where(c.bool(), a, b)]


# -- matmul / gemm ---------------------------------------------------------


@op("MatMul")
def _matmul(attrs, inputs):
    a, b = _ts(inputs)
    return [torch.matmul(a, b)]


@op("Gemm")
def _gemm(attrs, inputs):
    xs = _ts(inputs)
    a, b = xs[0], xs[1]
    if attrs.get("transA", 0):
        a = a.transpose(-1, -2)
    if attrs.get("transB", 0):
        b = b.transpose(-1, -2)
    out = torch.matmul(a, b)
    if attrs.get("alpha", 1.0) != 1.0:
        out = attrs["alpha"] * out
    if len(xs) > 2 and xs[2] is not None:
        beta = attrs.get("beta", 1.0)
        out = out + (xs[2] if beta == 1.0 else beta * xs[2])
    return [out]


# -- conv / pool (NCHW) ----------------------------------------------------


def _conv_pads(attrs, spatial, kernel, strides, dilations, in_sizes):
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for i in range(spatial):
            eff = (kernel[i] - 1) * dilations[i] + 1
            out = -(-in_sizes[i] // strides[i])  # ceil div
            total = max((out - 1) * strides[i] + eff - in_sizes[i], 0)
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return pads
    p = attrs.get("pads", [0] * (2 * spatial))
    return [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]


@op("Conv")
def _conv(attrs, inputs):
    xs = _ts(inputs)
    x, w = xs[0], xs[1]
    spatial = x.dim() - 2
    kernel = attrs.get("kernel_shape", list(w.shape[2:]))
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    dil = [int(d) for d in attrs.get("dilations", [1] * spatial)]
    groups = int(attrs.get("group", 1))
    pads = _conv_pads(attrs, spatial, kernel, strides, dil, x.shape[2:])
    out = conv_explicit(x, w.to(x.dtype), strides, pads, dil, groups)
    if len(xs) > 2 and xs[2] is not None:
        out = out + xs[2].to(out.dtype).reshape((1, -1) + (1,) * spatial)
    return [out]


@op("ConvTranspose")
def _conv_transpose(attrs, inputs):
    xs = _ts(inputs)
    x, w = xs[0], xs[1]
    spatial = x.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    kernel = attrs.get("kernel_shape", list(w.shape[2:]))
    if "output_shape" in attrs:
        raise NotImplementedError(
            "ConvTranspose with explicit output_shape is not supported; "
            "re-export with pads/output_padding instead")
    out_pad = [int(v) for v in
               attrs.get("output_padding", [0] * spatial)]
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        # deconv SAME: output = input * stride, total pad = k - stride
        pads = []
        for i in range(spatial):
            total = max(kernel[i] - strides[i], 0)
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
    else:
        p = attrs.get("pads", [0] * (2 * spatial))
        pads = [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]
    # the JAX impl reads the kernel as the forward convolution's IO
    # kernel from its dim 0 to its dim 1 channels and transposes that
    # (lax.conv_transpose with transpose_kernel): the input has dim-1
    # channels and the output dim-0 ones, where ONNX's (C_in, C_out/g)
    # has them the other way round (ROADMAP C); output_padding adds to
    # the high side only
    out = conv_transpose_explicit(
        x, w.to(x.dtype).transpose(0, 1), strides,
        [(lo, hi - op_) for (lo, hi), op_ in zip(pads, out_pad)])
    if len(xs) > 2 and xs[2] is not None:
        out = out + xs[2].to(out.dtype).reshape((1, -1) + (1,) * spatial)
    return [out]


def _pool(attrs, x, is_avg):
    spatial = x.dim() - 2
    kernel = [int(k) for k in attrs["kernel_shape"]]
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    pads = _conv_pads(attrs, spatial, kernel, strides, [1] * spatial,
                      x.shape[2:])
    flat = [p for pair in reversed(pads) for p in pair]
    if not is_avg:
        xp = F.pad(x, flat, value=float("-inf")) if any(flat) else x
        fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[spatial]
        return fn(xp, kernel, strides)
    fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[spatial]
    xp = F.pad(x, flat) if any(flat) else x
    out = fn(xp, kernel, strides) * float(np.prod(kernel))
    if attrs.get("count_include_pad", 0) or not any(flat):
        return out / float(np.prod(kernel))
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), flat)
    counts = fn(ones, kernel, strides) * float(np.prod(kernel))
    return out / counts


@op("MaxPool")
def _maxpool(attrs, inputs):
    return [_pool(attrs, _t(inputs[0]), False)]


@op("AveragePool")
def _avgpool(attrs, inputs):
    return [_pool(attrs, _t(inputs[0]), True)]


@op("GlobalAveragePool")
def _gap(attrs, inputs):
    x = _t(inputs[0])
    return [x.mean(dim=tuple(range(2, x.dim())), keepdim=True)]


@op("GlobalMaxPool")
def _gmp(attrs, inputs):
    x = _t(inputs[0])
    return [x.amax(dim=tuple(range(2, x.dim())), keepdim=True)]


@op("BatchNormalization")
def _bn(attrs, inputs):
    x, scale, bias, mean, var = _ts(inputs)[:5]
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps)
    return [(x - mean.reshape(shape)) * (scale * inv).reshape(shape)
            + bias.reshape(shape)]


@op("InstanceNormalization")
def _instancenorm(attrs, inputs):
    x, scale, bias = _ts(inputs)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return [(x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape)]


@op("LayerNormalization")
def _layernorm(attrs, inputs):
    xs = _ts(inputs)
    x = xs[0]
    axis = int(attrs.get("axis", -1))
    eps = attrs.get("epsilon", 1e-5)
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    if len(xs) > 1:
        out = out * xs[1]
    if len(xs) > 2:
        out = out + xs[2]
    return [out]


@op("LRN")
def _lrn(attrs, inputs):
    x = _t(inputs[0])
    size = int(attrs["size"])
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    bias = attrs.get("bias", 1.0)
    half = (size - 1) // 2  # ONNX: floor((size-1)/2) before, rest after
    sq = (x * x).unsqueeze(1)                        # (N, 1, C, ...)
    sq = F.pad(sq, [0, 0] * (x.dim() - 2) + [half, size - 1 - half])
    acc = sq.unfold(2, size, 1).sum(-1).squeeze(1)
    return [x / torch.pow(bias + alpha / size * acc, beta)]


@op("Dropout")
def _dropout(attrs, inputs):
    # inference semantics, as the JAX impl
    return [inputs[0]]


# -- shape ops -------------------------------------------------------------


@op("Shape")
def _shape(attrs, inputs):
    return [np.asarray(tuple(inputs[0].shape), np.int64)]


@op("Size")
def _size(attrs, inputs):
    return [np.asarray(int(np.prod(tuple(inputs[0].shape))), np.int64)]


@op("Reshape")
def _reshape(attrs, inputs):
    x = _t(inputs[0])
    target = attrs.get("shape") or _ints(inputs[1])
    shape = [x.shape[i] if d == 0 and attrs.get("allowzero", 0) == 0 else d
             for i, d in enumerate(target)]
    return [torch.reshape(x, shape)]


@op("Flatten")
def _flatten(attrs, inputs):
    x = _t(inputs[0])
    axis = int(attrs.get("axis", 1))
    lead = int(np.prod(tuple(x.shape[:axis]))) if axis else 1
    return [torch.reshape(x, (lead, -1))]


@op("Transpose")
def _transpose(attrs, inputs):
    x = _t(inputs[0])
    perm = attrs.get("perm")
    perm = list(perm) if perm is not None else list(range(x.dim()))[::-1]
    return [x.permute(*perm)]


@op("Concat")
def _concat(attrs, inputs):
    return [torch.cat(_ts(inputs), dim=int(attrs.get("axis", 0)))]


@op("Split")
def _split(attrs, inputs):
    x = _t(inputs[0])
    axis = int(attrs.get("axis", 0))
    splits = attrs.get("split") or (
        _ints(inputs[1]) if len(inputs) > 1 else None)
    if splits:
        return list(torch.split(x, [int(s) for s in splits], dim=axis))
    num = int(attrs.get("num_outputs", 2))
    return list(torch.tensor_split(x, num, dim=axis))


@op("Squeeze")
def _squeeze(attrs, inputs):
    x = _t(inputs[0])
    axes = _axis_list(attrs, inputs)
    if not axes:
        return [x.squeeze()]
    axes = sorted({_norm_axis(int(a), x.dim()) for a in axes},
                  reverse=True)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"Squeeze: axis {a} has size {x.shape[a]}")
        x = x.squeeze(a)
    return [x]


@op("Unsqueeze")
def _unsqueeze(attrs, inputs):
    x = _t(inputs[0])
    for ax in sorted(_axis_list(attrs, inputs)):
        x = x.unsqueeze(int(ax))
    return [x]


@op("Expand")
def _expand(attrs, inputs):
    target = _ints(inputs[1])
    x = _t(inputs[0])
    # ONNX Expand = bidirectional broadcast
    shape = list(np.broadcast_shapes(tuple(x.shape), tuple(target)))
    return [torch.broadcast_to(x, shape)]


@op("Tile")
def _tile(attrs, inputs):
    return [torch.tile(_t(inputs[0]), tuple(_ints(inputs[1])))]


@op("Gather")
def _gather(attrs, inputs):
    x, idx = _ts(inputs)
    axis = _norm_axis(int(attrs.get("axis", 0)), x.dim())
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    flat = torch.index_select(x, axis, idx.reshape(-1))
    return [flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) +
                         tuple(x.shape[axis + 1:]))]


@op("GatherElements")
def _gather_elems(attrs, inputs):
    x, idx = _ts(inputs)
    axis = _norm_axis(int(attrs.get("axis", 0)), x.dim())
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    # jnp.take_along_axis broadcasts the other dims of both
    rest = torch.broadcast_shapes(
        tuple(1 if i == axis else d for i, d in enumerate(x.shape)),
        tuple(1 if i == axis else d for i, d in enumerate(idx.shape)))
    xb = x.expand(tuple(x.shape[axis] if i == axis else d
                        for i, d in enumerate(rest)))
    ib = idx.expand(tuple(idx.shape[axis] if i == axis else d
                          for i, d in enumerate(rest)))
    return [torch.gather(xb, axis, ib)]


@op("Slice")
def _slice(attrs, inputs):
    x = _t(inputs[0])
    if "starts" in attrs:  # opset-1 style
        starts, ends = attrs["starts"], attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts, ends = _ints(inputs[1]), _ints(inputs[2])
        axes = _ints(inputs[3]) if len(inputs) > 3 and inputs[3] is not None \
            else list(range(len(starts)))
        steps = _ints(inputs[4]) if len(inputs) > 4 and inputs[4] is not None \
            else [1] * len(starts)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = _norm_axis(int(ax), x.dim())
        dim = x.shape[ax]
        en = min(en, dim) if en >= 0 else en
        idx = range(*slice(int(st), int(en), int(sp)).indices(dim))
        if sp == 1:
            x = x.narrow(ax, idx.start, len(idx))
        else:
            x = torch.index_select(x, ax, torch.as_tensor(
                list(idx), dtype=torch.long, device=x.device))
    return [x]


@op("Pad")
def _pad(attrs, inputs):
    x = _t(inputs[0])
    pads = attrs.get("pads") or _ints(inputs[1])
    mode = attrs.get("mode", "constant")
    value = attrs.get("value", 0.0)
    if len(inputs) > 2 and inputs[2] is not None:
        value = float(_host(inputs[2]))
    n = x.dim()
    widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode == "constant":
        flat = [p for pair in reversed(widths) for p in pair]
        return [F.pad(x, flat, value=value)]
    # reflect / edge, any rank: gather each axis by numpy's padded index
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, ax, torch.as_tensor(
                idx, dtype=torch.long, device=x.device))
    return [x]


@op("Constant")
def _constant(attrs, inputs):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in attrs:
            return [np.asarray(attrs[key])]
    raise ValueError("Constant node without value")


@op("ConstantOfShape")
def _constant_of_shape(attrs, inputs):
    shape = _ints(inputs[0])
    val = attrs.get("value", np.zeros(1, np.float32))
    val = np.asarray(val).reshape(-1)[0]
    return [np.full(shape, val, dtype=np.asarray(val).dtype)]


@op("Range")
def _range(attrs, inputs):
    start, limit, delta = (_host(v).item() for v in inputs)
    return [np.arange(start, limit, delta)]


# -- reductions ------------------------------------------------------------


def _reduce(fn):
    def impl(attrs, inputs):
        x = _t(inputs[0])
        axes = _axis_list(attrs, inputs)
        keep = bool(attrs.get("keepdims", 1))
        axes = tuple(_norm_axis(int(a), x.dim()) for a in axes) if axes \
            else tuple(range(x.dim()))
        return [fn(x, axes, keep)]
    return impl


def _prod(x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=True)
    return x if keep else x.reshape([d for i, d in enumerate(x.shape)
                                     if i not in axes])


def _l2(x, axes, keep):
    return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keep))


REGISTRY["ReduceSum"] = _reduce(
    lambda x, a, k: torch.sum(x, dim=a, keepdim=k))
REGISTRY["ReduceMean"] = _reduce(
    lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
REGISTRY["ReduceMax"] = _reduce(
    lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
REGISTRY["ReduceMin"] = _reduce(
    lambda x, a, k: torch.amin(x, dim=a, keepdim=k))
REGISTRY["ReduceProd"] = _reduce(_prod)
REGISTRY["ReduceL2"] = _reduce(_l2)


@op("ArgMax")
def _argmax(attrs, inputs):
    axis = int(attrs.get("axis", 0))
    keep = bool(attrs.get("keepdims", 1))
    return [torch.argmax(_t(inputs[0]), dim=axis, keepdim=keep)]


@op("ArgMin")
def _argmin(attrs, inputs):
    axis = int(attrs.get("axis", 0))
    keep = bool(attrs.get("keepdims", 1))
    return [torch.argmin(_t(inputs[0]), dim=axis, keepdim=keep)]


@op("TopK")
def _topk(attrs, inputs):
    k = int(attrs.get("k", _ints(inputs[1])[0] if len(inputs) > 1 else 1))
    axis = int(attrs.get("axis", -1))
    largest = bool(int(attrs.get("largest", 1)))
    vals, idx = torch.topk(_t(inputs[0]), k, dim=axis, largest=largest,
                           sorted=True)
    return [vals, idx]
