"""Caffe prototxt + caffemodel -> the port's Keras ``Model``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/caffe/loader.py``
(``Net.load_caffe``; Scala ``CaffeLoader.scala:718`` with its
``LayerConverter`` / ``V1LayerConverter``). The net becomes one
:class:`CaffeGraphModule`, an interpreter over the layer list with the
JAX layer's semantics (explicit symmetric padding, CEIL-rounded pooling
windows clipped as Caffe clips them, grouped convolution, across- and
within-channel LRN, BatchNorm's statistics divided by their scale factor,
Eltwise's field-scoped enum), in a functional ``Model``. Blobs are
trainable parameters under the JAX keys (``"{layer index}/{blob
index}"``); train-only layers are dropped and ``SoftmaxWithLoss`` becomes
``Softmax``. Convolutions run through ``ops/conv.py``'s explicit-pad
entry (cuDNN on the card); a Deconvolution is the JAX layer's
``lax.conv_transpose``: the kernel unflipped over the input dilated by
the stride, under the layer's pads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.conv import conv_explicit
from ..keras.engine.base import Input, KerasLayer
from ..keras.models import Model
from . import proto
from .text_format import parse_prototxt

_PHASE_TRAIN = 0

# V1 enum *names* as they appear in old prototxts
_V1_NAME_TO_TYPE = {
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "POOLING": "Pooling", "INNER_PRODUCT": "InnerProduct", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "TANH": "TanH", "LRN": "LRN",
    "DROPOUT": "Dropout", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "CONCAT": "Concat",
    "ELTWISE": "Eltwise", "FLATTEN": "Flatten", "SLICE": "Slice",
    "SPLIT": "Split", "POWER": "Power", "ABSVAL": "AbsVal",
    "SILENCE": "Silence", "ACCURACY": "Accuracy", "DATA": "Data",
    "IMAGE_DATA": "ImageData", "MEMORY_DATA": "MemoryData",
    "WINDOW_DATA": "WindowData", "HDF5_DATA": "HDF5Data",
}

# layers that only exist at training/data time — dropped at import, like
# the reference's sanity-check exclusions
_SKIP_TYPES = {
    "Data", "ImageData", "MemoryData", "WindowData", "HDF5Data",
    "HDF5Output", "Accuracy", "Silence",
    "SoftmaxWithLoss",  # becomes Softmax on the deploy path below
    "EuclideanLoss", "SigmoidCrossEntropyLoss", "ContrastiveLoss",
    "HingeLoss", "InfogainLoss", "MultinomialLogisticLoss",
}


def _layer_type(layer: proto.Msg) -> str:
    t = layer.get("type", "")
    if isinstance(t, int):
        return proto.V1_LAYER_TYPES.get(t, f"V1_{t}")
    return _V1_NAME_TO_TYPE.get(t, t)


def _train_only(layer: proto.Msg) -> bool:
    for rule in layer.get("include", []) or []:
        if rule.get("phase") == _PHASE_TRAIN:
            return True
    for rule in layer.get("exclude", []) or []:
        if rule.get("phase") == 1:  # excluded from TEST
            return True
    return False


def _pair(param, base, h_key, w_key, default):
    """Caffe's (repeated base | explicit _h/_w) spatial-arg convention."""
    h = param.get(h_key)
    w = param.get(w_key)
    if h is not None or w is not None:
        return int(h or default), int(w or default)
    vals = param.get(base)
    if isinstance(vals, list):
        if not vals:
            return default, default
        if len(vals) == 1:
            return int(vals[0]), int(vals[0])
        return int(vals[0]), int(vals[1])
    if vals is None:
        return default, default
    return int(vals), int(vals)


def _pool_out(size, k, s, p, ceil_mode):
    r = (size + 2 * p - k) / s
    n = math.ceil(r) if ceil_mode else math.floor(r)
    out = n + 1
    if p > 0 and (out - 1) * s >= size + p:   # caffe clips the last window
        out -= 1
    return max(out, 1)


class CaffeGraphModule(KerasLayer):
    """The whole caffe net as one zoo layer."""

    def __init__(self, layers: List[proto.Msg], input_names: List[str],
                 output_names: List[str],
                 weights: Dict[str, List[np.ndarray]],
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.layers = layers
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.weights = weights
        self.num_outputs = len(output_names)
        # per layer: (type, blob keys), decoded once
        self._plan = [(_layer_type(layer),
                       [f"{i}/{j}" for j in range(len(
                           weights.get(layer.get("name", ""), [])))])
                      for i, layer in enumerate(layers)]

    def build(self, generator, input_shape):
        return {f"{i}/{j}": torch.from_numpy(np.array(b, np.float32))
                for i, layer in enumerate(self.layers)
                for j, b in enumerate(
                    self.weights.get(layer.get("name", ""), []))}

    def forward(self, inputs, training=False, **kw):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        env: Dict[str, Any] = dict(zip(self.input_names, inputs))
        for layer, (ltype, keys) in zip(self.layers, self._plan):
            bottoms = [env[b] for b in layer.get("bottom", [])]
            blobs = [getattr(self, k) for k in keys]
            tops = _apply_layer(ltype, layer, bottoms, blobs)
            for name, val in zip(layer.get("top", []), tops):
                env[name] = val
        outs = [env[n] for n in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        env = {n: tuple(s) for n, s in zip(self.input_names, shapes)}
        for layer in self.layers:
            ltype = _layer_type(layer)
            bshapes = [env[b] for b in layer.get("bottom", [])]
            tshapes = _infer_shapes(ltype, layer, bshapes,
                                    self.weights.get(layer.get("name", ""),
                                                     []))
            for name, s in zip(layer.get("top", []), tshapes):
                env[name] = s
        outs = [env[n] for n in self.output_names]
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# per-layer compute (the JAX layer's semantics, NCHW)
# ---------------------------------------------------------------------------

def _conv(layer, x, blobs, transpose=False):
    p = layer.get("convolution_param", {}) or {}
    kh, kw = _pair(p, "kernel_size", "kernel_h", "kernel_w", 1)
    sh, sw = _pair(p, "stride", "stride_h", "stride_w", 1)
    ph, pw = _pair(p, "pad", "pad_h", "pad_w", 0)
    dil = p.get("dilation") or [1]
    dh = dw = int(dil[0] if isinstance(dil, list) else dil)
    group = int(p.get("group") or 1)
    wb = blobs[0]
    if not transpose:
        w = wb.reshape(wb.shape[0], -1, kh, kw)     # (out, in/g, kh, kw)
        y = conv_explicit(x, w.to(x.dtype), (sh, sw), [(ph, ph), (pw, pw)],
                          (dh, dw), group)
    else:
        # (in, out, kh, kw) in blob layout; lax.conv_transpose without
        # transpose_kernel: a convolution over the stride-dilated input
        w = wb.reshape(wb.shape[0], -1, kh, kw).transpose(0, 1)
        n, c, h, wd = x.shape
        xd = x.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        y = conv_explicit(xd, w.to(x.dtype), (1, 1), [(ph, ph), (pw, pw)],
                          (dh, dw))
    if len(blobs) > 1:
        y = y + blobs[1].reshape(1, -1, 1, 1).to(y.dtype)
    return y


def _pool(layer, x):
    p = layer.get("pooling_param", {}) or {}
    if p.get("global_pooling"):
        if int(p.get("pool") or 0) == 1:
            return x.mean(dim=(2, 3), keepdim=True)
        return x.amax(dim=(2, 3), keepdim=True)
    kh, kw = _pair(p, "kernel_size", "kernel_h", "kernel_w", 1)
    sh, sw = _pair(p, "stride", "stride_h", "stride_w", 1)
    ph, pw = _pair(p, "pad", "pad_h", "pad_w", 0)
    ceil_mode = int(p.get("round_mode") or 0) == 0   # caffe default CEIL
    n, c, h, w = x.shape
    oh = _pool_out(h, kh, sh, ph, ceil_mode)
    ow = _pool_out(w, kw, sw, pw, ceil_mode)
    # pad right/bottom enough for ceil windows (clipped at apply time)
    need_h = (oh - 1) * sh + kh - h
    need_w = (ow - 1) * sw + kw - w
    flat = [pw, max(need_w - pw, 0), ph, max(need_h - ph, 0)]
    if int(p.get("pool") or 0) == 1:                 # AVE
        # the window's sum over the count of its image (not pad) elements
        s = F.avg_pool2d(F.pad(x, flat), (kh, kw), (sh, sw)) * (kh * kw)
        ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                device=x.device), flat)
        cnt = F.avg_pool2d(ones, (kh, kw), (sh, sw)) * (kh * kw)
        return s / torch.clamp(cnt, min=1.0)
    xp = F.pad(x, flat, value=float("-inf"))
    return F.max_pool2d(xp, (kh, kw), (sh, sw))


def _inner_product(layer, x, blobs):
    p = layer.get("inner_product_param", {}) or {}
    axis = int(p.get("axis") if p.get("axis") is not None else 1)
    axis = axis % x.dim()
    flat = x.reshape(tuple(x.shape[:axis]) + (-1,))
    w = blobs[0]                                    # (out, in)
    y = flat @ (w.t() if not p.get("transpose") else w).to(flat.dtype)
    if len(blobs) > 1:
        y = y + blobs[1].reshape(-1).to(y.dtype)
    return y


def _batch_norm(layer, x, blobs):
    p = layer.get("batch_norm_param", {}) or {}
    eps = float(p.get("eps") if p.get("eps") is not None else 1e-5)
    mean, var, sf = blobs[0], blobs[1], blobs[2]
    sf0 = sf.reshape(-1)[0]
    scale = torch.where(sf0 == 0, torch.zeros_like(sf0), 1.0 / sf0)
    shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
    mean = (mean * scale).reshape(shape)
    var = (var * scale).reshape(shape)
    return ((x - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _scale(layer, x, blobs, second=None):
    p = layer.get("scale_param", {}) or {}
    axis = int(p.get("axis") if p.get("axis") is not None else 1)
    axis = axis % x.dim()
    gamma = second if second is not None else blobs[0]
    shape = [1] * x.dim()
    for i, d in enumerate(gamma.shape):
        shape[axis + i] = int(d)
    y = x * gamma.reshape(shape).to(x.dtype)
    bias_idx = 0 if second is not None else 1
    if p.get("bias_term") and len(blobs) > bias_idx:
        y = y + blobs[bias_idx].reshape(shape).to(y.dtype)
    return y


def _lrn(layer, x):
    p = layer.get("lrn_param", {}) or {}
    size = int(p.get("local_size") or 5)
    alpha = float(p.get("alpha") if p.get("alpha") is not None else 1.0)
    beta = float(p.get("beta") if p.get("beta") is not None else 0.75)
    k = float(p.get("k") if p.get("k") is not None else 1.0)
    half = size // 2
    sq = x * x
    if int(p.get("norm_region") or 0) == 1:          # WITHIN_CHANNEL
        sqp = F.pad(sq, [half, size - 1 - half, half, size - 1 - half])
        s = F.avg_pool2d(sqp, size, 1)
        return x / torch.pow(k + alpha * s, beta)
    # ACROSS_CHANNELS: caffe normalizes by alpha/size * window-sum
    sqp = F.pad(sq.unsqueeze(1), [0, 0, 0, 0, half, size - 1 - half])
    s = sqp.unfold(2, size, 1).sum(-1).squeeze(1)
    return x / torch.pow(k + (alpha / size) * s, beta)


def _flatten(layer, x):
    p = layer.get("flatten_param", {}) or {}
    axis = int(p.get("axis") if p.get("axis") is not None else 1) % x.dim()
    end = int(p.get("end_axis") if p.get("end_axis") is not None else -1)
    end = end % x.dim()
    return x.reshape(tuple(x.shape[:axis]) + (-1,) +
                     tuple(x.shape[end + 1:]))


def _reshape(layer, x):
    p = layer.get("reshape_param", {}) or {}
    dims = [int(d) for d in (p.get("shape", {}) or {}).get("dim", [])]
    return x.reshape([x.shape[i] if d == 0 else d
                      for i, d in enumerate(dims)])


def _apply_layer(ltype, layer, bottoms, blobs):
    x = bottoms[0] if bottoms else None
    if ltype == "Convolution":
        return [_conv(layer, x, blobs)]
    if ltype == "Deconvolution":
        return [_conv(layer, x, blobs, transpose=True)]
    if ltype == "Pooling":
        return [_pool(layer, x)]
    if ltype == "InnerProduct":
        return [_inner_product(layer, x, blobs)]
    if ltype == "BatchNorm":
        return [_batch_norm(layer, x, blobs)]
    if ltype == "Scale":
        if len(bottoms) == 2:
            return [_scale(layer, x, blobs, second=bottoms[1])]
        return [_scale(layer, x, blobs)]
    if ltype == "ReLU":
        slope = float((layer.get("relu_param", {}) or {})
                      .get("negative_slope") or 0.0)
        return [torch.relu(x) if slope == 0.0
                else torch.where(x > 0, x, slope * x)]
    if ltype == "PReLU":
        a = blobs[0].reshape(-1)
        shape = [1] * x.dim()
        if a.numel() > 1 and x.dim() > 1:
            shape[1] = a.numel()
        return [torch.where(x > 0, x, a.reshape(shape).to(x.dtype) * x)]
    if ltype == "ELU":
        ep = layer.get("elu_param", {}) or {}
        alpha = float(ep.get("alpha") if ep.get("alpha") is not None
                      else 1.0)
        return [torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))]
    if ltype == "Sigmoid":
        return [torch.sigmoid(x)]
    if ltype == "TanH":
        return [torch.tanh(x)]
    if ltype == "AbsVal":
        return [torch.abs(x)]
    if ltype == "Power":
        p = layer.get("power_param", {}) or {}
        power = float(p.get("power") if p.get("power") is not None else 1.0)
        scale = float(p.get("scale") if p.get("scale") is not None else 1.0)
        shift = float(p.get("shift") if p.get("shift") is not None else 0.0)
        y = scale * x + shift
        return [y if power == 1.0 else torch.pow(y, power)]
    if ltype == "LRN":
        return [_lrn(layer, x)]
    if ltype in ("Softmax",):
        p = layer.get("softmax_param", {}) or {}
        axis = int(p.get("axis") if p.get("axis") is not None else 1)
        return [torch.softmax(x, dim=axis % x.dim())]
    if ltype == "Dropout":
        return [x]                                  # inference: identity
    if ltype == "Concat":
        p = layer.get("concat_param", {}) or {}
        axis = p.get("axis")
        if axis is None:
            axis = p.get("concat_dim", 1)
        return [torch.cat(bottoms, dim=int(axis) % bottoms[0].dim())]
    if ltype == "Eltwise":
        p = layer.get("eltwise_param", {}) or {}
        op = int(p.get("operation") if p.get("operation") is not None
                 else 1)
        if op == 0:
            y = bottoms[0]
            for b in bottoms[1:]:
                y = y * b
            return [y]
        if op == 2:
            y = bottoms[0]
            for b in bottoms[1:]:
                y = torch.maximum(y, b)
            return [y]
        coeff = [float(c) for c in (p.get("coeff") or [])] or \
            [1.0] * len(bottoms)
        y = bottoms[0] if coeff[0] == 1.0 else coeff[0] * bottoms[0]
        for c, b in zip(coeff[1:], bottoms[1:]):
            y = y + (b if c == 1.0 else c * b)
        return [y]
    if ltype == "Flatten":
        return [_flatten(layer, x)]
    if ltype == "Reshape":
        return [_reshape(layer, x)]
    if ltype == "Slice":
        p = layer.get("slice_param", {}) or {}
        axis = p.get("axis")
        if axis is None:
            axis = p.get("slice_dim", 1)
        axis = int(axis) % x.dim()
        points = [int(q) for q in (p.get("slice_point") or [])]
        n_top = len(layer.get("top", []))
        if not points:
            step = x.shape[axis] // n_top
            points = [step * (i + 1) for i in range(n_top - 1)]
        return list(torch.tensor_split(x, points, dim=axis))
    if ltype == "Split":
        return [x] * len(layer.get("top", []))
    raise NotImplementedError(f"caffe layer type {ltype!r} not supported")


# --- shape inference (mirrors _apply_layer; NCHW) -------------------------

def _infer_shapes(ltype, layer, bshapes, blobs):
    s = bshapes[0] if bshapes else None
    if ltype in ("Convolution", "Deconvolution"):
        p = layer.get("convolution_param", {}) or {}
        kh, kw = _pair(p, "kernel_size", "kernel_h", "kernel_w", 1)
        sh, sw = _pair(p, "stride", "stride_h", "stride_w", 1)
        ph, pw = _pair(p, "pad", "pad_h", "pad_w", 0)
        cout = int(p.get("num_output"))
        if None in (s[2], s[3]):
            return [(s[0], cout, None, None)]
        if ltype == "Convolution":
            oh = (s[2] + 2 * ph - kh) // sh + 1
            ow = (s[3] + 2 * pw - kw) // sw + 1
        else:
            oh = (s[2] - 1) * sh + kh - 2 * ph
            ow = (s[3] - 1) * sw + kw - 2 * pw
        return [(s[0], cout, oh, ow)]
    if ltype == "Pooling":
        p = layer.get("pooling_param", {}) or {}
        if p.get("global_pooling"):
            return [(s[0], s[1], 1, 1)]
        kh, kw = _pair(p, "kernel_size", "kernel_h", "kernel_w", 1)
        sh, sw = _pair(p, "stride", "stride_h", "stride_w", 1)
        ph, pw = _pair(p, "pad", "pad_h", "pad_w", 0)
        ceil_mode = int(p.get("round_mode") or 0) == 0
        return [(s[0], s[1], _pool_out(s[2], kh, sh, ph, ceil_mode),
                 _pool_out(s[3], kw, sw, pw, ceil_mode))]
    if ltype == "InnerProduct":
        p = layer.get("inner_product_param", {}) or {}
        axis = int(p.get("axis") if p.get("axis") is not None else 1)
        return [tuple(s[:axis]) + (int(p.get("num_output")),)]
    if ltype == "Concat":
        p = layer.get("concat_param", {}) or {}
        axis = p.get("axis")
        if axis is None:
            axis = p.get("concat_dim", 1)
        axis = int(axis) % len(bshapes[0])
        total = 0
        for bs in bshapes:
            if bs[axis] is None:
                total = None
                break
            total += bs[axis]
        out = list(bshapes[0])
        out[axis] = total
        return [tuple(out)]
    if ltype == "Flatten":
        p = layer.get("flatten_param", {}) or {}
        axis = int(p.get("axis") if p.get("axis") is not None else 1)
        end = int(p.get("end_axis") if p.get("end_axis") is not None
                  else -1) % len(s)
        mid = s[axis:end + 1]
        flat = None if any(d is None for d in mid) else int(np.prod(mid))
        return [tuple(s[:axis]) + (flat,) + tuple(s[end + 1:])]
    if ltype == "Slice":
        p = layer.get("slice_param", {}) or {}
        axis = p.get("axis")
        if axis is None:
            axis = p.get("slice_dim", 1)
        axis = int(axis) % len(s)
        n_top = len(layer.get("top", []))
        points = [int(q) for q in (p.get("slice_point") or [])]
        if not points:
            step = s[axis] // n_top
            points = [step * (i + 1) for i in range(n_top - 1)]
        bounds = [0] + points + [s[axis]]
        outs = []
        for i in range(n_top):
            o = list(s)
            o[axis] = bounds[i + 1] - bounds[i]
            outs.append(tuple(o))
        return outs
    if ltype == "Split":
        return [s] * len(layer.get("top", []))
    if ltype == "Reshape":
        p = layer.get("reshape_param", {}) or {}
        dims = [int(d) for d in (p.get("shape", {}) or {}).get("dim", [])]
        return [tuple(s[i] if d == 0 else (None if d == -1 else d)
                      for i, d in enumerate(dims))]
    # shape-preserving (activations, BN, Scale, LRN, Dropout, Softmax...)
    return [s] * max(len(layer.get("top", [])), 1)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

class CaffeLoader:
    """Parse and convert: ``CaffeLoader(def_path, model_path).to_model()``
    (``def_path`` None reads the layers from the caffemodel itself)."""

    def __init__(self, def_path: Optional[str], model_path: str):
        with open(model_path, "rb") as f:
            self.net_weights = proto.decode(f.read(), "NetParameter")
        if def_path is not None:
            with open(def_path) as f:
                self.net_def = parse_prototxt(f.read())
        else:
            self.net_def = self.net_weights

    @staticmethod
    def _layers(net: proto.Msg) -> List[proto.Msg]:
        return list(net.get("layer", [])) + list(net.get("layers", []))

    def to_model(self) -> Model:
        weights: Dict[str, List[np.ndarray]] = {}
        for layer in self._layers(self.net_weights):
            blobs = [proto.blob_to_numpy(b) for b in layer.get("blobs", [])]
            if blobs:
                weights[layer.get("name", "")] = blobs

        layers, input_names, input_shapes = [], [], []
        # net-level legacy inputs
        if self.net_def.get("input"):
            dims = [int(d) for d in self.net_def.get("input_dim", [])]
            shapes = self.net_def.get("input_shape", [])
            for i, n in enumerate(self.net_def["input"]):
                input_names.append(n)
                if shapes:
                    input_shapes.append(
                        tuple(int(d) for d in shapes[i]["dim"]))
                elif dims:
                    input_shapes.append(tuple(dims[4 * i:4 * i + 4]))
                else:
                    input_shapes.append(None)
        produced = set(input_names)
        for layer in self._layers(self.net_def):
            ltype = _layer_type(layer)
            if _train_only(layer):
                continue
            if ltype == "Input":
                shapes = (layer.get("input_param", {}) or {}).get("shape",
                                                                  [])
                for i, top in enumerate(layer.get("top", [])):
                    input_names.append(top)
                    produced.add(top)
                    input_shapes.append(
                        tuple(int(d) for d in shapes[min(i, len(shapes)
                                                         - 1)]["dim"])
                        if shapes else None)
                continue
            if ltype == "SoftmaxWithLoss":
                # deploy conversion: loss head -> Softmax over the logits
                layer = proto.Msg(layer)
                layer["type"] = "Softmax"
                layer["bottom"] = layer.get("bottom", [])[:1]
                ltype = "Softmax"
            if ltype in _SKIP_TYPES:
                continue
            layers.append(layer)
            produced.update(layer.get("top", []))

        consumed = set()
        for layer in layers:
            for b in layer.get("bottom", []):
                if b not in layer.get("top", []):   # in-place doesn't count
                    consumed.add(b)
        output_names = [t for layer in layers for t in layer.get("top", [])
                        if t not in consumed]
        # dedup, keep order
        output_names = list(dict.fromkeys(output_names))

        module = CaffeGraphModule(layers, input_names, output_names,
                                  weights,
                                  name=self.net_def.get("name") or
                                  "caffe_net")
        ins = []
        for n, s in zip(input_names, input_shapes):
            shape = tuple(s[1:]) if s else (None,)
            ins.append(Input(shape=shape, name=n))
        outs = module(ins if len(ins) > 1 else ins)
        outs = list(outs) if isinstance(outs, tuple) else [outs]
        return Model(ins, outs if len(outs) > 1 else outs[0])


def load_caffe(def_path: Optional[str], model_path: str) -> Model:
    """``Net.load_caffe`` backend (net_load.py parity)."""
    return CaffeLoader(def_path, model_path).to_model()
