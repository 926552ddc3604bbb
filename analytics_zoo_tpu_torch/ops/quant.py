"""Int8 quantization ops: weight-only PTQ, activation-calibrated int8
compute, and fused requantization chains.

Counterpart of ``analytics_zoo_tpu/ops/quant.py`` (the compute half of
the reference's OpenVINO int8 pipeline,
``OpenVinoInferenceSupportive.scala:151-343``):

- weights: int8 per-output-channel symmetric (max-abs / 127), quantized
  in numpy exactly as the JAX package does (:func:`quantize_weight`);
- activations: a per-tensor symmetric scale learned from a calibration
  set (:class:`calibrating` records max-abs during an eager replay).
  With both scales a matmul or convolution runs ``int8 x int8 ->
  int32``: on the card through ``torch._int_mm`` (cuBLASLt's integer
  product on the tensor cores), on the CPU as an int32 matmul, its
  plain version. CUDA has no integer ``torch.matmul`` and no int8
  im2col, so a convolution gathers its int8 patches with a strided view
  and one copy (:func:`_im2col`) and runs as one integer product;
- requantization chains: when the chain planner sets ``requant`` on a
  kernel, the epilogue stays in the integer domain -- the bias folded
  into the int32 accumulator, relu on int32, and one per-channel
  multiply ``requant = act_scale * w_scale / next_act_scale`` rescaling
  int32 straight to the next layer's int8 input. A fully chained
  forward divides once, at the chain entry.

``torch._int_mm`` on the card takes more than 16 rows, inner and output
sizes that are multiples of 8, and the second operand column-major
(checked on an H100 with PyTorch 2.11): the product pads its operands
to those sizes with zeros and never falls back to a float product.
Rounding is half to even, as ``jnp.round``; ``x / act_scale`` is a
division by a tensor on x's device (PyTorch turns a division by a host
scalar into a multiply by its reciprocal on the card, which can round
differently), so the int8 values equal the JAX package's.

Layers route their bias and activation INTO :func:`matmul` /
:func:`conv2d` so the op owns the epilogue; a float kernel passes
straight through with the unquantized layer's semantics.
``QuantizedModel`` supplies a layer's quantized kernel for one forward
through :class:`layer_kernels` (read by :func:`kernel_of`), so the
caller's float model is left as it was.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .conv import channels_first, conv_general_dilated, pad_spatial, \
    same_pads

__all__ = ["QuantTensor", "quantize_weight", "matmul", "conv2d",
           "calibrating", "calibration_scales", "out_key",
           "chain_requant", "quantize_rows", "dequantize_rows",
           "layer_kernels", "kernel_of", "int_product"]

#: ``torch._int_mm``'s rules on the card: rows above 16, inner and
#: output sizes multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def _round_up(n, m):
    return -(-n // m) * m


class QuantTensor:
    """int8 weights + f32 per-out-channel scale, plus the calibration /
    chain metadata; a plain holder of tensors on one device (``to``
    moves them). ``name`` is the JAX param path -- the calibration key.

    - ``act_scale``: per-tensor scale of the layer's f32 INPUT (a 0-dim
      float32 tensor, set after calibration).
    - ``out_scale``: per-tensor scale of the layer's f32 OUTPUT.
    - ``requant``: per-out-channel int32 -> int8 multiplier
      ``act_scale * w_scale / next_layer_act_scale``; when set, the op
      emits int8.
    - ``qbias``: the bias pre-quantized into the int32 accumulator
      domain (``round(bias / (act_scale * w_scale))``).

    ``gemm`` holds the kernel as the integer product's second operand:
    (out, k) with k = the kernel's leading dims flattened (Dense: in;
    HWIO: kh * kw * in), both padded with zeros to a multiple of 8, made
    once per kernel and shared by the ``with_*`` copies."""

    def __init__(self, q, scale, act_scale=None, name: str = "",
                 out_scale=None, requant=None, qbias=None, gemm=None):
        self.q = torch.as_tensor(q)
        self.scale = torch.as_tensor(scale)
        self.act_scale = act_scale
        self.name = name
        self.out_scale = out_scale
        self.requant = requant
        self.qbias = qbias
        self._gemm = gemm

    def dequantize(self):
        return self.q.float() * self.scale

    @property
    def gemm(self):
        if self._gemm is None:
            out = self.q.shape[-1]
            k = self.q.numel() // out
            g = torch.zeros((_round_up(out, INT_MM_MULTIPLE),
                             _round_up(k, INT_MM_MULTIPLE)),
                            dtype=torch.int8, device=self.q.device)
            g[:out, :k] = self.q.reshape(k, out).t()
            self._gemm = g
        return self._gemm

    def _replace(self, **kw):
        fields = dict(q=self.q, scale=self.scale, act_scale=self.act_scale,
                      name=self.name, out_scale=self.out_scale,
                      requant=self.requant, qbias=self.qbias,
                      gemm=self._gemm)
        fields.update(kw)
        return QuantTensor(**fields)

    def _tensor(self, v, dtype):
        return None if v is None else \
            torch.as_tensor(np.asarray(v), dtype=dtype).to(self.q.device)

    def with_act_scale(self, act_scale) -> "QuantTensor":
        return self._replace(act_scale=self._tensor(
            np.float32(act_scale), torch.float32))

    def with_out_scale(self, out_scale) -> "QuantTensor":
        return self._replace(out_scale=self._tensor(
            np.float32(out_scale), torch.float32))

    def with_requant(self, requant) -> "QuantTensor":
        return self._replace(requant=self._tensor(requant, torch.float32))

    def with_qbias(self, qbias) -> "QuantTensor":
        return self._replace(qbias=None if qbias is None else
                             self._tensor(np.asarray(qbias, np.int32),
                                          torch.int32))

    def to(self, device) -> "QuantTensor":
        def move(v):
            return None if v is None else v.to(device)

        return QuantTensor(move(self.q), move(self.scale),
                           move(self.act_scale), self.name,
                           move(self.out_scale), move(self.requant),
                           move(self.qbias), move(self._gemm))

    def nbytes(self) -> int:
        """Bytes of the int8 kernel and its scale."""
        return self.q.numel() + 4 * self.scale.numel()


def quantize_weight(w, name: str = "") -> QuantTensor:
    """Symmetric per-output-channel int8 (last dim = output channels),
    computed in numpy as the JAX package does; the tensors land on the
    CPU (``QuantTensor.to`` moves them)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w)
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)),
                   keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return QuantTensor(torch.from_numpy(q), torch.from_numpy(scale), None,
                       name)


def quantize_rows(x, axis: int = -1):
    """Symmetric per-row int8 for *dynamic* tensors (KV-cache rows).

    Each slice along every axis but ``axis`` gets its own max-abs/127
    scale, so a single outlier token cannot flatten the resolution of its
    neighbours. Returns ``(q int8, scale f32)`` with ``axis`` kept as a
    size-1 dim on the scale so ``q * scale`` broadcasts back. Rounding is
    half to even, as ``jnp.round``."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-12).float() / 127.0
    q = torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scale):
    """Inverse of :func:`quantize_rows`: int8 rows back to f32."""
    return q.float() * scale


def chain_requant(act_scale, w_scale, next_act_scale) -> np.ndarray:
    """Concrete per-out-channel int32 -> int8 requantize multiplier,
    computed at chain-plan time so the forward holds no division on the
    requantize path."""
    if isinstance(w_scale, torch.Tensor):
        w_scale = w_scale.detach().cpu().numpy()
    return (float(act_scale) * np.asarray(w_scale, np.float64).reshape(-1)
            / float(next_act_scale)).astype(np.float32)


def out_key(name: str) -> str:
    """Recorder key for a kernel's calibrated OUTPUT range."""
    return name + "::out"


# -- calibration recorder ----------------------------------------------

class _Recorder(threading.local):
    def __init__(self):
        self.active = False
        self.ranges = {}


_recorder = _Recorder()


class calibrating:
    """Context manager: record max-abs of every activation that feeds a
    QuantTensor matmul/conv -- and of every such layer's OUTPUT --
    during an eager replay of the model. Each record reads one scalar
    from the device."""

    def __enter__(self):
        _recorder.active = True
        _recorder.ranges = {}
        return _recorder.ranges

    def __exit__(self, *exc):
        _recorder.active = False
        return False


def calibration_scales(ranges: dict) -> dict:
    """max-abs -> symmetric per-tensor scale."""
    return {k: max(v, 1e-12) / 127.0 for k, v in ranges.items()}


# -- the kernels a forward uses ----------------------------------------

_kernels = threading.local()


class layer_kernels:
    """Context manager: inside it, on this thread, :func:`kernel_of`
    hands each layer in ``mapping`` (layer -> QuantTensor or tensor) that
    kernel instead of its own parameter."""

    def __init__(self, mapping):
        self.mapping = mapping

    def __enter__(self):
        self._prev = getattr(_kernels, "mapping", None)
        _kernels.mapping = self.mapping
        return self

    def __exit__(self, *exc):
        _kernels.mapping = self._prev
        return False


def kernel_of(layer):
    """The kernel ``layer`` computes with: the one :class:`layer_kernels`
    supplies on this thread, else its ``kernel`` parameter."""
    mapping = getattr(_kernels, "mapping", None)
    if mapping:
        w = mapping.get(layer)
        if w is not None:
            return w
    return layer.kernel


# -- the ops -----------------------------------------------------------

def _record_range(x, name):
    """Eager calibration replay: fold this tensor's max-abs into the
    recorder entry for ``name``."""
    seen = float(x.detach().abs().max()) if x.numel() else 0.0
    prev = _recorder.ranges.get(name, 0.0)
    _recorder.ranges[name] = max(prev, seen)


def _quantize_act(x, act_scale):
    """Symmetric per-tensor int8 quantization with the calibrated scale.
    This is the ONLY activation division on a requantization chain -- it
    runs once at chain entry; int8 inputs pass straight through."""
    return torch.clamp(torch.round(x / act_scale), -127, 127).to(torch.int8)


def _f32_epilogue(y, bias, activation):
    """The unquantized layer epilogue, verbatim."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if activation is not None:
        y = activation(y)
    return y


def _is_relu(activation) -> bool:
    return getattr(activation, "name", None) == "relu"


def _chainable_act(activation) -> bool:
    """Activations the integer epilogue can absorb: none, or relu
    (max(x, 0) commutes with the positive requantize scale)."""
    return activation is None or _is_relu(activation)


def _fold_bias_i32(acc, w, bias, combined):
    """Fold the bias into the int32 accumulator domain:
    ``round(bias / (act_scale * w_scale[c]))`` per output channel (the
    channel is ``acc``'s last dim) -- taken from the precomputed
    ``w.qbias`` when the planner set it (no division in the forward),
    else derived inline."""
    qb = w.qbias
    if qb is None:
        if bias is None:
            return acc
        qb = torch.round(bias / combined).to(torch.int32)
    return acc + qb


def _requantize(acc, requant, activation):
    """int32 accumulator -> next layer's int8 input: optional relu in
    the integer domain, then one per-channel multiply + round + clamp."""
    if _is_relu(activation):
        acc = torch.clamp_min(acc, 0)
    return torch.clamp(torch.round(acc.float() * requant),
                       -127, 127).to(torch.int8)


def int_product(a, w: QuantTensor):
    """``a @ kernel`` with int32 accumulation: ``a`` int8 (m, k) with k
    the kernel's flattened input size or ``w.gemm``'s padded one.
    On the card one ``torch._int_mm`` on operands padded to its rules;
    on the CPU its plain version, an int32 matmul. Returns (m, out)
    int32."""
    g = w.gemm
    out = w.q.shape[-1]
    m, k = a.shape
    kp = g.shape[1]
    if a.is_cuda:
        rows = max(m, INT_MM_MIN_ROWS)
        if rows != m or k != kp:
            padded = torch.zeros((rows, kp), dtype=torch.int8,
                                 device=a.device)
            padded[:m, :k] = a
            a = padded
        acc = torch._int_mm(a, g.t())
        return acc[:m, :out]
    return torch.matmul(a.to(torch.int32),
                        g[:out, :k].t().to(torch.int32))


def _im2col(x, window, strides, dilation, k_padded):
    """Patches of ``x`` (int8, (N, C, H, W) view in any memory layout,
    already padded) as an (N * OH * OW, k_padded) int8 matrix, each row
    one output position's window in (kh, kw, C) order -- the HWIO
    kernel's flattened order -- zero past kh * kw * C. One strided view
    and one copy; no float round trip."""
    n, c, h, w_ = x.shape
    (kh, kw), (sh, sw), (dh, dw) = window, strides, dilation
    oh = (h - (kh - 1) * dh - 1) // sh + 1
    ow = (w_ - (kw - 1) * dw - 1) // sw + 1
    s_n, s_c, s_h, s_w = x.stride()
    patches = x.as_strided((n, oh, ow, kh, kw, c),
                           (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw,
                            s_c), x.storage_offset())
    k = kh * kw * c
    cols = torch.empty((n * oh * ow, k_padded), dtype=torch.int8,
                       device=x.device)
    if k_padded != k:
        cols[:, k:].zero_()
    cols[:, :k].view(n, oh, ow, kh, kw, c).copy_(patches)
    return cols, (n, oh, ow)


def matmul(x, w, bias=None, activation=None):
    """``activation(x @ w + bias)`` where ``w`` may be float, a
    weight-only QuantTensor, or a calibrated QuantTensor (true int8
    compute, optionally emitting int8 for the next chained layer)."""
    if not isinstance(w, QuantTensor):
        return _f32_epilogue(torch.matmul(x, w.to(x.dtype)), bias,
                             activation)
    if _recorder.active:
        _record_range(x, w.name)
        y = _f32_epilogue(torch.matmul(x, w.dequantize()), bias,
                          activation)
        _record_range(y, out_key(w.name))
        return y
    if w.act_scale is None or w.q.dim() != 2:
        return _f32_epilogue(torch.matmul(x, w.dequantize()), bias,
                             activation)
    # calibrated int8 path: int8 inputs arrive pre-quantized from the
    # upstream chain link; f32 inputs quantize once at chain entry
    xq = x if x.dtype == torch.int8 else _quantize_act(x, w.act_scale)
    lead = xq.shape[:-1]
    acc = int_product(xq.reshape(-1, xq.shape[-1]), w)
    acc = acc.reshape(tuple(lead) + (acc.shape[-1],))
    combined = w.act_scale * w.scale.reshape(-1)  # (out,)
    acc = _fold_bias_i32(acc, w, bias, combined)
    if w.requant is not None and _chainable_act(activation):
        return _requantize(acc, w.requant, activation)
    y = acc.float() * combined
    return y if activation is None else activation(y)


def _conv_int8(xq, w, window_strides, padding, rhs_dilation,
               dimension_numbers):
    """The int32 accumulator of the int8 convolution of ``xq`` with the
    HWIO int8 kernel ``w.q``, as (N, OH, OW, out) -- the channel last,
    whatever the layout."""
    lhs = dimension_numbers[0]
    kh, kw = w.q.shape[:2]
    strides = tuple(window_strides)
    dilation = tuple(rhs_dilation or (1, 1))
    xc = channels_first(xq, lhs)
    if padding == "SAME":
        xc = pad_spatial(xc, same_pads(xc.shape[2:], (kh, kw), strides,
                                       dilation))
    cols, (n, oh, ow) = _im2col(xc, (kh, kw), strides, dilation,
                                w.gemm.shape[1])
    acc = int_product(cols, w)
    return acc.view(n, oh, ow, acc.shape[-1])


def conv2d(x, w, window_strides, padding, rhs_dilation, dimension_numbers,
           bias=None, activation=None):
    """``activation(conv(x, w) + bias)`` where ``w`` may be float (HWIO),
    a weight-only QuantTensor, or a calibrated QuantTensor (int8
    convolution, int32 accumulation). ``bias`` is the raw (out,) vector;
    ``padding`` "SAME" or "VALID" (``ops/conv.py``). The float path casts
    the kernel to x's dtype and adds the bias in the output's dtype on
    its feature axis (``_f32_epilogue``)."""
    channel_axis = dimension_numbers[2].index("C")

    def f32_path(kernel):
        y = conv_general_dilated(x, kernel.to(x.dtype), window_strides,
                                 padding, rhs_dilation, dimension_numbers)
        return f32_epilogue(y, bias, activation, channel_axis)

    if not isinstance(w, QuantTensor):
        return f32_path(w)
    if _recorder.active:
        _record_range(x, w.name)
        y = f32_path(w.dequantize())
        _record_range(y, out_key(w.name))
        return y
    if w.act_scale is None or w.q.dim() != 4:
        return f32_path(w.dequantize())
    xq = x if x.dtype == torch.int8 else _quantize_act(x, w.act_scale)
    acc = _conv_int8(xq, w, window_strides, padding, rhs_dilation,
                     dimension_numbers)
    combined = w.act_scale * w.scale.reshape(-1)
    acc = _fold_bias_i32(acc, w, bias, combined)

    def to_layout(y):   # (N, OH, OW, C) -> the output layout, a view
        return y.permute(0, 3, 1, 2) if channel_axis == 1 else y

    if w.requant is not None and _chainable_act(activation):
        return to_layout(_requantize(acc, w.requant, activation))
    y = to_layout(acc.float() * combined)
    return y if activation is None else activation(y)


def f32_epilogue(y, bias, activation, channel_axis):
    """The unquantized layer epilogue: the (out,) ``bias`` added in y's
    dtype on ``channel_axis``, then ``activation``."""
    if bias is not None:
        shape = [1] * y.dim()
        shape[channel_axis] = bias.shape[0]
        y = y + bias.to(y.dtype).reshape(shape)
    return activation(y) if activation is not None else y
