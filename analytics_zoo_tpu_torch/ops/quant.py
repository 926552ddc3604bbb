"""Int8 quantization ops.

Counterpart of ``analytics_zoo_tpu/ops/quant.py``. Only the per-row
scheme of dynamic tensors comes over (:func:`quantize_rows`,
:func:`dequantize_rows`), which the int8 KV-cache slabs of
``ops/kv_cache.py`` store, and the float path of :func:`conv2d`, the
convolution layers' op. ``QuantTensor``, the weight quantizer, the
int8 matmul and convolution and the calibration recorder wait for
``QuantizedModel`` (ROADMAP A10).
"""

from __future__ import annotations

import torch

from .conv import conv_general_dilated

_QUANTIZED = ("int8 convolution kernels (QuantTensor) are not ported yet; "
              "they arrive with QuantizedModel (ROADMAP A10)")


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


def conv2d(x, w, window_strides, padding, rhs_dilation, dimension_numbers,
           bias=None, activation=None):
    """``activation(conv(x, w) + bias)``: the float path of the JAX op,
    the kernel cast to x's dtype and the (out,) bias added in the
    output's dtype on its feature axis (``_f32_epilogue``). ``w`` is HWIO;
    ``padding`` "SAME" or "VALID" (``ops/conv.py``)."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(_QUANTIZED)
    y = conv_general_dilated(x, w.to(x.dtype), window_strides, padding,
                             rhs_dilation, dimension_numbers)
    return f32_epilogue(y, bias, activation,
                        dimension_numbers[2].index("C"))


def f32_epilogue(y, bias, activation, channel_axis):
    """The unquantized layer epilogue: the (out,) ``bias`` added in y's
    dtype on ``channel_axis``, then ``activation``."""
    if bias is not None:
        shape = [1] * y.dim()
        shape[channel_axis] = bias.shape[0]
        y = y + bias.to(y.dtype).reshape(shape)
    return activation(y) if activation is not None else y
