"""Int8 quantization ops.

Counterpart of ``analytics_zoo_tpu/ops/quant.py``. Only the per-row
scheme of dynamic tensors comes over (:func:`quantize_rows`,
:func:`dequantize_rows`), which the int8 KV-cache slabs of
``ops/kv_cache.py`` store. ``QuantTensor``, the weight quantizer, the
int8 matmul and convolution and the calibration recorder wait for
``QuantizedModel``.
"""

from __future__ import annotations

import torch


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
