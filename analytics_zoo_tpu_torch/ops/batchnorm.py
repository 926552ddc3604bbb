"""Batch norm in training mode with the JAX op's outputs and backward.

Counterpart of ``analytics_zoo_tpu/ops/batchnorm.py``. The arithmetic is
PyTorch's own fused batch norm (``torch.native_batch_norm`` and its
backward: one statistics pass and one normalize pass each way), with the
moments accumulated in float32 whatever the input dtype, as the JAX op
does. It runs on x viewed as (rows, channels), the channel innermost:
free for channels-last memory (what the convolutions leave on the card,
``ops/conv.py``) and for "tf" layouts, a copy in and out otherwise (y
and dx come back in x's memory format). On the card
that view takes PyTorch's channels-last kernels, which are the faster
ones and the accurate ones: for bf16 inputs in NCHW memory its fused
backward rounds dgamma and dbeta through bf16 (``chip_smoke.py``'s
``resnet`` step check reads it per layer).

What the layer needs beyond that op is done here:

- the batch moments come back as outputs, ``(y, mean, var)`` with the
  **biased** variance recovered from the op's saved ``1/sqrt(var + eps)``
  (clamped at 0, as the JAX op clamps its one-pass variance), so the
  caller folds them into its moving statistics itself;
- the backward is the same closed form as JAX's ``_bn_bwd_rule``
  (``dbeta = sum(dy)``, ``dgamma = sum(dy * xhat)``,
  ``dx = gamma * inv * (dy - mean(dy) - xhat * mean(dy * xhat))``), plus
  the terms of the mean and variance outputs' cotangents when they
  arrive (the moving statistics are not differentiated, so on the
  training path they do not).

The moments differ from the JAX op's one-pass ``E[x^2] - mean^2`` by
float32 rounding only (PyTorch takes them in a Welford pass). There is
no cross-replica sum at world size 1.

``torch.nn.functional.batch_norm`` is not used for the statistics: its
running variance is the unbiased one and its momentum is ``1 - m``.
"""

from __future__ import annotations

import torch


def _accumulation_dtype(x):
    """float32 for float32 and narrower inputs, float64 for float64."""
    return torch.promote_types(x.dtype, torch.float32)


def _rows(t, axis):
    """``t`` as (rows, channels) with the channel ``axis`` innermost."""
    t = t.movedim(axis, -1)
    return t.contiguous().reshape(-1, t.shape[-1])


def _unrows(r, like, axis):
    """(rows, channels) back to ``like``'s shape and memory format."""
    t = r.reshape(like.movedim(axis, -1).shape).movedim(-1, axis)
    if t.stride() == like.stride():
        return t
    return torch.empty_like(like, dtype=r.dtype).copy_(t)


def batch_norm_train(x, gamma, beta, axis, eps):
    """Training-mode batch norm over all axes but ``axis``.

    Returns ``(y, mean, var)``: y in x.dtype, the f32 batch moments (the
    biased variance), which the caller folds into its moving
    statistics."""
    return _BatchNormTrain.apply(x, gamma, beta, axis, eps)


class _BatchNormTrain(torch.autograd.Function):
    """Saves (x, gamma, mean, 1/sqrt(var + eps))."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axis, eps):
        acc = _accumulation_dtype(x)
        y, mean, inv = torch.native_batch_norm(
            _rows(x, axis), gamma.to(acc), beta.to(acc), None, None, True,
            0.0, eps)
        var = torch.clamp(inv.reciprocal().square() - eps, min=0.0)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axis, ctx.eps = axis, eps
        ctx.set_materialize_grads(False)
        return _unrows(y, x, axis), mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        xr = _rows(x, ctx.axis)
        dyr = torch.zeros_like(xr) if dy is None else _rows(dy, ctx.axis)
        dx, dgamma, dbeta = torch.ops.aten.native_batch_norm_backward(
            dyr, xr, gamma.to(_accumulation_dtype(x)), None, None, mean, inv,
            True, ctx.eps, [True, True, True])
        if dmean is not None or dvar is not None:
            # d mean/dx = 1/n; d var/dx = 2 (x - mean)/n
            n = xr.shape[0]
            dxf = dx.to(mean.dtype)
            if dmean is not None:
                dxf = dxf + dmean / n
            if dvar is not None:
                dxf = dxf + (dvar * 2.0 / n) * (xr.to(mean.dtype) - mean)
            dx = dxf.to(x.dtype)
        return (_unrows(dx, x, ctx.axis), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def batch_norm_inference(x, gamma, beta, mean, var, axis, eps):
    """Inference-mode normalize with given (moving) statistics: the scale
    and shift fold into per-channel f32 constants, then one elementwise
    pass. y in x.dtype."""
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    inv = torch.rsqrt(var.float() + eps)
    scale = gamma.float() * inv
    shift = beta.float() - mean.float() * scale
    return (x.float() * scale.reshape(bshape) +
            shift.reshape(bshape)).to(x.dtype)
