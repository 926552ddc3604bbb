"""Layer norm with single-pass f32 statistics and a hand-written backward.

Counterpart of ``analytics_zoo_tpu/ops/layernorm.py``. The mean and
variance come from one pass over the row — sum and sum of squares,
accumulated in f32 — with ``var = max(E[x^2] - mean^2, 0)``, exactly as
the JAX op computes them. ``torch.nn.functional.layer_norm`` uses a
two-pass variance and is deliberately not used. The backward is the JAX
op's ``_ln_bwd_rule`` (:class:`_LayerNorm`), in plain torch: the TPU
package has no kernel here.

Parity: LayerNorm.scala / InternalLayerNorm.scala (hidden_size, epsilon).
"""

from __future__ import annotations

import torch


def layer_norm(x, gamma, beta, eps=1e-5):
    """Normalize over the last axis; gamma/beta shaped (features,).
    Returns y in x.dtype; statistics accumulate in f32."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _ln_fwd_impl(x, gamma, beta, eps)[0]


def _ln_fwd_impl(x, gamma, beta, eps):
    n = x.shape[-1]
    xf = x.float()
    s1 = xf.sum(dim=-1, keepdim=True)
    s2 = (xf * xf).sum(dim=-1, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    y = (xhat * gamma.float() + beta.float()).to(x.dtype)
    return y, mean, inv


class _LayerNorm(torch.autograd.Function):
    """Saves (x, gamma, mean, inv); the backward is ``_ln_bwd_rule``: one
    reduce over (dy, x) for dgamma/dbeta and one elementwise pass for
    dx."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, inv = _ln_fwd_impl(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, inv = ctx.saved_tensors
        n = x.shape[-1]
        xhat = (x.float() - mean) * inv
        dyf = dy.float()
        dgamma = (dyf * xhat).reshape(-1, n).sum(dim=0)
        dbeta = dyf.reshape(-1, n).sum(dim=0)
        dg = dyf * gamma.float()
        m1 = dg.mean(dim=-1, keepdim=True)
        m2 = (dg * xhat).mean(dim=-1, keepdim=True)
        dx = inv * (dg - m1 - xhat * m2)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)
