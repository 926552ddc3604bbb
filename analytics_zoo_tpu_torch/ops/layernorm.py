"""Layer norm with single-pass f32 statistics.

Counterpart of ``analytics_zoo_tpu/ops/layernorm.py`` (forward). The mean
and variance come from one pass over the row — sum and sum of squares,
accumulated in f32 — with ``var = max(E[x^2] - mean^2, 0)``, exactly as
the JAX op computes them. ``torch.nn.functional.layer_norm`` uses a
two-pass variance and is deliberately not used. The backward arrives with
the training slice.

Parity: LayerNorm.scala / InternalLayerNorm.scala (hidden_size, epsilon).
"""

from __future__ import annotations

import torch


def layer_norm(x, gamma, beta, eps=1e-5):
    """Normalize over the last axis; gamma/beta shaped (features,).
    Returns y in x.dtype; statistics accumulate in f32."""
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
