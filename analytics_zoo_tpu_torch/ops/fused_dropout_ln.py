"""Dropout + residual add + layer norm.

Counterpart of ``analytics_zoo_tpu/ops/fused_dropout_ln.py``, composed
path only: ``layer_norm(dropout(x) + resid)``. On the TPU the training
case runs a fused Pallas kernel pair (``_dln_fwd_kernel`` and
``_dln_bwd_kernel``); those come with the training slice. With
``training=False`` (the serving path) the JAX op returns the composed
``layer_norm(x + resid)`` too, so no kernel is on this path.

Dropout draws a Bernoulli keep-mask from an explicit ``torch.Generator``.
The stream differs from ``jax.random.bernoulli``: tests compare with
dropout off.
"""

from __future__ import annotations

import torch

from .layernorm import layer_norm


def dropout_add_layer_norm(x, resid, gamma, beta, generator, p_drop,
                           training=True, eps=1e-5):
    """``layer_norm(dropout(x, p_drop) + resid)``; x, resid: (..., D),
    gamma/beta: (D,). ``generator`` is the ``torch.Generator`` the
    dropout mask draws from (None or ``training=False`` disables
    dropout), on x's device."""
    if not training or generator is None or p_drop <= 0.0:
        return layer_norm(x + resid, gamma, beta, eps)
    keep = 1.0 - float(p_drop)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    dropped = torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
    return layer_norm(dropped + resid, gamma, beta, eps)
