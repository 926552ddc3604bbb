"""Fused dropout + residual add + layer norm.

Counterpart of ``analytics_zoo_tpu/ops/fused_dropout_ln.py``. In training
with ``0 < p_drop < 1`` the op runs the fused kernel pair
(``csrc/dropout_ln.cu``: ``dln_fwd`` and ``dln_bwd``, the ports of the TPU
kernels ``_dln_fwd_kernel`` and ``_dln_bwd_kernel``) through
:class:`_DropoutAddLayerNorm`. With ``training=False`` (the serving path)
it returns the composed ``layer_norm(x + resid)``, as the JAX op does, so
no kernel runs there.

Dropout thresholds raw 32-bit random words, ``keep = bits < keep * 2**32``
(``_thresh``), as the TPU kernel does. The words are drawn from the
explicit ``torch.Generator`` on x's device over the full 2**32 range and
stored as int32 holding the uint32 bit pattern (torch's uint32 coverage
is thin); the kernel reads them as uint32 and the plain versions compare
through int64. The stream differs from ``jax.random.bits``: tests feed
both sides the same bits.

Each wrapper (:func:`dln_forward`, :func:`dln_backward`) launches its
kernel on CUDA tensors and runs its plain version
(:func:`dln_forward_reference`, :func:`dln_backward_reference`) only on
CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .layernorm import layer_norm

FWD_KERNEL_NAME = "dln_fwd"
BWD_KERNEL_NAME = "dln_bwd"
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the kernels hold a row in one warp's registers, 32 values a lane at most
KERNEL_MAX_D = 1024


def _thresh(keep: float) -> int:
    # keep in (0, 1); 2^32 * keep never overflows to 0 because p > 0
    return min(int(keep * 2.0 ** 32), 2 ** 32 - 1)


def draw_bits(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform 32-bit words over the full 2**32 range from ``generator``,
    as int32 holding the uint32 bit pattern."""
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def _keep_mask(bits2, keep) -> torch.Tensor:
    """bits < thresh on the words read as uint32."""
    return (bits2.to(torch.int64) & 0xFFFFFFFF) < _thresh(keep)


# ---------------------------------------------------------------------------
# plain versions (the test oracle; the wrappers' CPU route)
# ---------------------------------------------------------------------------

def dln_forward_reference(x2, r2, bits2, gamma, beta, keep, eps
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``dln_fwd``, exactly ``_dln_fwd_kernel``:
    z = (mask ? x * (1/keep) : 0) + resid in f32, single-pass statistics
    var = max(E[z^2] - mean^2, 0), y in x's dtype. Returns y, z (in x's
    dtype), mean and inv ((N, 1) f32)."""
    d = x2.shape[-1]
    z = torch.where(_keep_mask(bits2, keep), x2.float() * (1.0 / keep),
                    0.0) + r2.float()
    mean = z.sum(dim=-1, keepdim=True) / d
    var = torch.clamp((z * z).sum(dim=-1, keepdim=True) / d - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    y = (z - mean) * inv * gamma.float() + beta.float()
    return y.to(x2.dtype), z.to(x2.dtype), mean, inv


def dln_backward_reference(dy2, z2, bits2, gamma, mean, inv, keep
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``dln_bwd``, exactly ``_dln_bwd_kernel``
    with its per-block dgamma/dbeta partials summed: returns dx, dres (in
    dy's dtype) and dgamma, dbeta ((D,) f32)."""
    dy = dy2.float()
    xhat = (z2.float() - mean) * inv
    dg = dy * gamma.float()
    m1 = dg.mean(dim=-1, keepdim=True)
    m2 = (dg * xhat).mean(dim=-1, keepdim=True)
    dz = inv * (dg - m1 - xhat * m2)
    dx = torch.where(_keep_mask(bits2, keep), dz * (1.0 / keep), 0.0)
    return (dx.to(dy2.dtype), dz.to(dy2.dtype), (dy * xhat).sum(dim=0),
            dy.sum(dim=0))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, t, n, d, dtype, device):
    if t.shape != (n, d) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be ({n}, {d}) {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_common(x2, bits2, gamma, keep):
    if x2.dim() != 2:
        raise ValueError("dropout+add+layer-norm takes (N, D) rows")
    n, d = x2.shape
    if x2.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dropout+add+layer-norm takes float32 or bfloat16, "
                         f"got {x2.dtype}")
    if not 1 <= d <= KERNEL_MAX_D or n < 1:
        raise ValueError(f"dropout+add+layer-norm takes 1 <= D <= "
                         f"{KERNEL_MAX_D} and N >= 1, got ({n}, {d})")
    if not 0.0 < keep < 1.0:
        raise ValueError(f"keep must lie in (0, 1), got {keep}")
    _check_rows("bits", bits2, n, d, torch.int32, x2.device)
    if gamma.shape != (d,) or gamma.device != x2.device:
        raise ValueError(f"gamma/beta must be ({d},) on {x2.device}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout+add+layer-norm runs on cuda or cpu, not "
                         f"{x2.device}")


def dln_forward(x2, r2, bits2, gamma, beta, keep, eps=1e-5):
    """The fused forward over (N, D) rows: returns y, z (in x's dtype),
    mean and inv ((N, 1) f32). Counterpart of ``_dln_forward``. ``bits2``
    holds int32 words (the uint32 bit patterns).

    On CUDA tensors this launches ``csrc/dropout_ln.cu`` ``dln_fwd`` or
    raises; on CPU tensors it runs :func:`dln_forward_reference`."""
    _check_common(x2, bits2, gamma, keep)
    n, d = x2.shape
    _check_rows("resid", r2, n, d, x2.dtype, x2.device)
    if beta.shape != (d,):
        raise ValueError(f"beta must be ({d},)")
    if x2.device.type == "cpu":
        return dln_forward_reference(x2, r2, bits2, gamma, beta, keep, eps)
    lib = _kernels.library()
    x2, r2, bits2 = x2.contiguous(), r2.contiguous(), bits2.contiguous()
    g = gamma.float().contiguous()
    b = beta.float().contiguous()
    y = torch.empty_like(x2)
    z = torch.empty_like(x2)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    inv = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.zoo_dln_fwd(
            x2.data_ptr(), r2.data_ptr(), bits2.data_ptr(), g.data_ptr(),
            b.data_ptr(), y.data_ptr(), z.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), n, d, KERNEL_DTYPES.index(x2.dtype),
            _thresh(keep), float(1.0 / keep), float(eps), stream)
    _kernels.check(err, FWD_KERNEL_NAME)
    _kernels.LAUNCHES.add(FWD_KERNEL_NAME, x2.dtype)
    return y, z, mean, inv


def dln_backward(dy2, z2, bits2, gamma, mean, inv, keep):
    """The fused backward over (N, D) rows: returns dx, dres (in dy's
    dtype) and dgamma, dbeta ((D,) f32). Counterpart of
    ``_dln_backward`` plus the partial sums of ``_dln_bwd_rule``: the
    kernel writes one dgamma/dbeta partial per block, and a second small
    kernel of the same call sums them in block order.

    On CUDA tensors this launches ``csrc/dropout_ln.cu`` ``dln_bwd`` (and
    its partial sum) or raises; on CPU tensors it runs
    :func:`dln_backward_reference`."""
    _check_common(dy2, bits2, gamma, keep)
    n, d = dy2.shape
    _check_rows("z", z2, n, d, dy2.dtype, dy2.device)
    for name, t in (("mean", mean), ("inv", inv)):
        _check_rows(name, t, n, 1, torch.float32, dy2.device)
    if dy2.device.type == "cpu":
        return dln_backward_reference(dy2, z2, bits2, gamma, mean, inv, keep)
    return _launch_backward(dy2, z2, bits2, gamma, mean, inv, keep)


def _launch_backward(dy2, z2, bits2, gamma, mean, inv, keep):
    """The backward kernel's launch: outputs and the (2, rows, D) partials
    allocated, the rows sized by ``zoo_dln_bwd_blocks`` on the device,
    one call (the kernel and its partial sum)."""
    n, d = dy2.shape
    lib = _kernels.library()
    dy2, z2, bits2 = dy2.contiguous(), z2.contiguous(), bits2.contiguous()
    mean, inv = mean.contiguous(), inv.contiguous()
    g = gamma.float().contiguous()
    dx = torch.empty_like(dy2)
    dres = torch.empty_like(dy2)
    dgamma = torch.empty(d, dtype=torch.float32, device=dy2.device)
    dbeta = torch.empty(d, dtype=torch.float32, device=dy2.device)
    with torch.cuda.device(dy2.device):
        nblk = lib.zoo_dln_bwd_blocks(n)
        if nblk < 1:
            raise RuntimeError(f"{BWD_KERNEL_NAME}: cannot size the grid on "
                               f"{dy2.device}")
        parts = torch.empty((2, nblk, d), dtype=torch.float32,
                            device=dy2.device)
        stream = torch.cuda.current_stream(dy2.device).cuda_stream
        err = lib.zoo_dln_bwd(
            dy2.data_ptr(), z2.data_ptr(), bits2.data_ptr(), g.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), dres.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), nblk, n, d, KERNEL_DTYPES.index(dy2.dtype),
            _thresh(keep), float(1.0 / keep), stream)
    _kernels.check(err, BWD_KERNEL_NAME)
    _kernels.LAUNCHES.add(BWD_KERNEL_NAME, dy2.dtype)
    return dx, dres, dgamma, dbeta


class _DropoutAddLayerNorm(torch.autograd.Function):
    """Counterpart of the TPU package's custom VJP ``_dln``: the forward
    saves z, the bits, gamma and the row statistics; the backward runs
    :func:`dln_backward`. The bits get no gradient."""

    @staticmethod
    def forward(ctx, x2, r2, bits2, gamma, beta, keep, eps):
        y, z, mean, inv = dln_forward(x2, r2, bits2, gamma, beta, keep, eps)
        ctx.save_for_backward(z, bits2, gamma, mean, inv)
        ctx.keep = keep
        return y

    @staticmethod
    def backward(ctx, dy):
        z, bits2, gamma, mean, inv = ctx.saved_tensors
        dx, dres, dgamma, dbeta = dln_backward(dy.contiguous(), z, bits2,
                                               gamma, mean, inv, ctx.keep)
        return (dx, dres, None, dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def _kernel_eligible(x, resid) -> bool:
    """Shapes the kernels take: float32 or bfloat16 rows of at most
    ``KERNEL_MAX_D`` features, any number of rows (the kernels mask their
    own ragged edges; Mosaic's ``% 128`` and row-block rules do not
    apply)."""
    d = x.shape[-1]
    return (x.dtype in KERNEL_DTYPES and 1 <= d <= KERNEL_MAX_D and
            x.numel() > 0 and resid.shape == x.shape)


def dropout_add_layer_norm(x, resid, gamma, beta, generator, p_drop,
                           training=True, eps=1e-5,
                           bits: Optional[torch.Tensor] = None):
    """``layer_norm(dropout(x, p_drop) + resid)``; x, resid: (..., D),
    gamma/beta: (D,).

    In training with ``0 < p_drop < 1`` the keep-mask thresholds 32-bit
    words: ``bits`` when given (shaped like x), else words drawn from
    ``generator`` (a ``torch.Generator`` on x's device). Shapes the
    kernels take run them (on the CPU, their plain versions); any other
    shape composes the same mask with :func:`layer_norm`. Otherwise
    (``training=False``, ``p_drop <= 0``, or neither bits nor a
    generator) it is ``layer_norm(x + resid)``."""
    if not training or p_drop <= 0.0 or (generator is None and bits is None):
        return layer_norm(x + resid, gamma, beta, eps)
    keep = 1.0 - float(p_drop)
    if keep <= 0.0:
        raise ValueError(f"p_drop must be below 1, got {p_drop}")
    d = x.shape[-1]
    n = x.numel() // d
    if bits is None:
        bits = draw_bits((n, d), generator, x.device)
    x2 = x.reshape(n, d)
    r2 = resid.reshape(n, d).to(x.dtype)
    bits2 = bits.reshape(n, d)
    if _kernel_eligible(x, resid):
        y = _DropoutAddLayerNorm.apply(x2, r2, bits2, gamma, beta, keep, eps)
    else:
        dropped = torch.where(_keep_mask(bits2, keep), x2 / keep,
                              torch.zeros_like(x2)).to(x.dtype)
        y = layer_norm(dropped + r2, gamma, beta, eps)
    return y.reshape(x.shape)
