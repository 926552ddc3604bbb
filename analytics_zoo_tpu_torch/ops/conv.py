"""Convolution with ``lax.conv_general_dilated``'s semantics.

The JAX package convolves with ``lax.conv_general_dilated`` (outside any
Pallas kernel: XLA compiles it), with kernels stored HWIO -- spatial
dims, then input channels, then output channels -- in either activation
layout. The port keeps the kernels HWIO, so weights copy from JAX with no
transposes, and permutes them to PyTorch's OIHW at the call; the
library convolution (``F.conv1d/2d/3d``, cuDNN on the card) is the plain
counterpart here, as ``torch.matmul`` is for Dense. A channels-last
activation ("NHWC", "NWC") enters the library call as a channels-last
view of the NCHW-shaped tensor, with no copy. On the card a 2-D
convolution takes its input in channels-last memory whatever the
layout (a copy only where it is not): cuDNN then convolves without its
NCHW <-> NHWC transposes and returns channels-last memory, which
BatchNorm, ReLU, the adds and pooling keep (``chip_smoke.py``'s
``resnet`` phase times the step).

"SAME" padding is XLA's, which is asymmetric: the pad total along a
dimension is ``max((out - 1) * stride + k_eff - in, 0)`` with
``out = ceil(in / stride)``, ``total // 2`` before and the rest after.
PyTorch's own ``padding="same"`` refuses a stride above 1 and its
pooling pads symmetrically, so an asymmetric pad goes through ``F.pad``
first.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def same_pads(sizes: Sequence[int], window: Sequence[int],
              strides: Sequence[int], dilation: Sequence[int] = None
              ) -> List[Tuple[int, int]]:
    """XLA's "SAME" (before, after) pads of each spatial dim."""
    dilation = dilation or (1,) * len(sizes)
    pads = []
    for n, k, s, d in zip(sizes, window, strides, dilation):
        keff = (k - 1) * d + 1
        total = max((math.ceil(n / s) - 1) * s + keff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_spatial(x, pads, value=0.0):
    """``x`` (N, C, spatial...) padded by ``pads``, one (before, after)
    per spatial dim."""
    flat = [p for before_after in reversed(pads) for p in before_after]
    return F.pad(x, flat, value=value) if any(flat) else x


def channels_first(x, layout: str):
    """``x`` in ``layout`` ("NCHW", "NHWC", "NWC", ...) as an (N, C,
    spatial...) view."""
    return x.movedim(-1, 1) if layout[-1] == "C" else x


def from_channels_first(y, layout: str):
    return y.movedim(1, -1) if layout[-1] == "C" else y


def conv_general_dilated(x, w, window_strides, padding, rhs_dilation=None,
                         dimension_numbers=("NCHW", "HWIO", "NCHW"),
                         feature_group_count: int = 1):
    """The convolution of ``x`` with the HWIO kernel ``w`` (``w`` already
    in x's dtype): ``padding`` "SAME" or "VALID", ``dimension_numbers``
    (lhs, rhs, out) with rhs spatial-first ("HWIO", "WIO") and out equal
    to lhs. ``feature_group_count`` splits the input channels into
    groups, output channel o reading group ``o // (O / groups)``: a
    depthwise kernel (kh, kw, 1, cin * mult) with ``cin`` groups."""
    lhs, rhs, out = dimension_numbers
    nsp = len(lhs) - 2
    if rhs[-2:] != "IO" or out != lhs or len(rhs) != nsp + 2:
        raise ValueError(f"unsupported dimension_numbers "
                         f"{dimension_numbers}")
    dilation = tuple(rhs_dilation or (1,) * nsp)
    strides = tuple(window_strides)
    xc = channels_first(x, lhs)
    weight = w.permute(nsp + 1, nsp, *range(nsp))
    pads = same_pads(xc.shape[2:], w.shape[:nsp], strides, dilation) \
        if padding == "SAME" else [(0, 0)] * nsp
    if all(a == b for a, b in pads):
        conv_pad = tuple(a for a, _ in pads)
    else:
        xc, conv_pad = pad_spatial(xc, pads), 0
    if xc.is_cuda and nsp == 2:
        xc = xc.contiguous(memory_format=torch.channels_last)
    y = _CONV[nsp](xc, weight, None, strides, conv_pad, dilation,
                   feature_group_count)
    return from_channels_first(y, lhs)
