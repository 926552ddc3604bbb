"""Pooling layers (Pooling1D/2D/3D and the Global variants).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
pooling.py``, whose layers lower to ``lax.reduce_window``. "SAME" pads
are XLA's (``ops/conv.py``): asymmetric where the total is odd, so the
padding is explicit -- -inf for max pooling (int8's least value for an
int8 input, which max pooling passes on a requantization chain), and
average pooling divides each window's sum by its count of unpadded
cells, which ``count_include_pad=False`` gives only for symmetric pads. A
channels-last layout ("tf", and the 1D layers' (batch, steps, dim))
enters the library pooling as a channels-last view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .....ops.conv import (channels_first, from_channels_first, pad_spatial,
                           same_pads)
from ..engine.base import KerasLayer
from .convolutional import _conv_out, _pair

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, window, strides, border_mode, mode, layout):
    """Max or average pooling of ``x`` in ``layout`` ("NCHW", "NHWC",
    "NWC", ...) over ``window`` with ``strides``. A 1D pool runs as a 2D
    one over a trailing unit dim."""
    xc = channels_first(x, layout)
    one_d = len(window) == 1
    if one_d:
        xc = xc.unsqueeze(-1)
        window, strides = tuple(window) + (1,), tuple(strides) + (1,)
    pads = same_pads(xc.shape[2:], window, strides) \
        if border_mode == "same" else [(0, 0)] * len(window)
    nsp = len(window)
    if mode == "max" and xc.dtype == torch.int8:
        # int8 activations flow through max pooling on a requantization
        # chain: the identity of integer max is iinfo.min, not -inf; the
        # library pooling takes no int8 on the card, so the window runs
        # on float16, where every int8 value is exact
        y = _MAX_POOL[nsp](
            pad_spatial(xc, pads, torch.iinfo(torch.int8).min)
            .to(torch.float16), window, strides).to(torch.int8)
    elif mode == "max":
        y = _MAX_POOL[nsp](pad_spatial(xc, pads, -float("inf")), window,
                           strides)
    elif any(p for pair in pads for p in pair):
        def window_sums(t):
            return _AVG_POOL[nsp](pad_spatial(t, pads), window, strides,
                                  divisor_override=1)
        y = window_sums(xc) / window_sums(torch.ones(
            (1, 1) + tuple(xc.shape[2:]), dtype=x.dtype, device=x.device))
    else:
        y = _AVG_POOL[nsp](xc, window, strides)
    if one_d:
        y = y.squeeze(-1)
    return from_channels_first(y, layout)


class MaxPooling2D(KerasLayer):
    mode = "max"

    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 dim_ordering="th", input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else \
            self.pool_size
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        return _pool(x, self.pool_size, self.strides, self.border_mode,
                     self.mode, "NCHW" if self.dim_ordering == "th"
                     else "NHWC")

    def compute_output_shape(self, s):
        ph, pw = self.pool_size
        sh, sw = self.strides
        if self.dim_ordering == "th":
            return (s[0], s[1], _conv_out(s[2], ph, sh, self.border_mode),
                    _conv_out(s[3], pw, sw, self.border_mode))
        return (s[0], _conv_out(s[1], ph, sh, self.border_mode),
                _conv_out(s[2], pw, sw, self.border_mode), s[3])


class AveragePooling2D(MaxPooling2D):
    mode = "avg"


class MaxPooling1D(KerasLayer):
    mode = "max"

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_length = int(pool_length)
        self.stride = int(stride) if stride is not None else self.pool_length
        self.border_mode = border_mode

    def forward(self, x, training=False, **kw):
        return _pool(x, (self.pool_length,), (self.stride,),
                     self.border_mode, self.mode, "NWC")

    def compute_output_shape(self, s):
        return (s[0], _conv_out(s[1], self.pool_length, self.stride,
                                self.border_mode), s[2])


class AveragePooling1D(MaxPooling1D):
    mode = "avg"


class MaxPooling3D(KerasLayer):
    mode = "max"

    def __init__(self, pool_size=(2, 2, 2), strides=None, border_mode="valid",
                 dim_ordering="th", input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides is not None else \
            self.pool_size
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        return _pool(x, self.pool_size, self.strides, self.border_mode,
                     self.mode, "NCDHW" if self.dim_ordering == "th"
                     else "NDHWC")

    def compute_output_shape(self, s):
        ps, ss = self.pool_size, self.strides
        off = 2 if self.dim_ordering == "th" else 1
        dims = tuple(_conv_out(s[off + i], ps[i], ss[i], self.border_mode)
                     for i in range(3))
        if self.dim_ordering == "th":
            return (s[0], s[1]) + dims
        return (s[0],) + dims + (s[4],)


class AveragePooling3D(MaxPooling3D):
    mode = "avg"


class GlobalMaxPooling2D(KerasLayer):
    def __init__(self, dim_ordering="th", input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.dim_ordering = dim_ordering

    def _axes(self):
        return (2, 3) if self.dim_ordering == "th" else (1, 2)

    def forward(self, x, training=False, **kw):
        return x.amax(dim=self._axes())

    def compute_output_shape(self, s):
        return (s[0], s[1] if self.dim_ordering == "th" else s[3])


class GlobalAveragePooling2D(GlobalMaxPooling2D):
    def forward(self, x, training=False, **kw):
        return x.mean(dim=self._axes())


class GlobalMaxPooling1D(KerasLayer):
    def forward(self, x, training=False, **kw):
        return x.amax(dim=1)

    def compute_output_shape(self, s):
        return (s[0], s[2])


class GlobalAveragePooling1D(GlobalMaxPooling1D):
    def forward(self, x, training=False, **kw):
        return x.mean(dim=1)


class GlobalMaxPooling3D(KerasLayer):
    def __init__(self, dim_ordering="th", input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.dim_ordering = dim_ordering

    def _axes(self):
        return (2, 3, 4) if self.dim_ordering == "th" else (1, 2, 3)

    def forward(self, x, training=False, **kw):
        return x.amax(dim=self._axes())

    def compute_output_shape(self, s):
        return (s[0], s[1] if self.dim_ordering == "th" else s[4])


class GlobalAveragePooling3D(GlobalMaxPooling3D):
    def forward(self, x, training=False, **kw):
        return x.mean(dim=self._axes())
