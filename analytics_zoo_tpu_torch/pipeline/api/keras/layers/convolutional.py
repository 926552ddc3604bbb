"""Convolution layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
convolutional.py``; so far Convolution1D/2D, AtrousConvolution1D/2D,
SeparableConvolution2D and the 1D/2D Cropping, UpSampling and
ZeroPadding layers. Convolution3D, Deconvolution2D, ShareConvolution2D,
LocallyConnected1D/2D and the 3D companions wait (ROADMAP A8).

The default ``dim_ordering`` is "th" (NCHW), as in the reference; "tf"
(NHWC) runs the same kernels. Kernels are stored HWIO, as in the JAX
layers -- ``(kh, kw, cin, out)``, depthwise ``(kh, kw, 1, cin * mult)``
-- so ``get_weights`` lists the same arrays as JAX's and weights copy
over unchanged; each call permutes the kernel to PyTorch's OIHW
(``ops/conv.py``), a copy of the kernel in the compute dtype.
"""

from __future__ import annotations

import torch

from .....ops import quant
from .....ops.conv import conv_general_dilated
from ..engine.base import KerasLayer, get_activation_fn, init_tensor


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _conv_out(length, k, stride, border_mode, dilation=1):
    if length is None:
        return None
    keff = (k - 1) * dilation + 1
    if border_mode == "same":
        return (length + stride - 1) // stride
    return (length - keff) // stride + 1


def _padding(border_mode):
    return "SAME" if border_mode == "same" else "VALID"


def _dn(dim_ordering):
    return ("NCHW", "HWIO", "NCHW") if dim_ordering == "th" \
        else ("NHWC", "HWIO", "NHWC")


class Convolution2D(KerasLayer):
    def __init__(self, nb_filter, nb_row, nb_col, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=(1, 1),
                 dim_ordering="th", W_regularizer=None, b_regularizer=None,
                 bias=True, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.init = init
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.dim_ordering = dim_ordering
        # the JAX layer calls this flag ``bias``; here that name is the
        # parameter
        self.use_bias = bool(bias)
        self.dilation = (1, 1)

    def build(self, generator, input_shape):
        cin = int(input_shape[1] if self.dim_ordering == "th"
                  else input_shape[3])
        kh, kw = self.kernel_size
        params = {"kernel": init_tensor(
            generator, (kh, kw, cin, self.nb_filter), self.init)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.nb_filter)
        return params

    def forward(self, x, training=False, **kw):
        return quant.conv2d(x, quant.kernel_of(self), self.subsample,
                            _padding(self.border_mode),
                            rhs_dilation=self.dilation,
                            dimension_numbers=_dn(self.dim_ordering),
                            bias=self.bias if self.use_bias else None,
                            activation=self.activation)

    def compute_output_shape(self, s):
        kh, kw = self.kernel_size
        sh, sw = self.subsample
        dh, dw = self.dilation
        if self.dim_ordering == "th":
            return (s[0], self.nb_filter,
                    _conv_out(s[2], kh, sh, self.border_mode, dh),
                    _conv_out(s[3], kw, sw, self.border_mode, dw))
        return (s[0], _conv_out(s[1], kh, sh, self.border_mode, dh),
                _conv_out(s[2], kw, sw, self.border_mode, dw), self.nb_filter)


class AtrousConvolution2D(Convolution2D):
    def __init__(self, nb_filter, nb_row, nb_col, atrous_rate=(1, 1),
                 **kwargs):
        super().__init__(nb_filter, nb_row, nb_col, **kwargs)
        self.dilation = _pair(atrous_rate)


class Convolution1D(KerasLayer):
    """Conv over (batch, steps, dim) -- Keras-1 layout regardless of
    dim_ordering (Convolution1D.scala)."""

    def __init__(self, nb_filter, filter_length, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample_length=1,
                 W_regularizer=None, b_regularizer=None, bias=True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.filter_length = int(filter_length)
        self.init = init
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = int(subsample_length)
        self.use_bias = bool(bias)
        self.dilation = 1

    def build(self, generator, input_shape):
        cin = int(input_shape[-1])
        params = {"kernel": init_tensor(
            generator, (self.filter_length, cin, self.nb_filter), self.init)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.nb_filter)
        return params

    def forward(self, x, training=False, **kw):
        y = conv_general_dilated(
            x, self.kernel.to(x.dtype), (self.subsample,),
            _padding(self.border_mode), rhs_dilation=(self.dilation,),
            dimension_numbers=("NWC", "WIO", "NWC"))
        return quant.f32_epilogue(y, self.bias if self.use_bias else None,
                                  self.activation, -1)

    def compute_output_shape(self, s):
        return (s[0], _conv_out(s[1], self.filter_length, self.subsample,
                                self.border_mode, self.dilation),
                self.nb_filter)


class AtrousConvolution1D(Convolution1D):
    def __init__(self, nb_filter, filter_length, atrous_rate=1, **kwargs):
        super().__init__(nb_filter, filter_length, **kwargs)
        self.dilation = int(atrous_rate)


class SeparableConvolution2D(KerasLayer):
    """A depthwise convolution (``depth_multiplier`` filters per input
    channel) then a 1x1 pointwise one, a single bias and activation."""

    def __init__(self, nb_filter, nb_row, nb_col, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=(1, 1),
                 depth_multiplier=1, dim_ordering="th", bias=True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.init = init
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.depth_multiplier = int(depth_multiplier)
        self.dim_ordering = dim_ordering
        self.use_bias = bool(bias)

    def build(self, generator, input_shape):
        cin = int(input_shape[1] if self.dim_ordering == "th"
                  else input_shape[3])
        kh, kw = self.kernel_size
        mid = cin * self.depth_multiplier
        params = {
            "depthwise": init_tensor(generator, (kh, kw, 1, mid), self.init),
            "pointwise": init_tensor(generator, (1, 1, mid, self.nb_filter),
                                     self.init)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.nb_filter)
        return params

    def forward(self, x, training=False, **kw):
        dn = _dn(self.dim_ordering)
        channel_axis = 1 if self.dim_ordering == "th" else 3
        y = conv_general_dilated(
            x, self.depthwise.to(x.dtype), self.subsample,
            _padding(self.border_mode), dimension_numbers=dn,
            feature_group_count=x.shape[channel_axis])
        y = conv_general_dilated(y, self.pointwise.to(x.dtype), (1, 1),
                                 "VALID", dimension_numbers=dn)
        return quant.f32_epilogue(y, self.bias if self.use_bias else None,
                                  self.activation, channel_axis)

    def compute_output_shape(self, s):
        kh, kw = self.kernel_size
        sh, sw = self.subsample
        if self.dim_ordering == "th":
            return (s[0], self.nb_filter,
                    _conv_out(s[2], kh, sh, self.border_mode),
                    _conv_out(s[3], kw, sw, self.border_mode))
        return (s[0], _conv_out(s[1], kh, sh, self.border_mode),
                _conv_out(s[2], kw, sw, self.border_mode), self.nb_filter)


# ---------------------------------------------------------------------------
# Shape-manipulation conv companions
# ---------------------------------------------------------------------------

def _crop(x, dim, before, after):
    return x.narrow(dim, before, x.shape[dim] - before - after)


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = tuple(cropping)

    def forward(self, x, training=False, **kw):
        return _crop(x, 1, *self.cropping)

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] - sum(self.cropping),
                s[2])


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering="th",
                 input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = tuple(tuple(c) for c in cropping)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        (t, b), (l, r) = self.cropping
        h_ax = 2 if self.dim_ordering == "th" else 1
        return _crop(_crop(x, h_ax, t, b), h_ax + 1, l, r)

    def compute_output_shape(self, s):
        (t, b), (l, r) = self.cropping

        def crop(d, c):
            return None if d is None else d - c

        if self.dim_ordering == "th":
            return (s[0], s[1], crop(s[2], t + b), crop(s[3], l + r))
        return (s[0], crop(s[1], t + b), crop(s[2], l + r), s[3])


class UpSampling1D(KerasLayer):
    def __init__(self, length=2, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.length = int(length)

    def forward(self, x, training=False, **kw):
        return torch.repeat_interleave(x, self.length, dim=1)

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] * self.length, s[2])


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), dim_ordering="th", input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.size = _pair(size)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        h_ax = 2 if self.dim_ordering == "th" else 1
        x = torch.repeat_interleave(x, self.size[0], dim=h_ax)
        return torch.repeat_interleave(x, self.size[1], dim=h_ax + 1)

    def compute_output_shape(self, s):
        def up(d, f):
            return None if d is None else d * f

        if self.dim_ordering == "th":
            return (s[0], s[1], up(s[2], self.size[0]), up(s[3], self.size[1]))
        return (s[0], up(s[1], self.size[0]), up(s[2], self.size[1]), s[3])


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding=1, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = _pair(padding) if isinstance(padding, (list, tuple)) \
            else (int(padding), int(padding))

    def forward(self, x, training=False, **kw):
        return torch.nn.functional.pad(x, (0, 0) + tuple(self.padding))

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] + sum(self.padding),
                s[2])


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), dim_ordering="th", input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        if len(padding) == 2 and not isinstance(padding[0], (list, tuple)):
            self.padding = ((padding[0], padding[0]),
                            (padding[1], padding[1]))
        else:
            self.padding = tuple(tuple(p) for p in padding)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        (t, b), (l, r) = self.padding
        pads = (l, r, t, b) if self.dim_ordering == "th" else \
            (0, 0, l, r, t, b)
        return torch.nn.functional.pad(x, pads)

    def compute_output_shape(self, s):
        (t, b), (l, r) = self.padding

        def pad(d, c):
            return None if d is None else d + c

        if self.dim_ordering == "th":
            return (s[0], s[1], pad(s[2], t + b), pad(s[3], l + r))
        return (s[0], pad(s[1], t + b), pad(s[2], l + r), s[3])
