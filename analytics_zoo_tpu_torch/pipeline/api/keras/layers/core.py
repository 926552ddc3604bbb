"""Core layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``,
all of it (parity surface ``zoo/.../pipeline/api/keras/layers/``):
``Dense``, ``Dropout`` and the spatial dropouts, ``Activation``,
``Flatten``, ``Reshape``, ``Permute``, ``RepeatVector``, ``Masking``,
``Highway``, ``MaxoutDense``, ``Select``, ``Narrow``, ``Squeeze``,
``ExpandDim``, ``Identity``, ``Max``, ``SplitTensor``, the elementwise
and constant layers, the learnable ``CAdd``/``CMul``/``Mul``/``Scale``,
the threshold and shrink layers, the Gaussian noise layers (drawing from
the trainer's ``torch.Generator``, so their bits differ from JAX's by
design), ``ResizeBilinear``, ``SparseDense``, ``SelectTable``,
``Expand`` and ``GetShape``. Parameter names and layouts are the JAX
layers', so weights cross over by name (``utils/jax_weights``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .....ops import quant
from ..engine.base import KerasLayer, get_activation_fn, init_tensor


class Dense(KerasLayer):
    """Fully connected: applies to the last dim (Dense.scala). ``kernel``
    is (in, out), as in the JAX layer."""

    def __init__(self, output_dim, init="glorot_uniform", activation=None,
                 W_regularizer=None, b_regularizer=None, bias=True,
                 input_dim=None, input_shape=None, name=None, **kwargs):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation_fn(activation)
        # the JAX layer calls this flag ``bias``; here that name is the
        # parameter
        self.use_bias = bool(bias)

    def build(self, generator, input_shape):
        in_dim = int(input_shape[-1])
        params = {"kernel": init_tensor(generator,
                                        (in_dim, self.output_dim),
                                        self.init)}
        self._annotate(kernel=("in", "out"))
        if self.use_bias:
            params["bias"] = torch.zeros(self.output_dim)
            self._annotate(bias=("out",))
        return params

    def forward(self, x, training=False, **kw):
        # quant.matmul owns the whole epilogue: a float kernel gives
        # matmul + bias + activation; a calibrated int8 kernel (supplied
        # by QuantizedModel) folds the bias into the int32 accumulator
        # and may emit int8 for the next requantization-chain link
        return quant.matmul(x, quant.kernel_of(self),
                            bias=self.bias if self.use_bias else None,
                            activation=self.activation)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(KerasLayer):
    """Applies an activation by name (``get_activation_fn``)."""

    def __init__(self, activation, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.fn = get_activation_fn(activation)

    def forward(self, x, training=False, **kw):
        return self.fn(x)


class Dropout(KerasLayer):
    """Zeroes each element with probability ``p`` while training and
    scales the rest by ``1 / (1 - p)``; the identity when not training,
    at ``p = 0`` or without a generator. The mask comes from the
    trainer's per-step ``generator`` on x's device, so it differs from
    JAX's ``bernoulli`` bits by design."""

    stochastic = True

    def __init__(self, p, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class Flatten(KerasLayer):
    """(B, ...) -> (B, prod(...)); a 1-D input (B,) becomes (B, 1)."""

    def forward(self, x, training=False, **kw):
        return x.reshape(x.shape[0], -1) if x.dim() > 1 else \
            x.reshape(x.shape[0], 1)

    def compute_output_shape(self, input_shape):
        rest = list(input_shape[1:])
        return (input_shape[0], int(math.prod(rest)) if rest else 1)


class Select(KerasLayer):
    """Select one index along a dim, removing it (Select.scala). ``dim``
    counts the batch dim as 0; a negative ``dim`` or ``index`` counts
    from the end."""

    def __init__(self, dim, index, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.index = int(index)

    def forward(self, x, training=False, **kw):
        idx = self.index if self.index >= 0 else \
            x.shape[self.dim] + self.index
        return x.select(self.dim, idx)

    def compute_output_shape(self, input_shape):
        dim = self.dim if self.dim >= 0 else len(input_shape) + self.dim
        return tuple(d for i, d in enumerate(input_shape) if i != dim)


def _drop(x, p, shape, generator):
    """Inverted dropout with a mask of ``shape`` broadcast over x."""
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


class SpatialDropout1D(KerasLayer):
    """Drops whole feature channels of a (B, T, C) input."""

    stochastic = True

    def __init__(self, p=0.5, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None or self.p <= 0.0:
            return x
        return _drop(x, self.p, (x.shape[0], 1, x.shape[2]), generator)


class SpatialDropout2D(KerasLayer):
    """Drops whole channels: (B, C, H, W) for ``dim_ordering="th"``,
    (B, H, W, C) for "tf"."""

    stochastic = True

    def __init__(self, p=0.5, dim_ordering="th", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None or self.p <= 0.0:
            return x
        shape = (x.shape[0], x.shape[1], 1, 1) \
            if self.dim_ordering == "th" else (x.shape[0], 1, 1, x.shape[3])
        return _drop(x, self.p, shape, generator)


class SpatialDropout3D(KerasLayer):
    stochastic = True

    def __init__(self, p=0.5, dim_ordering="th", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None or self.p <= 0.0:
            return x
        shape = (x.shape[0], x.shape[1], 1, 1, 1) \
            if self.dim_ordering == "th" else \
            (x.shape[0], 1, 1, 1, x.shape[4])
        return _drop(x, self.p, shape, generator)


class Reshape(KerasLayer):
    """(B, ...) -> (B, *target_shape); one -1 is inferred."""

    def __init__(self, target_shape, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.target_shape = tuple(int(d) for d in target_shape)

    def forward(self, x, training=False, **kw):
        return x.reshape((x.shape[0],) + self.target_shape)

    def compute_output_shape(self, input_shape):
        target = self.target_shape
        if -1 in target:
            if target.count(-1) > 1:
                raise ValueError(f"Reshape{target}: at most one -1 allowed")
            known = math.prod(int(d) for d in input_shape[1:])
            fixed = math.prod(d for d in target if d != -1)
            if known % fixed != 0:
                raise ValueError(
                    f"cannot Reshape {tuple(input_shape[1:])} "
                    f"({known} elements) into {target}")
            target = tuple(known // fixed if d == -1 else d for d in target)
        return (input_shape[0],) + target


class Permute(KerasLayer):
    """Permute non-batch dims; dims are 1-based like Keras
    (Permute.scala)."""

    def __init__(self, dims, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dims = tuple(int(d) for d in dims)

    def forward(self, x, training=False, **kw):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)


class RepeatVector(KerasLayer):
    """(B, D) -> (B, n, D)."""

    def __init__(self, n, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.n = int(n)

    def forward(self, x, training=False, **kw):
        return x[:, None, :].expand(-1, self.n, -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class Masking(KerasLayer):
    """Zeroes the timesteps whose features all equal ``mask_value``."""

    def __init__(self, mask_value=0.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.mask_value = mask_value

    def forward(self, x, training=False, **kw):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, 0.0).to(x.dtype)


class Highway(KerasLayer):
    """Highway network layer (Highway.scala): ``t * h + (1 - t) * x``
    with gate ``t = sigmoid(x @ gate_kernel + gate_bias)``."""

    def __init__(self, activation="tanh", W_regularizer=None,
                 b_regularizer=None, bias=True, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.activation = get_activation_fn(activation)
        self.use_bias = bool(bias)

    def build(self, generator, input_shape):
        d = int(input_shape[-1])
        params = {"kernel": init_tensor(generator, (d, d)),
                  "gate_kernel": init_tensor(generator, (d, d))}
        if self.use_bias:
            params["bias"] = torch.zeros(d)
            params["gate_bias"] = torch.full((d,), -2.0)
        return params

    def forward(self, x, training=False, **kw):
        h = torch.matmul(x, self.kernel)
        g = torch.matmul(x, self.gate_kernel)
        if self.use_bias:
            h = h + self.bias
            g = g + self.gate_bias
        h = self.activation(h) if self.activation else h
        t = torch.sigmoid(g)
        return t * h + (1.0 - t) * x


class MaxoutDense(KerasLayer):
    """The max over ``nb_feature`` dense projections; ``kernel`` is
    (nb_feature, in, out)."""

    def __init__(self, output_dim, nb_feature=4, bias=True, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.use_bias = bool(bias)

    def build(self, generator, input_shape):
        d = int(input_shape[-1])
        params = {"kernel": init_tensor(
            generator, (self.nb_feature, d, self.output_dim))}
        if self.use_bias:
            params["bias"] = torch.zeros(self.nb_feature, self.output_dim)
        return params

    def forward(self, x, training=False, **kw):
        y = torch.einsum("bd,kdo->bko", x, self.kernel)
        if self.use_bias:
            y = y + self.bias
        return y.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)


def _axis(dim, rank):
    return dim if dim >= 0 else rank + dim


class Narrow(KerasLayer):
    """Slice ``length`` elements starting at ``offset`` along ``dim``
    (Narrow.scala); ``length <= 0`` runs to the end."""

    def __init__(self, dim, offset, length=1, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim, self.offset, self.length = int(dim), int(offset), int(length)

    def forward(self, x, training=False, **kw):
        length = self.length if self.length > 0 else \
            x.shape[self.dim] - self.offset
        return x.narrow(self.dim, self.offset, length)

    def compute_output_shape(self, input_shape):
        dim = _axis(self.dim, len(input_shape))
        length = self.length if self.length > 0 else \
            input_shape[dim] - self.offset
        return tuple(length if i == dim else d
                     for i, d in enumerate(input_shape))


class Squeeze(KerasLayer):
    def __init__(self, dim, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = dim

    def forward(self, x, training=False, **kw):
        dims = self.dim if isinstance(self.dim, (list, tuple)) \
            else (self.dim,)
        return torch.squeeze(x, tuple(int(d) for d in dims))

    def compute_output_shape(self, input_shape):
        dims = self.dim if isinstance(self.dim, (list, tuple)) else [self.dim]
        dims = [_axis(d, len(input_shape)) for d in dims]
        return tuple(d for i, d in enumerate(input_shape) if i not in dims)


class ExpandDim(KerasLayer):
    def __init__(self, dim, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)

    def forward(self, x, training=False, **kw):
        return x.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        dim = self.dim if self.dim >= 0 else len(shape) + self.dim + 1
        shape.insert(dim, 1)
        return tuple(shape)


class Identity(KerasLayer):
    def forward(self, x, training=False, **kw):
        return x


class Max(KerasLayer):
    """Max along a dim (Max.scala), or its index with
    ``return_value=False``."""

    def __init__(self, dim, num_input_dims=-1, return_value=True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.return_value = return_value

    def forward(self, x, training=False, **kw):
        if self.return_value:
            return x.amax(dim=self.dim)
        return x.argmax(dim=self.dim)

    def compute_output_shape(self, input_shape):
        dim = _axis(self.dim, len(input_shape))
        return tuple(d for i, d in enumerate(input_shape) if i != dim)


class SplitTensor(KerasLayer):
    """Split along a dim into ``num_splits`` equal chunks
    (SplitTensor.scala); a layer of ``num_splits`` outputs."""

    def __init__(self, dim, num_splits, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.num_splits = int(num_splits)
        self.num_outputs = self.num_splits

    def forward(self, x, training=False, **kw):
        size = x.shape[self.dim]
        if size % self.num_splits:
            raise ValueError(f"cannot split {size} into {self.num_splits} "
                             "equal chunks")
        return tuple(torch.split(x, size // self.num_splits, dim=self.dim))

    def compute_output_shape(self, input_shape):
        dim = _axis(self.dim, len(input_shape))
        chunk = input_shape[dim] // self.num_splits \
            if input_shape[dim] else None
        one = tuple(chunk if i == dim else d
                    for i, d in enumerate(input_shape))
        return [one] * self.num_splits


# ---------------------------------------------------------------------------
# Simple elementwise layers
# ---------------------------------------------------------------------------

class _Elementwise(KerasLayer):
    fn = staticmethod(lambda x: x)

    def forward(self, x, training=False, **kw):
        return type(self).fn(x)


class Exp(_Elementwise):
    fn = staticmethod(torch.exp)


class Log(_Elementwise):
    fn = staticmethod(torch.log)


class Sqrt(_Elementwise):
    fn = staticmethod(torch.sqrt)


class Square(_Elementwise):
    fn = staticmethod(torch.square)


class Negative(_Elementwise):
    fn = staticmethod(torch.negative)


class Power(KerasLayer):
    """``(scale * x + shift) ** power``."""

    def __init__(self, power, scale=1.0, shift=0.0, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x, training=False, **kw):
        return torch.pow(self.scale * x + self.shift, self.power)


class AddConstant(KerasLayer):
    def __init__(self, constant, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = constant

    def forward(self, x, training=False, **kw):
        return x + self.constant


class MulConstant(KerasLayer):
    def __init__(self, constant, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = constant

    def forward(self, x, training=False, **kw):
        return x * self.constant


class CAdd(KerasLayer):
    """Learnable bias of broadcastable shape ``size`` (CAdd.scala)."""

    def __init__(self, size, b_regularizer=None, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"bias": torch.zeros(self.size)}

    def forward(self, x, training=False, **kw):
        return x + self.bias


class CMul(KerasLayer):
    """Learnable scale of broadcastable shape ``size`` (CMul.scala)."""

    def __init__(self, size, W_regularizer=None, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"weight": torch.ones(self.size)}

    def forward(self, x, training=False, **kw):
        return x * self.weight


class Mul(KerasLayer):
    """A single learnable scalar multiplier (Mul.scala)."""

    def build(self, generator, input_shape):
        return {"weight": torch.ones(())}

    def forward(self, x, training=False, **kw):
        return x * self.weight


class Scale(KerasLayer):
    """``weight * x + bias``, both of shape ``size`` (Scale.scala)."""

    def __init__(self, size, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"weight": torch.ones(self.size),
                "bias": torch.zeros(self.size)}

    def forward(self, x, training=False, **kw):
        return x * self.weight + self.bias


class BinaryThreshold(KerasLayer):
    def __init__(self, value=1e-6, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.value = value

    def forward(self, x, training=False, **kw):
        return (x > self.value).to(x.dtype)


class Threshold(KerasLayer):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th=1e-6, v=0.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.th, self.v = th, v

    def forward(self, x, training=False, **kw):
        return torch.where(x > self.th, x, self.v).to(x.dtype)


class HardTanh(KerasLayer):
    def __init__(self, min_value=-1.0, max_value=1.0, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x, training=False, **kw):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(KerasLayer):
    def __init__(self, value=0.5, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.value = value

    def forward(self, x, training=False, **kw):
        return torch.where(torch.abs(x) > self.value, x, 0.0).to(x.dtype)


class SoftShrink(KerasLayer):
    def __init__(self, value=0.5, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.value = value

    def forward(self, x, training=False, **kw):
        return torch.sign(x) * torch.clamp(torch.abs(x) - self.value,
                                           min=0.0)


class GaussianNoise(KerasLayer):
    """Adds N(0, sigma^2) noise while training."""

    stochastic = True

    def __init__(self, sigma, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.sigma = sigma

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None:
            return x
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return x + self.sigma * noise


class GaussianDropout(KerasLayer):
    """Multiplies by N(1, p / (1 - p)) noise while training."""

    stochastic = True

    def __init__(self, p, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.p = p

    def forward(self, x, training=False, generator=None, **kw):
        if not training or generator is None:
            return x
        stddev = math.sqrt(self.p / (1.0 - self.p))
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return x * (1.0 + stddev * noise)


class GaussianSampler(KerasLayer):
    """VAE reparameterization on ``[mean, log_var]``
    (GaussianSampler.scala): ``mean + exp(log_var / 2) * eps``, and the
    mean without a generator."""

    stochastic = True

    def forward(self, x, training=False, generator=None, **kw):
        mean, log_var = x
        if generator is None:
            return mean
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * log_var) * eps

    def compute_output_shape(self, input_shape):
        return input_shape[0]


class ResizeBilinear(KerasLayer):
    """Bilinear resize of the spatial dims, with half-pixel centres and,
    when shrinking, the triangle filter widened to the scale, as
    ``jax.image.resize(method="bilinear")`` does."""

    def __init__(self, output_height, output_width, align_corners=False,
                 dim_ordering="th", input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.oh, self.ow = int(output_height), int(output_width)
        self.dim_ordering = dim_ordering

    def forward(self, x, training=False, **kw):
        nhwc = self.dim_ordering != "th"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        y = F.interpolate(x, size=(self.oh, self.ow), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1) if nhwc else y

    def compute_output_shape(self, s):
        if self.dim_ordering == "th":
            return (s[0], s[1], self.oh, self.ow)
        return (s[0], self.oh, self.ow, s[3])


class SparseDense(KerasLayer):
    """Dense over (conceptually) sparse inputs (SparseDense.scala). No
    gradient flows back to the input, except through the window of the
    last dim that ``backward_start`` (1-based) and ``backward_length``
    open; the forward is ``Dense``'s, through ``quant.matmul``."""

    def __init__(self, output_dim, init="glorot_uniform", activation=None,
                 W_regularizer=None, b_regularizer=None, backward_start=-1,
                 backward_length=-1, bias=True, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation_fn(activation)
        self.use_bias = bool(bias)
        self.backward_start = int(backward_start)
        self.backward_length = int(backward_length)

    def build(self, generator, input_shape):
        if len(input_shape) < 2:
            raise ValueError("SparseDense requires input dim >= 2, got %r"
                             % (input_shape,))
        in_dim = int(input_shape[-1])
        params = {"kernel": init_tensor(generator,
                                        (in_dim, self.output_dim),
                                        self.init)}
        self._annotate(kernel=("in", "out"))
        if self.use_bias:
            params["bias"] = torch.zeros(self.output_dim)
            self._annotate(bias=("out",))
        return params

    def forward(self, x, training=False, **kw):
        if x.requires_grad:
            if self.backward_start > 0 and self.backward_length > 0:
                start = self.backward_start - 1
                mask = torch.zeros(x.shape[-1], dtype=x.dtype,
                                   device=x.device)
                mask[start:start + self.backward_length] = 1.0
                x = x.detach() * (1.0 - mask) + x * mask
            else:
                x = x.detach()
        return quant.matmul(x, quant.kernel_of(self),
                            bias=self.bias if self.use_bias else None,
                            activation=self.activation)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class SelectTable(KerasLayer):
    """Element ``index`` (0-based) of a table of inputs
    (SelectTable.scala); the gradient reaches only that input."""

    def __init__(self, index, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.index = int(index)

    def forward(self, xs, training=False, **kw):
        if not isinstance(xs, (list, tuple)):
            raise ValueError("SelectTable expects a table (list) input")
        return xs[self.index]

    def compute_output_shape(self, input_shape):
        if input_shape and isinstance(input_shape[0], (list, tuple)):
            return tuple(input_shape[self.index])
        return tuple(input_shape)


class Expand(KerasLayer):
    """Broadcast singleton dims to ``tgt_sizes`` (Expand.scala), which
    covers every dim, the batch dim included; -1 keeps a dim."""

    def __init__(self, tgt_sizes, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.tgt_sizes = tuple(int(t) for t in tgt_sizes)

    def _target(self, shape):
        if len(self.tgt_sizes) != len(shape):
            raise ValueError(
                "tgt_sizes must cover every dim: got %d for rank %d"
                % (len(self.tgt_sizes), len(shape)))
        out = []
        for have, want in zip(shape, self.tgt_sizes):
            if want == -1:
                out.append(have)
            elif have is None:
                out.append(want)
            elif have not in (1, want):
                raise ValueError(
                    "only singleton expansion supported: %r -> %r"
                    % (tuple(shape), self.tgt_sizes))
            else:
                out.append(want)
        return tuple(out)

    def forward(self, x, training=False, **kw):
        return x.expand(self._target(tuple(x.shape)))

    def compute_output_shape(self, input_shape):
        return self._target(tuple(input_shape))


class GetShape(KerasLayer):
    """The input's shape, batch dim included, as a float32 1-D tensor
    (GetShape.scala); it carries no gradient to the input."""

    def forward(self, x, training=False, **kw):
        return torch.tensor(tuple(x.shape), dtype=torch.float32,
                            device=x.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)
