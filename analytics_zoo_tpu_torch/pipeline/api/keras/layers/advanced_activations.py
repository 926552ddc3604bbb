"""Advanced activation layers: LeakyReLU, ELU, PReLU, SReLU,
ThresholdedReLU, RReLU, Softmax.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
advanced_activations.py`` (parity: the Keras-1 layers of the same names).
Each is the JAX layer's ``where`` expression in torch, so the gradients at
the kinks are the same (the ``x >= 0`` branch takes x = 0). ``PReLU``
keeps one learnable slope a channel of dim 1 (or one shared slope),
``SReLU`` its four per-element tensors, as in JAX.

``RReLU`` draws its training slopes U(lower, upper) from the generator the
trainer hands its stochastic layers (as ``GaussianNoise`` does); the draws
are PyTorch's, not JAX's bits. Without ``training`` or a generator the
slope is the mean (lower + upper) / 2, the JAX layer's inference output.
"""

from __future__ import annotations

import torch

from ..engine.base import KerasLayer, init_tensor


class LeakyReLU(KerasLayer):
    def __init__(self, alpha=0.3, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = alpha

    def forward(self, x, training=False, **kw):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(KerasLayer):
    def __init__(self, alpha=1.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = alpha

    def forward(self, x, training=False, **kw):
        return torch.where(x >= 0, x, self.alpha * (torch.exp(x) - 1.0))


class PReLU(KerasLayer):
    """Learnable slope: one a channel of dim 1 (``n_output_plane``), or
    one shared."""

    def __init__(self, n_output_plane=0, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.n_output_plane = int(n_output_plane)

    def build(self, generator, input_shape):
        n = self.n_output_plane if self.n_output_plane > 0 else 1
        return {"alpha": torch.full((n,), 0.25)}

    def forward(self, x, training=False, **kw):
        alpha = self.alpha.to(x.dtype)
        if alpha.shape[0] > 1:
            shape = [1] * x.dim()
            shape[1] = alpha.shape[0]
            alpha = alpha.reshape(shape)
        return torch.where(x >= 0, x, alpha * x)


class SReLU(KerasLayer):
    """S-shaped ReLU with four learnable per-element tensors (``t_left``,
    ``a_left``, ``t_right``, ``a_right``), shared along ``shared_axes``."""

    def __init__(self, t_left_init="zero", a_left_init="glorot_uniform",
                 t_right_init="glorot_uniform", a_right_init="one",
                 shared_axes=None, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.shared_axes = shared_axes
        self.inits = (t_left_init, a_left_init, t_right_init, a_right_init)

    def _param_shape(self, input_shape):
        shape = [int(d) for d in input_shape[1:]]
        if self.shared_axes:
            for ax in self.shared_axes:
                shape[ax - 1] = 1
        return tuple(shape)

    def build(self, generator, input_shape):
        shape = self._param_shape(input_shape)
        tl, al, tr, ar = [init_tensor(generator, shape, i)
                          for i in self.inits]
        return {"t_left": tl, "a_left": al, "t_right": tr, "a_right": ar}

    def forward(self, x, training=False, **kw):
        tl, al = self.t_left.to(x.dtype), self.a_left.to(x.dtype)
        tr, ar = self.t_right.to(x.dtype), self.a_right.to(x.dtype)
        y = torch.where(x < tl, tl + al * (x - tl), x)
        return torch.where(x > tr, tr + ar * (x - tr), y)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta=1.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.theta = theta

    def forward(self, x, training=False, **kw):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class RReLU(KerasLayer):
    """Randomized leaky ReLU: a slope drawn U(lower, upper) per element
    while training, the mean slope otherwise."""

    stochastic = True

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.lower, self.upper = lower, upper

    def slopes(self, x, generator):
        """The training slopes for ``x``, drawn from ``generator``."""
        u = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32)
        return (self.lower + (self.upper - self.lower) * u).to(x.dtype)

    def forward(self, x, training=False, generator=None, **kw):
        if training and generator is not None:
            a = self.slopes(x, generator)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class Softmax(KerasLayer):
    def __init__(self, axis: int = -1, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.axis = int(axis)

    def forward(self, x, training=False, **kw):
        return torch.softmax(x, dim=self.axis)
