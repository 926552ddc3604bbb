"""Recurrent layers: SimpleRNN, LSTM, GRU.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
recurrent.py`` (parity: SimpleRNN.scala, LSTM.scala, GRU.scala with
Keras-1 semantics: activation tanh, inner activation hard_sigmoid
``clip(0.2x + 0.5, 0, 1)``, ``return_sequences``, ``go_backwards``). The
parameters are the JAX layer's: ``W`` (in, gates*H), ``U`` (H, gates*H),
orthogonal, and ``b`` (gates*H); LSTM's gates are [i, f, c, o] with the
forget-gate bias 1, GRU's [z, r, h].

The JAX layer runs its time loop as one ``lax.scan``. Here the loop is
eager Python over the timesteps: the input projection ``x @ W + b`` of all
timesteps is one matmul before it, unbound into timesteps
(:func:`timesteps`), and each step launches the recurrent matmul and the
cell's elementwise work (an LSTM step ~10 kernels forward, about three
times that backward: a launch-bound loop on the card, ROADMAP A16). An
elementwise inner activation is applied once over the whole gate block;
one that is not (``softmax``, a caller's function) once a gate, as the
JAX cell applies it (:func:`gate_activation`). Neither cuDNN's RNN nor
``torch.nn.LSTM``/``GRU`` computes these cells: their gates are the
logistic sigmoid, and their GRU applies ``r`` after ``U_h`` where the
Keras-1 GRU multiplies ``h_prev`` by ``r`` before it.

``ConvLSTM2D``/``ConvLSTM3D`` are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch

from ..engine.base import KerasLayer, get_activation_fn, init_tensor


def scan(cell, carry, xs, reverse=False, collect=True):
    """``lax.scan`` of ``cell(carry, xt) -> (carry, yt)`` over the
    per-timestep inputs ``xs`` (:func:`timesteps`), last step first when
    ``reverse``. Returns the final carry and, when ``collect``, the
    outputs stacked (B, T, ...) in the order they were computed (else
    None)."""
    ys = []
    for xt in (reversed(xs) if reverse else xs):
        carry, y = cell(carry, xt)
        if collect:
            ys.append(y)
    return carry, (torch.stack(ys, dim=1) if collect else None)


def timesteps(xw, U, parts=None):
    """A cell's inputs: the projected inputs ``xw`` (B, T, G) unbound into
    T timesteps and the recurrent ``U``; with ``parts`` (widths along the
    gate axis), each timestep and ``U`` split into those parts. Unbinding
    gives all the timesteps one backward (a stack) where indexing a
    timestep would give each its own zero-filled (B, T, G) gradient, to
    be summed T times; splitting once does the same for the gate parts a
    cell uses apart."""
    if parts is None:
        return xw.unbind(1), U
    return (list(zip(*(p.unbind(1) for p in xw.split(parts, dim=-1)))),
            U.split(parts, dim=1))


#: activations of ``ACTIVATIONS`` that are not elementwise
_ROWWISE = ("softmax", "log_softmax")


def gate_activation(name, width):
    """The inner activation over a block of gates ``width`` wide each:
    one call over the block when it is elementwise, else one a gate."""
    fn = get_activation_fn(name)
    if name is None or isinstance(name, str) and \
            name.lower() not in _ROWWISE:
        return fn
    return lambda z: torch.cat([fn(g) for g in z.split(width, dim=-1)],
                               dim=-1)


def simple_rnn_step(h_prev, xt, U, act, inner=None):
    ht = act(torch.addmm(xt, h_prev, U))
    return ht, ht


def lstm_step(carry, xt, U, act, inner):
    """One LSTM step; ``carry`` is (h, c). Gates [i, f, c, o]."""
    h_prev, c_prev = carry
    hd = h_prev.shape[-1]
    z = torch.addmm(xt, h_prev, U)
    # the inner activation over the gate block (its c part goes unused)
    i, f, _, o = inner(z).split(hd, dim=1)
    g = act(z[:, 2 * hd:3 * hd])
    c = torch.addcmul(f * c_prev, i, g)
    ht = o * act(c)
    return (ht, c), ht


def gru_step(h_prev, xt, U, act, inner):
    """One Keras-1 GRU step over the parts ([z, r], [h]) of the timestep
    and of ``U``; ``r`` scales ``h_prev`` before ``U_h``, and
    ``z * h_prev + (1 - z) * hh`` is one ``lerp``."""
    (x_zr, x_h), (U_zr, U_h) = xt, U
    z, r = inner(torch.addmm(x_zr, h_prev, U_zr)).split(h_prev.shape[-1],
                                                        dim=1)
    hh = act(torch.addmm(x_h, r * h_prev, U_h))
    ht = torch.lerp(hh, h_prev, z)
    return ht, ht


class _RNNBase(KerasLayer):
    gates = 1
    step = staticmethod(simple_rnn_step)

    @staticmethod
    def parts(h):
        """The gate-axis widths the cell uses apart (None: the whole
        block)."""
        return None

    def __init__(self, output_dim, activation="tanh", return_sequences=False,
                 go_backwards=False, W_regularizer=None, U_regularizer=None,
                 b_regularizer=None, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.activation = get_activation_fn(activation)
        self.inner_activation = None
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def compute_output_shape(self, s):
        if self.return_sequences:
            return (s[0], s[1], self.output_dim)
        return (s[0], self.output_dim)

    def build(self, generator, input_shape):
        d, h = int(input_shape[-1]), self.output_dim
        return {"W": init_tensor(generator, (d, self.gates * h)),
                "U": init_tensor(generator, (h, self.gates * h),
                                 "orthogonal"),
                "b": torch.zeros(self.gates * h)}

    def initial_carry(self, x):
        return torch.zeros((x.shape[0], self.output_dim), dtype=x.dtype,
                           device=x.device)

    def run(self, x, carry=None):
        """The recurrence over ``x`` (B, T, D) from ``carry`` (LSTM: (h,
        c); None: zeros): the final carry and, when
        ``return_sequences``, the outputs (B, T, H) in input order (else
        None)."""
        xw = torch.matmul(x, self.W.to(x.dtype)) + self.b.to(x.dtype)
        xs, U = timesteps(xw, self.U.to(x.dtype),
                          self.parts(self.output_dim))
        act, inner = self.activation, self.inner_activation

        def cell(carry, xt):
            return self.step(carry, xt, U, act, inner)

        carry, ys = scan(cell, self.initial_carry(x) if carry is None
                         else carry, xs, reverse=self.go_backwards,
                         collect=self.return_sequences)
        # go_backwards hands the outputs back in input order
        if ys is not None and self.go_backwards:
            ys = ys.flip(1)
        return carry, ys

    def forward(self, x, training=False, **kw):
        carry, ys = self.run(x)
        if self.return_sequences:
            return ys
        return carry[0] if isinstance(carry, tuple) else carry


class SimpleRNN(_RNNBase):
    pass


class LSTM(_RNNBase):
    """Gate order [i, f, c, o] (Keras-1 convention)."""

    gates = 4
    step = staticmethod(lstm_step)

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, W_regularizer=None, U_regularizer=None,
                 b_regularizer=None, input_shape=None, name=None, **kwargs):
        super().__init__(output_dim, activation=activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, input_shape=input_shape,
                         name=name)
        self.inner_activation = gate_activation(inner_activation,
                                                self.output_dim)

    def build(self, generator, input_shape):
        params = super().build(generator, input_shape)
        h = self.output_dim
        params["b"][h:2 * h] = 1.0     # forget-gate bias, as BigDL's
        return params

    def initial_carry(self, x):
        zeros = super().initial_carry(x)
        return zeros, torch.zeros_like(zeros)


class GRU(_RNNBase):
    """Gate order [z, r, h] (Keras-1 convention)."""

    gates = 3
    step = staticmethod(gru_step)

    @staticmethod
    def parts(h):
        return [2 * h, h]

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, W_regularizer=None, U_regularizer=None,
                 b_regularizer=None, input_shape=None, name=None, **kwargs):
        super().__init__(output_dim, activation=activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, input_shape=input_shape,
                         name=name)
        self.inner_activation = gate_activation(inner_activation,
                                                self.output_dim)
