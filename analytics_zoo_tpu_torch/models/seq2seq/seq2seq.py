"""Seq2seq: a recurrent encoder, an optional bridge and a decoder.

Counterpart of ``analytics_zoo_tpu/models/seq2seq/seq2seq.py`` (parity:
``Seq2seq.scala``, ``RNNEncoder.scala``, ``RNNDecoder.scala``,
``Bridge.scala`` and ``pyzoo/zoo/models/seq2seq/seq2seq.py``). The
encoder emits its sequence output and every layer's final states; the
Bridge maps those to the decoder's initial states (dense,
densenonlinear or customized, Bridge.scala:50-85); the decoder consumes
[decoder_input, initial states]; an optional generator maps its outputs.
``infer`` is the greedy decode of Seq2seq.scala:114-160: the encoder runs
once and the decoder advances one step a token on the carried states
(eager steps where the JAX model jits its step); ``infer_reference`` is
the reference's full re-predict per token, kept as the oracle.

A coder's parameters are the JAX tree's: ``l{i}`` ({W, U, b}) a layer,
and the embedding layer's under ``embedding``. Each ``l{i}`` is a
recurrent layer of ``layers/recurrent.py`` (LSTM [i, f, c, o], Keras-1
GRU [z, r, h]), run from the carried states by its ``run``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...pipeline.api.keras.engine.base import (Input, KerasLayer,
                                               init_tensor)
from ...pipeline.api.keras.layers.recurrent import GRU, LSTM, SimpleRNN
from ...pipeline.api.keras.models import Model
from ..common import ZooModel

_STATES_PER_LAYER = {"lstm": 2, "gru": 1, "simplernn": 1}
_CELLS = {"lstm": LSTM, "gru": GRU, "simplernn": SimpleRNN}


class _RNNCoder(KerasLayer):
    """Shared machinery: an optional embedding and ``nlayers`` stacked
    recurrent layers, submodules ``l{i}`` that return their sequences."""

    def __init__(self, rnn_type="lstm", nlayers=1, hidden_size=None,
                 embedding=None, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.rnn_type = str(rnn_type).lower()
        if self.rnn_type not in _STATES_PER_LAYER:
            raise ValueError(
                f"rnn_type must be simplernn | lstm | gru, got {rnn_type}")
        self.nlayers = int(nlayers)
        self.hidden_size = int(hidden_size)
        self.embedding = embedding
        self.states_per_layer = _STATES_PER_LAYER[self.rnn_type]
        self.n_states = self.nlayers * self.states_per_layer
        for l in range(self.nlayers):
            self.add_module(f"l{l}", _CELLS[self.rnn_type](
                self.hidden_size, return_sequences=True, name=f"l{l}"))

    @classmethod
    def initialize(cls, rnn_type, nlayers, hidden_size, embedding=None,
                   input_shape=None):
        """Parity: RNNEncoder.initialize / RNNDecoder.initialize
        (seq2seq.py:70-79)."""
        return cls(rnn_type, nlayers, hidden_size, embedding=embedding,
                   input_shape=input_shape)

    @staticmethod
    def _x_shape(input_shape):
        return input_shape

    def _layers(self):
        return [self._modules[f"l{l}"] for l in range(self.nlayers)]

    def build_params(self, generator, input_shape) -> None:
        self.built = True
        shape = self._x_shape(input_shape)
        if self.embedding is not None:
            if not self.embedding.built:
                self.embedding.build_params(generator, shape)
            shape = self.embedding.compute_output_shape(shape)
        for layer in self._layers():
            if not layer.built:
                layer.build_params(generator, shape)
            shape = layer.compute_output_shape(shape)

    def _embed(self, x, training):
        if self.embedding is None:
            return x
        return self.embedding(x, training=training)

    def _run_stack(self, x, states=None):
        """x: (B, T, D) through the stack from ``states`` (n_states (B, H)
        tensors; None: zeros). Returns (the last layer's sequence, the
        final states)."""
        spl = self.states_per_layer
        finals: List[torch.Tensor] = []
        for l, layer in enumerate(self._layers()):
            carry = None
            if states is not None:
                carry = tuple(s.to(x.dtype)
                              for s in states[l * spl:(l + 1) * spl])
                carry = carry if spl > 1 else carry[0]
            carry, x = layer.run(x, carry)
            finals.extend(carry if spl > 1 else (carry,))
        return x, finals

    def step(self, xt, states):
        """One decode timestep: xt (B, D_in) and the n_states (B, H)
        states -> (the output (B, H), the new states). The recurrent
        state is the cache, so each token costs one step."""
        y, states = self._run_stack(self._embed(xt[:, None], False), states)
        return y[:, 0], states


class RNNEncoder(_RNNCoder):
    """Outputs: [seq_output (B, T, H)] + every layer's final states (lstm:
    h then c), so ``num_outputs = 1 + nlayers * states_per_layer``: the
    reference's T(rnnOutput, T(states)) (RNNEncoder.scala:73-80) as graph
    edges."""

    @property
    def num_outputs(self):
        return 1 + self.n_states

    def forward(self, x, training=False, **kw):
        seq, finals = self._run_stack(self._embed(x, training), None)
        return (seq,) + tuple(finals)

    def compute_output_shape(self, s):
        if self.embedding is not None:
            s = self.embedding.compute_output_shape(s)
        seq_shape = (s[0], s[1], self.hidden_size)
        state_shape = (s[0], self.hidden_size)
        return [seq_shape] + [state_shape] * self.n_states


class RNNDecoder(_RNNCoder):
    """Inputs: [decoder_input, init_state_1, ..., init_state_N]; output
    the decoded sequence (B, T, H)."""

    @staticmethod
    def _x_shape(input_shape):
        return input_shape[0]

    def forward(self, inputs, training=False, **kw):
        x, states = inputs[0], list(inputs[1:])
        seq, _ = self._run_stack(self._embed(x, training), states)
        return seq

    def compute_output_shape(self, s):
        x_shape = s[0]
        if self.embedding is not None:
            x_shape = self.embedding.compute_output_shape(x_shape)
        return (x_shape[0], x_shape[1], self.hidden_size)


class Bridge(KerasLayer):
    """Maps the encoder's final states to the decoder's initial states
    (Bridge.scala:50-85): the states concatenated, one bias-free dense of
    ``decoder_hidden_size * n_states`` ("dense": linear,
    "densenonlinear": tanh), split back into n_states; "customized"
    applies a caller's layer to the concatenation and splits its output
    evenly.

    ``n_states`` is taken from the inputs the bridge is called on (the
    JAX Bridge needs Seq2seq to set it, so the JAX package cannot rebuild
    a saved Seq2seq with a bridge; ROADMAP C7)."""

    def __init__(self, bridge_type="dense", decoder_hidden_size=0,
                 bridge=None, name=None, **kwargs):
        super().__init__(name=name)
        self.bridge_type = str(bridge_type).lower()
        if self.bridge_type not in ("dense", "densenonlinear", "customized"):
            raise ValueError(
                "Only support dense | densenonlinear | customized as "
                f"bridge_type, got {bridge_type}")
        self.decoder_hidden_size = int(decoder_hidden_size)
        self.bridge = bridge
        self.n_states = None

    @classmethod
    def initialize(cls, bridge_type, decoder_hidden_size):
        return cls(bridge_type, decoder_hidden_size)

    @classmethod
    def initialize_from_keras_layer(cls, bridge):
        return cls("customized", 0, bridge)

    @property
    def num_outputs(self):
        if self.n_states is None:
            raise ValueError("the Bridge's state count is set when it is "
                             "called on the encoder's states")
        return self.n_states

    @staticmethod
    def _shapes(input_shapes):
        return list(input_shapes) if isinstance(input_shapes[0],
                                                (list, tuple)) \
            else [input_shapes]

    def build_params(self, generator, input_shapes) -> None:
        shapes = self._shapes(input_shapes)
        if self.bridge_type != "customized":
            return super().build_params(generator, input_shapes)
        self.built = True
        if not self.bridge.built:
            total_in = sum(int(s[-1]) for s in shapes)
            self.bridge.build_params(generator, (shapes[0][0], total_in))

    def build(self, generator, input_shapes):
        shapes = self._shapes(input_shapes)
        total_in = sum(int(s[-1]) for s in shapes)
        total_out = self.decoder_hidden_size * len(shapes)
        self._annotate(W=("in", "out"))
        return {"W": init_tensor(generator, (total_in, total_out))}

    def forward(self, states, training=False, **kw):
        if not isinstance(states, (list, tuple)):
            states = [states]
        cat = torch.cat(list(states), dim=-1)
        if self.bridge_type == "customized":
            out = self.bridge(cat, training=training)
        else:
            out = torch.matmul(cat, self.W.to(cat.dtype))
            if self.bridge_type == "densenonlinear":
                out = torch.tanh(out)
        if len(states) == 1:
            return out
        return tuple(torch.tensor_split(out, len(states), dim=-1))

    def compute_output_shape(self, input_shapes):
        shapes = self._shapes(input_shapes)
        n = self.n_states = len(shapes)
        if self.bridge_type == "customized":
            total_in = sum(int(s[-1]) for s in shapes)
            out = self.bridge.compute_output_shape((shapes[0][0], total_in))
            per = int(out[-1]) // n
            outs = [(s[0], per) for s in shapes]
        else:
            outs = [(s[0], self.decoder_hidden_size) for s in shapes]
        return outs[0] if n == 1 else outs


class Seq2seq(ZooModel):
    """Arguments (seq2seq.py:158-183): encoder, decoder, input_shape (no
    batch dim), output_shape, optional bridge and generator layers."""

    def __init__(self, encoder, decoder, input_shape, output_shape,
                 bridge=None, generator=None):
        if input_shape is None or output_shape is None:
            raise TypeError("input_shape and output_shape cannot be None")
        self.encoder = encoder
        self.decoder = decoder
        self.input_shape_ = list(input_shape)
        self.output_shape_ = list(output_shape)
        self.bridge = bridge
        self.generator = generator
        self._record_config(input_shape_=self.input_shape_,
                            output_shape_=self.output_shape_)
        self.model = self.build_model()

    def build_model(self):
        encoder_input = Input(shape=tuple(self.input_shape_),
                              name="encoder_input")
        decoder_input = Input(shape=tuple(self.output_shape_),
                              name="decoder_input")
        enc_outs = self.encoder(encoder_input)
        states = list(enc_outs[1:])
        if self.bridge is not None:
            mapped = self.bridge(states)
            states = list(mapped) if isinstance(mapped, tuple) else [mapped]
        dec_out = self.decoder([decoder_input] + states)
        out = self.generator(dec_out) if self.generator is not None \
            else dec_out
        return Model([encoder_input, decoder_input], out)

    def infer(self, input, start_sign, max_seq_len=30, stop_sign=None,
              build_output=None):
        """Greedy decode (Seq2seq.scala:114-160) on the context's device.

        * input: (T_in, feat) or (B, T_in, feat) encoder input.
        * start_sign: (feat,), fed as the first decoder step.
        * stop_sign: stop early when the newest prediction matches it
          (per row: a finished row repeats its stop token while the rest
          of the batch decodes on).
        * build_output: optional callable mapping the model's output
          sequence (numpy) before the last timestep is taken.

        Returns the decoded sequence (B, T_out, ...) as numpy, start sign
        included: ``infer_reference``'s, with the encoder run once and
        one decoder step a token on the carried recurrent states.
        """
        input = np.asarray(input, np.float32)
        if input.ndim == len(self.input_shape_):
            input = input[None]
        device = self.model._ensure_trainer().device
        self.model.to(device)
        b = input.shape[0]
        start = np.asarray(start_sign, np.float32)[None, None]
        cur = np.broadcast_to(start, (b, 1) + start.shape[2:]).copy()
        outs = [cur]
        stop = None if stop_sign is None \
            else np.asarray(stop_sign, np.float32)
        done = np.zeros((b,), bool)
        with torch.inference_mode():
            enc_outs = self.encoder(torch.from_numpy(input).to(device),
                                    training=False)
            states = list(enc_outs[1:])
            if self.bridge is not None:
                mapped = self.bridge(states, training=False)
                states = list(mapped) if isinstance(mapped, tuple) \
                    else [mapped]
            xt = torch.from_numpy(cur[:, 0]).to(device)
            for _ in range(max_seq_len):
                y, states = self.decoder.step(xt, states)
                out = y[:, None]
                if self.generator is not None:
                    out = self.generator(out, training=False)
                out_np = out.float().cpu().numpy()
                if build_output is not None:
                    out_np = np.asarray(build_output(out_np))
                nxt = out_np[:, -1:]
                if done.any():
                    # finished rows repeat their stop token; their states
                    # advance but their outputs are pinned
                    nxt = np.where(
                        done.reshape((b,) + (1,) * (nxt.ndim - 1)),
                        outs[-1][:, -1:], nxt)
                outs.append(nxt)
                if stop is not None:
                    done |= np.array([np.allclose(nxt[i, 0], stop,
                                                  atol=1e-8)
                                      for i in range(b)])
                    if done.all():
                        break
                xt = torch.from_numpy(np.ascontiguousarray(
                    nxt[:, 0])).to(device)
        return np.concatenate(outs, axis=1)

    def infer_reference(self, input, start_sign, max_seq_len=30,
                        stop_sign=None, build_output=None):
        """The reference's loop, the whole model re-run on the prefix for
        every token: the oracle for ``infer`` (and its batch-1 early-stop
        semantics)."""
        input = np.asarray(input, np.float32)
        if input.ndim == len(self.input_shape_):
            input = input[None]
        start = np.asarray(start_sign, np.float32)[None, None]
        cur = start
        for _ in range(max_seq_len):
            pred_seq = self.model.predict([input, cur], batch_size=1)
            if build_output is not None:
                pred_seq = build_output(pred_seq)
            nxt = np.asarray(pred_seq)[:, -1:]
            cur = np.concatenate([cur, nxt], axis=1)
            if stop_sign is not None and np.allclose(
                    nxt[0, 0], np.asarray(stop_sign, np.float32), atol=1e-8):
                break
        return cur
