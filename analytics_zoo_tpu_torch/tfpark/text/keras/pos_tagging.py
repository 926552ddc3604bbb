"""SequenceTagger: POS + chunk multi-task tagger.

Counterpart of ``analytics_zoo_tpu/tfpark/text/keras/pos_tagging.py``
(parity target ``pyzoo/zoo/tfpark/text/keras/pos_tagging.py``, delegating
to nlp_architect chunker.SequenceTagger). Built on the port's layers:
word embedding (∥ optional char features) → three stacked BiLSTMs → two
per-token heads (pos, chunk), each either softmax (the nlp_architect
default) or a linear-chain CRF (``classifier='crf'``; math in
``ops/crf.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....pipeline.api.keras.engine.base import Input
from ....pipeline.api.keras.layers import CRF, LSTM, Bidirectional, \
    Dense, Embedding
from ....pipeline.api.keras.layers.self_attention import _dropout
from ....pipeline.api.keras.models import Model
from ....pipeline.api.keras.objectives import LossFunction
from .text_model import TextKerasModel, _SubLayerNet


class _TaggerNet(_SubLayerNet):
    """Inputs: [word (B,L)] or [word, chars (B,L,W)] →
    (pos (B,L,P), chunk (B,L,C))."""

    num_outputs = 2

    def __init__(self, num_pos_labels, num_chunk_labels, word_vocab_size,
                 char_vocab_size=None, feature_size=100, dropout=0.2,
                 use_crf=False, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.num_pos = num_pos_labels
        self.num_chunk = num_chunk_labels
        self.has_char = char_vocab_size is not None
        self.dropout = dropout
        self.use_crf = use_crf
        self._keep(word_emb=Embedding(word_vocab_size, feature_size))
        subs = [self.word_emb]
        in_dim = feature_size
        if self.has_char:
            self._keep(char_emb=Embedding(char_vocab_size, feature_size // 4),
                       char_lstm=Bidirectional(LSTM(feature_size // 4,
                                                    return_sequences=False)))
            subs += [self.char_emb, self.char_lstm]
            in_dim += feature_size // 2
        self._keep(rnns=[Bidirectional(LSTM(feature_size,
                                            return_sequences=True))
                         for _ in range(3)])
        act = None if use_crf else "softmax"
        self._keep(pos_out=Dense(num_pos_labels, activation=act),
                   chunk_out=Dense(num_chunk_labels, activation=act))
        subs += self.rnns + [self.pos_out, self.chunk_out]
        if use_crf:
            self._keep(pos_crf=CRF(num_pos_labels),
                       chunk_crf=CRF(num_chunk_labels))
            subs += [self.pos_crf, self.chunk_crf]
            self.num_outputs = 4
        self._in_dim = in_dim
        self.feature_size = feature_size
        self._set_subs(subs)

    def _sub_shapes(self):
        f = self.feature_size
        shapes = [(None, None)]
        if self.has_char:
            shapes += [(None, None), (None, None, f // 4)]
        shapes += [(None, None, self._in_dim), (None, None, 2 * f),
                   (None, None, 2 * f), (None, 2 * f), (None, 2 * f)]
        if self.use_crf:
            shapes += [(None, None, self.num_pos),
                       (None, None, self.num_chunk)]
        return shapes

    def compute_output_shape(self, input_shape):
        words = input_shape[0] if isinstance(input_shape, list) else \
            input_shape
        base = (words[0], words[1])
        if not self.use_crf:
            return [base + (self.num_pos,), base + (self.num_chunk,)]
        return [base + (self.num_pos,),
                (words[0], self.num_pos, self.num_pos),
                base + (self.num_chunk,),
                (words[0], self.num_chunk, self.num_chunk)]

    def forward(self, inputs, training=False, generator=None, **kw):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        words = inputs[0].long()
        if self.has_char:
            x = self._chars_to_words(words, inputs[1].long(), training)
        else:
            x = self.word_emb(words)
        x = _dropout(x, self.dropout, generator, training)
        for rnn in self.rnns:
            x = rnn(x, training=training)
        pos = self.pos_out(x)
        chunk = self.chunk_out(x)
        if not self.use_crf:
            return pos, chunk
        pos_u, pos_t = self.pos_crf(pos)
        chunk_u, chunk_t = self.chunk_crf(chunk)
        return pos_u, pos_t, chunk_u, chunk_t


class _DualCRFLoss(LossFunction):
    """Sum of two CRF negative log-likelihoods over the tagger's
    [pos_unary, pos_trans, chunk_unary, chunk_trans] outputs."""

    def per_sample(self, y_pred, y_true):
        from ....ops.crf import crf_log_likelihood

        pos_u, pos_t, chunk_u, chunk_t = y_pred
        pos_y, chunk_y = y_true
        nll = -crf_log_likelihood(pos_u, pos_y.int(), pos_t[0])
        return nll - crf_log_likelihood(chunk_u, chunk_y.int(), chunk_t[0])


class SequenceTagger(TextKerasModel):
    """POS-tagger + chunker (pos_tagging.py parity surface)."""

    def __init__(self, num_pos_labels, num_chunk_labels, word_vocab_size,
                 char_vocab_size=None, word_length=12, feature_size=100,
                 dropout=0.2, classifier="softmax", optimizer=None,
                 seq_len: Optional[int] = None):
        classifier = classifier.lower()
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier should be either softmax or crf")
        self.classifier = classifier
        self.num_pos = num_pos_labels
        self.num_chunk = num_chunk_labels
        use_crf = classifier == "crf"
        net = _TaggerNet(num_pos_labels, num_chunk_labels, word_vocab_size,
                         char_vocab_size=char_vocab_size,
                         feature_size=feature_size, dropout=dropout,
                         use_crf=use_crf)
        words = Input(shape=(seq_len,), name="words")
        ins = [words]
        if char_vocab_size is not None:
            ins.append(Input(shape=(seq_len, word_length), name="chars"))
        outs = net(ins)
        if use_crf:
            super().__init__(Model(ins, list(outs)), optimizer,
                             losses=[_DualCRFLoss()])
        else:
            pos, chunk = outs
            super().__init__(Model(ins, [pos, chunk]), optimizer,
                             losses=["sparse_categorical_crossentropy"] * 2)

    def predict(self, x, batch_size: int = 128, distributed: bool = True):
        outs = self.model.predict(x, batch_size=batch_size)
        # mode + tag counts derived from the outputs (4 = CRF pairs, 2 =
        # softmax heads) so this survives load_model's __init__-bypassing
        # reconstruction (TextKerasModel._load_model uses cls.__new__)
        if len(outs) != 4:
            return outs
        pos_tags = CRF.decode(outs[0], outs[1])
        chunk_tags = CRF.decode(outs[2], outs[3])
        return [np.eye(outs[0].shape[-1], dtype=np.float32)[pos_tags],
                np.eye(outs[2].shape[-1], dtype=np.float32)[chunk_tags]]

    @staticmethod
    def load_model(path):
        return SequenceTagger._load_model(path)
