"""NER: BiLSTM-CRF tagger over word + per-word character features.

Counterpart of ``analytics_zoo_tpu/tfpark/text/keras/ner.py`` (parity
target ``pyzoo/zoo/tfpark/text/keras/ner.py``, which delegates to
nlp_architect's NERCRF). Built on the port's layers: word embedding ∥
char-BiLSTM word features → two stacked BiLSTM taggers → linear-chain
CRF head (``ops/crf.py``: the forward algorithm and Viterbi, plain
torch). ``crf_mode='reg'`` scores every position; ``crf_mode='pad'``
takes an extra sequence-length input and masks pad positions out of the
likelihood and the decode — the two modes nlp_architect's NERCRF has.
The parameter keys are the JAX net's (``sub{i}_{class}``), so weights and
saved models carry over between the packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....pipeline.api.keras.engine.base import Input
from ....pipeline.api.keras.layers import CRF, LSTM, Bidirectional, Dense, \
    Embedding
from ....pipeline.api.keras.layers.self_attention import _dropout
from ....pipeline.api.keras.models import Model
from .text_model import TextKerasModel, _SubLayerNet


class _NERNet(_SubLayerNet):
    """Inputs: [word (B,L), chars (B,L,W)] (+ seq_lens (B,) in 'pad' mode)
    → softmax tags (B,L,E), or CRF outputs [unary, trans(, mask)]."""

    def __init__(self, num_entities, word_vocab_size, char_vocab_size,
                 word_length=12, word_emb_dim=100, char_emb_dim=30,
                 tagger_lstm_dim=100, dropout=0.5, use_crf=False,
                 crf_mode="reg", input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.num_entities = num_entities
        self.dropout = dropout
        self.use_crf = use_crf
        self.crf_mode = crf_mode
        self._keep(
            word_emb=Embedding(word_vocab_size, word_emb_dim),
            char_emb=Embedding(char_vocab_size, char_emb_dim),
            char_lstm=Bidirectional(LSTM(char_emb_dim,
                                         return_sequences=False)),
            tagger1=Bidirectional(LSTM(tagger_lstm_dim,
                                       return_sequences=True)),
            tagger2=Bidirectional(LSTM(tagger_lstm_dim,
                                       return_sequences=True)),
            # CRF consumes raw scores; the softmax path mirrors
            # nlp_architect's default dense head
            out=Dense(num_entities,
                      activation=None if use_crf else "softmax"))
        subs = [self.word_emb, self.char_emb, self.char_lstm, self.tagger1,
                self.tagger2, self.out]
        if use_crf:
            self._keep(crf=CRF(num_entities))
            subs.append(self.crf)
            self.num_outputs = 3 if crf_mode == "pad" else 2
        self._dims = (word_emb_dim, char_emb_dim, tagger_lstm_dim)
        self._set_subs(subs)

    def _sub_shapes(self):
        word_emb_dim, char_emb_dim, tagger_dim = self._dims
        shapes = [
            (None, None), (None, None),          # embeddings ignore shape
            (None, None, char_emb_dim),          # char lstm over word chars
            (None, None, word_emb_dim + 2 * char_emb_dim),
            (None, None, 2 * tagger_dim),
            (None, 2 * tagger_dim),
        ]
        if self.use_crf:
            shapes.append((None, None, self.num_entities))
        return shapes

    def compute_output_shape(self, input_shape):
        words = input_shape[0]
        seq = (words[0], words[1], self.num_entities)
        if not self.use_crf:
            return seq
        outs = [seq, (words[0], self.num_entities, self.num_entities)]
        if self.crf_mode == "pad":
            outs.append((words[0], words[1]))
        return outs

    def forward(self, inputs, training=False, generator=None, **kw):
        words, chars = inputs[0].long(), inputs[1].long()
        b, l = words.shape
        x = self._chars_to_words(words, chars, training)
        x = _dropout(x, self.dropout, generator, training)
        x = self.tagger1(x, training=training)
        x = self.tagger2(x, training=training)
        scores = self.out(x)
        if not self.use_crf:
            return scores
        unary, trans = self.crf(scores)
        if self.crf_mode == "pad":
            lens = inputs[2].long().reshape(b)
            mask = (torch.arange(l, device=lens.device)[None, :]
                    < lens[:, None]).float()
            return unary, trans, mask
        return unary, trans


class NER(TextKerasModel):
    """BiLSTM-CRF named-entity tagger (ner.py parity surface).

    Inputs: word indices (B, L) + char indices (B, L, word_length), plus
    sequence lengths (B,) when ``crf_mode='pad'``.  ``predict`` returns
    one-hot Viterbi decodes (B, L, num_entities); ``predict_tags`` returns
    integer tags (B, L).
    """

    def __init__(self, num_entities, word_vocab_size, char_vocab_size,
                 word_length=12, word_emb_dim=100, char_emb_dim=30,
                 tagger_lstm_dim=100, dropout=0.5, crf_mode="reg",
                 optimizer=None, seq_len: Optional[int] = None):
        if crf_mode not in ("reg", "pad"):
            raise ValueError("crf_mode should be either 'reg' or 'pad'")
        self.num_entities = num_entities
        self.crf_mode = crf_mode
        net = _NERNet(num_entities, word_vocab_size, char_vocab_size,
                      word_length=word_length, word_emb_dim=word_emb_dim,
                      char_emb_dim=char_emb_dim,
                      tagger_lstm_dim=tagger_lstm_dim, dropout=dropout,
                      use_crf=True, crf_mode=crf_mode)
        words = Input(shape=(seq_len,), name="words")
        chars = Input(shape=(seq_len, word_length), name="chars")
        ins = [words, chars]
        if crf_mode == "pad":
            ins.append(Input(shape=(), name="seq_lens"))
        outs = net(ins)
        from ....pipeline.api.keras.objectives import CRFLoss
        super().__init__(Model(ins, list(outs)), optimizer,
                         losses=[CRFLoss()])

    @staticmethod
    def _decode_outputs(outs):
        unary, trans = outs[0], outs[1]
        mask = outs[2] if len(outs) > 2 else None
        tags = CRF.decode(unary, trans, mask)
        if mask is not None:
            tags = tags * np.asarray(mask).astype(tags.dtype)
        return tags

    def predict_tags(self, x, batch_size: int = 128):
        """Viterbi-decoded integer tags (B, L)."""
        return self._decode_outputs(
            self.model.predict(x, batch_size=batch_size))

    def predict(self, x, batch_size: int = 128, distributed: bool = True):
        outs = self.model.predict(x, batch_size=batch_size)
        tags = self._decode_outputs(outs)
        # tag count from the outputs: survives load_model's
        # __init__-bypassing reconstruction
        return np.eye(outs[0].shape[-1], dtype=np.float32)[tags]

    @staticmethod
    def load_model(path):
        return NER._load_model(path)
