"""IntentEntity: joint intent classification + slot filling.

Counterpart of ``analytics_zoo_tpu/tfpark/text/keras/intent_extraction.py``
(parity target ``pyzoo/zoo/tfpark/text/keras/intent_extraction.py``,
nlp_architect MultiTaskIntentModel). Built on the port's layers: word
embedding ∥ char-BiLSTM features → shared BiLSTM encoder → (a) intent
softmax from the mean-pooled encoder states, (b) per-token slot softmax
from a tagger BiLSTM."""

from __future__ import annotations

from typing import Optional

from ....pipeline.api.keras.engine.base import Input
from ....pipeline.api.keras.layers import LSTM, Bidirectional, Dense, \
    Embedding
from ....pipeline.api.keras.layers.self_attention import _dropout
from ....pipeline.api.keras.models import Model
from .text_model import TextKerasModel, _SubLayerNet


class _IntentNet(_SubLayerNet):
    """Inputs: [word (B,L), chars (B,L,W)] →
    (intent (B,I), tags (B,L,E))."""

    num_outputs = 2

    def __init__(self, num_intents, num_entities, word_vocab_size,
                 char_vocab_size, word_emb_dim=100, char_emb_dim=30,
                 char_lstm_dim=30, tagger_lstm_dim=100, dropout=0.2,
                 input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name)
        self.num_intents = num_intents
        self.num_entities = num_entities
        self.dropout = dropout
        self._keep(
            word_emb=Embedding(word_vocab_size, word_emb_dim),
            char_emb=Embedding(char_vocab_size, char_emb_dim),
            char_lstm=Bidirectional(LSTM(char_lstm_dim,
                                         return_sequences=False)),
            encoder=Bidirectional(LSTM(tagger_lstm_dim,
                                       return_sequences=True)),
            tagger=Bidirectional(LSTM(tagger_lstm_dim,
                                      return_sequences=True)),
            intent_out=Dense(num_intents, activation="softmax"),
            tags_out=Dense(num_entities, activation="softmax"))
        self._dims = (word_emb_dim, char_emb_dim, char_lstm_dim,
                      tagger_lstm_dim)
        self._set_subs([self.word_emb, self.char_emb, self.char_lstm,
                        self.encoder, self.tagger, self.intent_out,
                        self.tags_out])

    def _sub_shapes(self):
        we, ce, cl, tl = self._dims
        return [(None, None), (None, None), (None, None, ce),
                (None, None, we + 2 * cl), (None, None, 2 * tl),
                (None, 2 * tl), (None, 2 * tl)]

    def compute_output_shape(self, input_shape):
        words = input_shape[0]
        return [(words[0], self.num_intents),
                (words[0], words[1], self.num_entities)]

    def forward(self, inputs, training=False, generator=None, **kw):
        words, chars = inputs
        x = self._chars_to_words(words.long(), chars.long(), training)
        x = _dropout(x, self.dropout, generator, training)
        enc = self.encoder(x, training=training)
        # intent from mean-pooled encoder states (mask-free pooling)
        intent = self.intent_out(enc.mean(dim=1))
        tags = self.tags_out(self.tagger(enc, training=training))
        return intent, tags


class IntentEntity(TextKerasModel):
    """Joint intent + slot model (intent_extraction.py parity surface)."""

    def __init__(self, num_intents, num_entities, word_vocab_size,
                 char_vocab_size, word_length=12, word_emb_dim=100,
                 char_emb_dim=30, char_lstm_dim=30, tagger_lstm_dim=100,
                 dropout=0.2, optimizer=None, seq_len: Optional[int] = None):
        net = _IntentNet(num_intents, num_entities, word_vocab_size,
                         char_vocab_size, word_emb_dim=word_emb_dim,
                         char_emb_dim=char_emb_dim,
                         char_lstm_dim=char_lstm_dim,
                         tagger_lstm_dim=tagger_lstm_dim, dropout=dropout)
        words = Input(shape=(seq_len,), name="words")
        chars = Input(shape=(seq_len, word_length), name="chars")
        intent, tags = net([words, chars])
        super().__init__(Model([words, chars], [intent, tags]), optimizer,
                         losses=["sparse_categorical_crossentropy"] * 2)

    @staticmethod
    def load_model(path):
        return IntentEntity._load_model(path)
