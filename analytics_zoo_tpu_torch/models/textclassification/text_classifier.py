"""TextClassifier.

Counterpart of ``analytics_zoo_tpu/models/textclassification/
text_classifier.py`` (parity: ``TextClassifier.scala:40-69`` /
``pyzoo/zoo/models/textclassification/text_classifier.py``): a
``WordEmbedding`` (or raw token features) into a cnn, lstm or gru
encoder, Dense(128), dropout 0.2 and relu, and a softmax head.
"""

from __future__ import annotations

import numpy as np

from ...pipeline.api.keras.layers import (GRU, LSTM, Activation, Convolution1D,
                                          Dense, Dropout, GlobalMaxPooling1D,
                                          InputLayer, WordEmbedding)
from ...pipeline.api.keras.models import Sequential
from ..common import ZooModel


class TextClassifier(ZooModel):
    """Text classification with an embedding first layer.

    * class_num: number of categories.
    * embedding: a path to a GloVe file (``glove.6B.*d.txt``), a numpy
      (vocab, dim) table, or an int ``token_length``: the inputs are then
      pre-embedded float features of shape (sequence_length,
      token_length) (the reference's deprecated token_length constructor,
      TextClassifier.scala:49).
    * word_index: {word: 1-based index} when loading from a GloVe file.
    * sequence_length: length of each input sequence (default 500).
    * encoder: "cnn" | "lstm" | "gru" (default "cnn").
    * encoder_output_dim: output dim of the encoder (default 256).
    """

    def __init__(self, class_num, embedding, word_index=None,
                 sequence_length=500, encoder="cnn", encoder_output_dim=256):
        self.class_num = int(class_num)
        self.sequence_length = int(sequence_length)
        self.encoder = str(encoder).lower()
        self.encoder_output_dim = int(encoder_output_dim)
        if isinstance(embedding, (int, np.integer)):
            self.token_length = int(embedding)
            self.embedding = None
        elif isinstance(embedding, str):
            self.embedding = WordEmbedding(embedding, word_index,
                                           input_length=sequence_length)
            self.token_length = self.embedding.output_dim
        else:
            self.embedding = WordEmbedding(
                weights=np.asarray(embedding, np.float32),
                input_length=sequence_length)
            self.token_length = self.embedding.output_dim
        self._record_config(class_num=self.class_num,
                            sequence_length=self.sequence_length,
                            encoder=self.encoder,
                            encoder_output_dim=self.encoder_output_dim,
                            token_length=self.token_length)
        self.model = self.build_model()

    def build_model(self):
        model = Sequential()
        if self.embedding is not None:
            model.add(self.embedding)
        else:
            model.add(InputLayer(
                input_shape=(self.sequence_length, self.token_length)))
        if self.encoder == "cnn":
            model.add(Convolution1D(self.encoder_output_dim, 5,
                                    activation="relu"))
            model.add(GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            model.add(LSTM(self.encoder_output_dim))
        elif self.encoder == "gru":
            model.add(GRU(self.encoder_output_dim))
        else:
            raise ValueError(
                f"Unsupported encoder for TextClassifier: {self.encoder}")
        model.add(Dense(128))
        model.add(Dropout(0.2))
        model.add(Activation("relu"))
        model.add(Dense(self.class_num, activation="softmax"))
        return model
