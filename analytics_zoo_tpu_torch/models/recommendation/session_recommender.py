"""SessionRecommender: a GRU over the session's clicks, and an optional
MLP over the purchase history.

Counterpart of ``analytics_zoo_tpu/models/recommendation/
session_recommender.py`` (parity:
``pyzoo/zoo/models/recommendation/session_recommender.py``). With the
history, its embeddings are summed over time by a ``Lambda``, so that
model is not saved by definition (``UnserializableConfig``; the JAX
package falls back to pickle, which a lambda defeats there too).
"""

from __future__ import annotations

import numpy as np
import torch

from ...feature.feature_set import FeatureSet, Sample
from ...pipeline.api.autograd import Lambda
from ...pipeline.api.keras.layers import (GRU, Activation, Dense, Embedding,
                                          Input, merge)
from ...pipeline.api.keras.models import Model
from .recommender import Recommender


def _sum_over_time(x):
    return torch.sum(x, dim=1)


class SessionRecommender(Recommender):
    def __init__(self, item_count, item_embed, rnn_hidden_layers=(40, 20),
                 session_length=0, include_history=False,
                 mlp_hidden_layers=(40, 20), history_length=0):
        if session_length <= 0:
            raise ValueError("session_length should align with input "
                             "features")
        if include_history and history_length <= 0:
            raise ValueError("include_history needs history_length > 0")
        self._record_config(
            item_count=int(item_count), item_embed=int(item_embed),
            rnn_hidden_layers=[int(u) for u in rnn_hidden_layers],
            session_length=int(session_length),
            include_history=include_history,
            mlp_hidden_layers=[int(u) for u in mlp_hidden_layers],
            history_length=int(history_length))
        self.model = self.build_model()

    def build_model(self):
        input_rnn = Input(shape=(self.session_length,))
        gru = Embedding(self.item_count + 1, self.item_embed,
                        init="uniform")(input_rnn)
        for units in self.rnn_hidden_layers[:-1]:
            gru = GRU(units, return_sequences=True)(gru)
        gru_last = GRU(self.rnn_hidden_layers[-1],
                       return_sequences=False)(gru)
        rnn = Dense(self.item_count)(gru_last)

        if self.include_history:
            input_mlp = Input(shape=(self.history_length,))
            his_table = Embedding(self.item_count + 1, self.item_embed,
                                  init="uniform")(input_mlp)
            mlp = Lambda(_sum_over_time)(his_table)
            for units in self.mlp_hidden_layers:
                mlp = Dense(units, activation="relu")(mlp)
            mlp_last = Dense(self.item_count)(mlp)
            merged = merge([rnn, mlp_last], mode="sum")
            out = Activation("softmax")(merged)
            return Model([input_rnn, input_mlp], out)
        out = Activation("softmax")(rnn)
        return Model(input_rnn, out)

    # session models rank items directly, not user-item pairs
    def recommend_for_user(self, features, max_items):
        raise Exception("recommend_for_user: Unsupported for "
                        "SessionRecommender")

    def recommend_for_item(self, features, max_users):
        raise Exception("recommend_for_item: Unsupported for "
                        "SessionRecommender")

    def predict_user_item_pair(self, features):
        raise Exception("predict_user_item_pair: Unsupported for "
                        "SessionRecommender")

    def recommend_for_session(self, sessions, max_items: int,
                              zero_based_label: bool = True):
        """sessions: Samples or arrays. Each session's top ``max_items``
        (item, probability) pairs, most probable first."""
        if isinstance(sessions, (list, tuple)) and sessions and \
                isinstance(sessions[0], Sample):
            fs = FeatureSet.samples(sessions)
            x = fs.features if len(fs.features) > 1 else fs.features[0]
        else:
            x = np.asarray(sessions)
        probs = np.asarray(self.model.predict(x))
        offset = 0 if zero_based_label else 1
        out = []
        for row in probs:
            top = np.argsort(-row)[:max_items]
            out.append([(int(i) + offset, float(row[i])) for i in top])
        return out
