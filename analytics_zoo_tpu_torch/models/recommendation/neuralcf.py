"""NeuralCF (neural collaborative filtering).

Counterpart of ``analytics_zoo_tpu/models/recommendation/neuralcf.py``
(parity: ``pyzoo/zoo/models/recommendation/neuralcf.py`` /
``zoo/.../models/recommendation/NeuralCF.scala:45`` — MLP tower over user +
item embeddings, optional matrix-factorization (GMF) branch, softmax head).
Input: float array of shape (batch, 2) = [user_id, item_id].
"""

from __future__ import annotations

from ...pipeline.api.keras.layers import (Dense, Embedding, Flatten, Input,
                                          Select, merge)
from ...pipeline.api.keras.models import Model
from .recommender import Recommender


class NeuralCF(Recommender):
    def __init__(self, user_count, item_count, class_num, user_embed=20,
                 item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
                 mf_embed=20):
        self._record_config(
            user_count=int(user_count), item_count=int(item_count),
            class_num=int(class_num), user_embed=int(user_embed),
            item_embed=int(item_embed),
            hidden_layers=[int(u) for u in hidden_layers],
            include_mf=include_mf, mf_embed=int(mf_embed))
        self.model = self.build_model()

    def build_model(self):
        input = Input(shape=(2,))
        user_flat = Flatten()(Select(1, 0)(input))
        item_flat = Flatten()(Select(1, 1)(input))

        mlp_user = Flatten()(Embedding(self.user_count + 1, self.user_embed,
                                       init="uniform")(user_flat))
        mlp_item = Flatten()(Embedding(self.item_count + 1, self.item_embed,
                                       init="uniform")(item_flat))
        mlp_latent = merge([mlp_user, mlp_item], mode="concat")
        linear = Dense(self.hidden_layers[0], activation="relu")(mlp_latent)
        for units in self.hidden_layers[1:]:
            linear = Dense(units, activation="relu")(linear)

        if self.include_mf:
            assert self.mf_embed > 0
            mf_user = Flatten()(Embedding(self.user_count + 1, self.mf_embed,
                                          init="uniform")(user_flat))
            mf_item = Flatten()(Embedding(self.item_count + 1, self.mf_embed,
                                          init="uniform")(item_flat))
            mf_latent = merge([mf_user, mf_item], mode="mul")
            concated = merge([linear, mf_latent], mode="concat")
            out = Dense(self.class_num, activation="softmax")(concated)
        else:
            out = Dense(self.class_num, activation="softmax")(linear)
        return Model(input, out)
