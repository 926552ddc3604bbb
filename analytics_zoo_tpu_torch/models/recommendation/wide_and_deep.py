"""Wide-and-Deep recommender.

Counterpart of ``analytics_zoo_tpu/models/recommendation/wide_and_deep.py``
(parity: ``pyzoo/zoo/models/recommendation/wide_and_deep.py``:
ColumnFeatureInfo + WideAndDeep with model_type wide|deep|wide_n_deep).
The wide branch is a linear layer over (sparse-ish) one/multi-hot wide
features; the deep branch embeds categorical columns and concatenates
indicators/continuous values into an MLP.

Inputs (matching the reference's 4-tensor layout):
  wide   (batch, sum(wide_base_dims)+sum(wide_cross_dims))
  ind    (batch, sum(indicator_dims))
  embed  (batch, len(embed_cols))
  cont   (batch, len(continuous_cols))
The model consumes [wide, ind, embed, cont] (subset per model_type).
"""

from __future__ import annotations

from ...pipeline.api.keras.layers import (Activation, Dense, Embedding,
                                          Flatten, Input, Select, merge)
from ...pipeline.api.keras.models import Model
from .recommender import Recommender


class ColumnFeatureInfo:
    """Schema shared by the model and feature generation (see reference
    docstring for field meanings)."""

    def __init__(self, wide_base_cols=None, wide_base_dims=None,
                 wide_cross_cols=None, wide_cross_dims=None,
                 indicator_cols=None, indicator_dims=None, embed_cols=None,
                 embed_in_dims=None, embed_out_dims=None,
                 continuous_cols=None, label="label"):
        self.wide_base_cols = list(wide_base_cols or [])
        self.wide_base_dims = [int(d) for d in (wide_base_dims or [])]
        self.wide_cross_cols = list(wide_cross_cols or [])
        self.wide_cross_dims = [int(d) for d in (wide_cross_dims or [])]
        self.indicator_cols = list(indicator_cols or [])
        self.indicator_dims = [int(d) for d in (indicator_dims or [])]
        self.embed_cols = list(embed_cols or [])
        self.embed_in_dims = [int(d) for d in (embed_in_dims or [])]
        self.embed_out_dims = [int(d) for d in (embed_out_dims or [])]
        self.continuous_cols = list(continuous_cols or [])
        self.label = label

    def __repr__(self):
        return f"ColumnFeatureInfo({self.__dict__})"


class WideAndDeep(Recommender):
    def __init__(self, class_num, column_info: ColumnFeatureInfo,
                 model_type="wide_n_deep", hidden_layers=(40, 20, 10)):
        ci = column_info
        assert len(ci.wide_base_cols) == len(ci.wide_base_dims)
        assert len(ci.wide_cross_cols) == len(ci.wide_cross_dims)
        assert len(ci.indicator_cols) == len(ci.indicator_dims)
        assert len(ci.embed_cols) == len(ci.embed_in_dims) == \
            len(ci.embed_out_dims)
        self._record_config(
            class_num=int(class_num), model_type=model_type,
            hidden_layers=[int(u) for u in hidden_layers],
            wide_base_dims=ci.wide_base_dims,
            wide_cross_dims=ci.wide_cross_dims,
            indicator_dims=ci.indicator_dims,
            embed_in_dims=ci.embed_in_dims,
            embed_out_dims=ci.embed_out_dims,
            continuous_cols=ci.continuous_cols)
        self.model = self.build_model()

    # -- branches ------------------------------------------------------
    def _deep_branch(self, input_ind, input_emb, input_con):
        merge_list = []
        inputs = []
        if sum(self.indicator_dims) > 0:
            merge_list.append(input_ind)
            inputs.append(input_ind)
        if self.embed_in_dims:
            inputs.append(input_emb)
            for i, (in_dim, out_dim) in enumerate(
                    zip(self.embed_in_dims, self.embed_out_dims)):
                col = Flatten()(Select(1, i)(input_emb))
                emb = Flatten()(Embedding(in_dim + 1, out_dim,
                                          init="uniform")(col))
                merge_list.append(emb)
        if self.continuous_cols:
            merge_list.append(input_con)
            inputs.append(input_con)
        deep = merge_list[0] if len(merge_list) == 1 else \
            merge(merge_list, mode="concat")
        for units in self.hidden_layers:
            deep = Dense(units, activation="relu")(deep)
        return inputs, Dense(self.class_num)(deep)

    def build_model(self):
        wide_dims = sum(self.wide_base_dims) + sum(self.wide_cross_dims)
        input_wide = Input(shape=(wide_dims,), name="wide_input")
        input_ind = Input(shape=(sum(self.indicator_dims),),
                          name="indicator_input")
        input_emb = Input(shape=(len(self.embed_in_dims),),
                          name="embed_input")
        input_con = Input(shape=(len(self.continuous_cols),),
                          name="continuous_input")

        wide_linear = Dense(self.class_num)(input_wide)
        if self.model_type == "wide":
            out = Activation("softmax")(wide_linear)
            return Model(input_wide, out)
        if self.model_type == "deep":
            deep_inputs, deep_linear = self._deep_branch(
                input_ind, input_emb, input_con)
            out = Activation("softmax")(deep_linear)
            return Model(deep_inputs, out)
        if self.model_type == "wide_n_deep":
            deep_inputs, deep_linear = self._deep_branch(
                input_ind, input_emb, input_con)
            both = merge([wide_linear, deep_linear], mode="sum")
            out = Activation("softmax")(both)
            return Model([input_wide] + deep_inputs, out)
        raise ValueError(f"Unsupported model_type: {self.model_type}")
