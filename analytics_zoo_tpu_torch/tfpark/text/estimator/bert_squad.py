"""BERTSQuAD (counterpart of ``analytics_zoo_tpu/tfpark/text/estimator/
bert_squad.py``; parity: pyzoo/zoo/tfpark/text/estimator/bert_squad.py):
start/end-position softmax heads over the BERT sequence output. The JAX
heads' ``Lambda``s of jnp functions are ``Lambda``s of the torch
functions below (module-level, so the graph pickles)."""

from __future__ import annotations

import torch

from ....pipeline.api.autograd import Lambda
from ....pipeline.api.keras.layers import Dense
from .bert_base import BERTBaseEstimator


def split_start_end(t):
    """(B, L, 2) logits -> the start and end logits, (B, L) each."""
    return t[..., 0], t[..., 1]


def softmax_last(t):
    return torch.softmax(t, dim=-1)


class BERTSQuAD(BERTBaseEstimator):
    """Outputs (start_probs (B, L), end_probs (B, L)); labels are
    (start_positions, end_positions) int vectors."""

    def __init__(self, optimizer="adam", **kwargs):
        def head(seq, pooled):
            logits = Dense(2)(seq)                      # (B, L, 2)
            start, end = Lambda(split_start_end, num_outputs=2)(logits)
            soft = Lambda(softmax_last)
            return [soft(start), soft(end)]

        super().__init__(
            head_fn=head,
            loss=["sparse_categorical_crossentropy"] * 2,
            optimizer=optimizer, **kwargs)
