"""CRF sequence-labeling head.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/crf.py``
(the head of the reference's NER: nlp_architect's NERCRF). The math is
``ops/crf.py``. The losses see only model outputs, so the layer emits
``[unary (B, L, E) float32, transitions (B, E, E)]`` (the transitions
broadcast over the batch) and ``CRFLoss`` consumes the pair; decoding
goes through :meth:`CRF.decode`.
"""

from __future__ import annotations

import numpy as np
import torch

from .....ops import crf as crf_ops
from ..engine.base import KerasLayer


class CRF(KerasLayer):
    """Linear-chain CRF over per-token scores; the transitions start at
    zero."""

    num_outputs = 2

    def __init__(self, num_tags, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        self.num_tags = int(num_tags)

    def build(self, generator, input_shape):
        return {"trans": torch.zeros(self.num_tags, self.num_tags)}

    def forward(self, x, training=False, **kw):
        b = x.shape[0]
        trans = self.trans.float()[None].expand(b, self.num_tags,
                                                self.num_tags)
        return x.float(), trans

    def compute_output_shape(self, input_shape):
        return [tuple(input_shape),
                (input_shape[0], self.num_tags, self.num_tags)]

    @staticmethod
    def decode(unary, trans, mask=None):
        """Viterbi-decode model outputs: ``(B, L)`` best tags (numpy)."""
        unary = torch.as_tensor(np.asarray(unary)) \
            if not isinstance(unary, torch.Tensor) else unary
        trans = torch.as_tensor(np.asarray(trans)) \
            if not isinstance(trans, torch.Tensor) else trans
        trans = trans[0] if trans.dim() == 3 else trans
        if mask is not None and not isinstance(mask, torch.Tensor):
            mask = torch.as_tensor(np.asarray(mask))
        tags, _ = crf_ops.crf_decode(unary, trans.to(unary.device),
                                     None if mask is None
                                     else mask.to(unary.device))
        return tags.cpu().numpy()
