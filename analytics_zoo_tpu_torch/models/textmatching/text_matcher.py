"""TextMatcher base.

Counterpart of ``analytics_zoo_tpu/models/textmatching/text_matcher.py``
(parity: ``TextMatcher.scala``): the common surface of text-matching
models: query length, vocabulary and embedding configuration, and the
'ranking' or 'classification' target mode.
"""

from __future__ import annotations

import numpy as np

from ..common import Ranker, ZooModel


class TextMatcher(ZooModel, Ranker):
    TARGET_MODES = ("ranking", "classification")

    def __init__(self, text1_length, vocab_size, embed_size=300,
                 embed_weights=None, train_embed=True, target_mode="ranking"):
        if target_mode not in self.TARGET_MODES:
            raise ValueError(
                f"target_mode must be one of {self.TARGET_MODES}, "
                f"got {target_mode}")
        self.text1_length = int(text1_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embed_weights = None if embed_weights is None else \
            np.asarray(embed_weights, np.float32)
        self.train_embed = bool(train_embed)
        self.target_mode = target_mode
