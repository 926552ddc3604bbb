"""TextFeature: keyed per-document record.

Counterpart of ``analytics_zoo_tpu/feature/text/text_feature.py``, a
numpy-only copy (parity: ``zoo/.../feature/text/TextFeature.scala``):
holds text, uri, label, tokens, indexedTokens, the generated Sample and
predict results.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class TextFeature(dict):
    text = "text"
    uri = "uri"
    label = "label"
    tokens = "tokens"
    indexed_tokens = "indexedTokens"
    sample = "sample"
    predict = "predict"

    def __init__(self, text: Optional[str] = None,
                 label: Optional[int] = None, uri: Optional[str] = None):
        super().__init__()
        if text is not None:
            self[self.text] = text
        if label is not None:
            self[self.label] = int(label)
        if uri is not None:
            self[self.uri] = uri

    def get_text(self) -> Optional[str]:
        return self.get(self.text)

    def get_label(self) -> int:
        return self.get(self.label, -1)

    def set_label(self, label: int):
        self[self.label] = int(label)
        return self

    def has_label(self) -> bool:
        return self.label in self

    def get_uri(self):
        return self.get(self.uri)

    def get_tokens(self) -> Optional[List[str]]:
        return self.get(self.tokens)

    def get_indices(self) -> Optional[np.ndarray]:
        return self.get(self.indexed_tokens)

    def get_sample(self):
        return self.get(self.sample)

    def get_predict(self):
        return self.get(self.predict)

    def keys_set(self):
        return set(self.keys())
