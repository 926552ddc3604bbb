"""Text transformers: tokenize -> normalize -> word2idx -> shape -> sample.

Counterpart of ``analytics_zoo_tpu/feature/text/transformer.py``, a
numpy-only copy (parity: ``zoo/.../feature/text/{Tokenizer,Normalizer,
WordIndexer,SequenceShaper,TextFeatureToSample}.scala``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from ..common import Preprocessing
from ..feature_set import Sample
from .text_feature import TextFeature


class TextTransformer(Preprocessing):
    def apply(self, feature: TextFeature) -> TextFeature:
        return self.transform(feature)

    def transform(self, feature: TextFeature) -> TextFeature:
        raise NotImplementedError


class Tokenizer(TextTransformer):
    """Whitespace split (Tokenizer.scala:28)."""

    def transform(self, feature):
        text = feature.get_text()
        assert text is not None, "TextFeature doesn't contain text"
        feature[TextFeature.tokens] = re.split(r"\s+", text.strip())
        return feature


class Normalizer(TextTransformer):
    """Lower-case + strip non-alphabetical chars, dropping empties
    (Normalizer.scala:32)."""

    def transform(self, feature):
        tokens = feature.get_tokens()
        assert tokens is not None, "please tokenize first"
        normed = [re.sub(r"[^a-z]", "", t.lower()) for t in tokens]
        feature[TextFeature.tokens] = [t for t in normed if t]
        return feature


class WordIndexer(TextTransformer):
    """Map tokens to indices, silently dropping OOV words
    (WordIndexer.scala:36-44)."""

    def __init__(self, word_index: Dict[str, int]):
        assert word_index is not None
        self.word_index = word_index

    def transform(self, feature):
        tokens = feature.get_tokens()
        assert tokens is not None, "please tokenize first"
        idx = [float(self.word_index[t]) for t in tokens
               if t in self.word_index]
        feature[TextFeature.indexed_tokens] = np.asarray(idx, np.float32)
        return feature


class SequenceShaper(TextTransformer):
    """Truncate ('pre' drops the beginning, 'post' the end) or pad (always
    at the end) to a fixed length (SequenceShaper.scala)."""

    def __init__(self, len: int, trunc_mode: str = "pre",
                 pad_element: int = 0):
        assert len > 0, "len should be positive"
        assert trunc_mode in ("pre", "post")
        self.len = int(len)
        self.trunc_mode = trunc_mode
        self.pad_element = pad_element

    def transform(self, feature):
        indices = feature.get_indices()
        assert indices is not None, "please word2idx first"
        n = len(indices)
        if n > self.len:
            shaped = indices[n - self.len:] if self.trunc_mode == "pre" \
                else indices[:self.len]
        else:
            shaped = np.concatenate([
                indices,
                np.full(self.len - n, self.pad_element, np.float32)])
        feature[TextFeature.indexed_tokens] = shaped.astype(np.float32)
        return feature


class TextFeatureToSample(TextTransformer):
    """indexedTokens (+label) -> Sample (TextFeatureToSample.scala)."""

    def transform(self, feature):
        indices = feature.get_indices()
        assert indices is not None, "please word2idx first"
        label = None
        if feature.has_label():
            label = np.asarray([feature.get_label()], np.float32)
        feature[TextFeature.sample] = Sample(indices, label)
        return feature
