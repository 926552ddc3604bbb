from .text_feature import TextFeature
from .text_set import DistributedTextSet, LocalTextSet, TextSet
from .transformer import (Normalizer, SequenceShaper, TextFeatureToSample,
                          TextTransformer, Tokenizer, WordIndexer)

__all__ = ["TextFeature", "TextSet", "LocalTextSet", "DistributedTextSet",
           "TextTransformer", "Tokenizer", "Normalizer", "WordIndexer",
           "SequenceShaper", "TextFeatureToSample"]
