from ..engine.base import Input, InputLayer, KerasLayer
from .core import Activation, Dense, Flatten, Select
from .embeddings import Embedding, SparseEmbedding
from .merge import (Add, Average, Concatenate, Maximum, Merge, Multiply,
                    merge)
from .self_attention import BERT, TransformerLayer

__all__ = ["Input", "InputLayer", "KerasLayer", "Activation", "Dense",
           "Flatten", "Select", "Embedding", "SparseEmbedding", "Merge",
           "merge", "Add", "Multiply", "Average", "Maximum", "Concatenate",
           "BERT", "TransformerLayer"]
