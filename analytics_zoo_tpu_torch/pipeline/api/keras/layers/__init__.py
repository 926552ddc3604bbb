from ..engine.base import Input, InputLayer, KerasLayer
from .core import Dense
from .self_attention import BERT, TransformerLayer

__all__ = ["Input", "InputLayer", "KerasLayer", "Dense", "BERT",
           "TransformerLayer"]
