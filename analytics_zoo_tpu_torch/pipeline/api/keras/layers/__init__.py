from ..engine.base import Input, InputLayer, KerasLayer
from .convolutional import (AtrousConvolution1D, AtrousConvolution2D,
                            Convolution1D, Convolution2D, Cropping1D,
                            Cropping2D, SeparableConvolution2D, UpSampling1D,
                            UpSampling2D, ZeroPadding1D, ZeroPadding2D)
from .core import Activation, Dense, Dropout, Flatten, Select
from .embeddings import Embedding, SparseEmbedding, WordEmbedding
from .merge import (Add, Average, Concatenate, Maximum, Merge, Multiply,
                    merge)
from .normalization import (LRN2D, BatchNormalization, LayerNorm,
                            WithinChannelLRN2D)
from .pooling import (AveragePooling1D, AveragePooling2D, AveragePooling3D,
                      GlobalAveragePooling1D, GlobalAveragePooling2D,
                      GlobalAveragePooling3D, GlobalMaxPooling1D,
                      GlobalMaxPooling2D, GlobalMaxPooling3D, MaxPooling1D,
                      MaxPooling2D, MaxPooling3D)
from .recurrent import GRU, LSTM, SimpleRNN
from .self_attention import BERT, TransformerLayer
from .wrappers import Bidirectional, TimeDistributed

Conv1D = Convolution1D
Conv2D = Convolution2D

__all__ = ["Input", "InputLayer", "KerasLayer", "Activation", "Dense",
           "Dropout", "Flatten", "Select", "Embedding", "SparseEmbedding",
           "Merge", "merge", "Add", "Multiply", "Average", "Maximum",
           "Concatenate", "BERT", "TransformerLayer", "Convolution1D",
           "Convolution2D", "AtrousConvolution1D", "AtrousConvolution2D",
           "SeparableConvolution2D", "Conv1D", "Conv2D", "Cropping1D",
           "Cropping2D", "UpSampling1D", "UpSampling2D", "ZeroPadding1D",
           "ZeroPadding2D", "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
           "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
           "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D",
           "GlobalAveragePooling3D", "BatchNormalization", "LayerNorm",
           "LRN2D", "WithinChannelLRN2D", "SimpleRNN", "LSTM", "GRU",
           "TimeDistributed", "Bidirectional", "WordEmbedding"]
