from ..engine.base import Input, InputLayer, KerasLayer
from .advanced_activations import (ELU, LeakyReLU, PReLU, RReLU, Softmax,
                                   SReLU, ThresholdedReLU)
from .convolutional import (AtrousConvolution1D, AtrousConvolution2D,
                            Convolution1D, Convolution2D, Convolution3D,
                            Cropping1D, Cropping2D, Cropping3D,
                            Deconvolution2D, LocallyConnected1D,
                            LocallyConnected2D, SeparableConvolution2D,
                            ShareConvolution2D, UpSampling1D, UpSampling2D,
                            UpSampling3D, ZeroPadding1D, ZeroPadding2D,
                            ZeroPadding3D)
from .core import (AddConstant, Activation, BinaryThreshold, CAdd, CMul,
                   Dense, Dropout, Exp, Expand, ExpandDim, Flatten,
                   GaussianDropout, GaussianNoise, GaussianSampler, GetShape,
                   HardShrink, HardTanh, Highway, Identity, Log, Masking, Max,
                   MaxoutDense, Mul, MulConstant, Narrow, Negative, Permute,
                   Power, RepeatVector, Reshape, ResizeBilinear, Scale,
                   Select, SelectTable, SoftShrink, SparseDense,
                   SpatialDropout1D, SpatialDropout2D, SpatialDropout3D,
                   SplitTensor, Sqrt, Square, Squeeze, Threshold)
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
from .crf import CRF
from .moe import SparseMoE
from .recurrent import GRU, LSTM, ConvLSTM2D, ConvLSTM3D, SimpleRNN
from .self_attention import BERT, TransformerLayer
from .wrappers import Bidirectional, KerasLayerWrapper, TimeDistributed

Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D

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
           "TimeDistributed", "Bidirectional", "KerasLayerWrapper",
           "WordEmbedding",
           "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D",
           "Reshape", "Permute", "RepeatVector", "Masking", "Highway",
           "MaxoutDense", "Narrow", "Squeeze", "ExpandDim", "Identity",
           "Max", "SplitTensor", "Exp", "Log", "Sqrt", "Square",
           "Negative", "Power", "AddConstant", "MulConstant", "CAdd",
           "CMul", "Mul", "Scale", "BinaryThreshold", "Threshold",
           "HardTanh", "HardShrink", "SoftShrink", "GaussianNoise",
           "GaussianDropout", "GaussianSampler", "ResizeBilinear",
           "SparseDense", "SelectTable", "Expand", "GetShape", "ELU",
           "LeakyReLU", "PReLU", "RReLU", "Softmax", "SReLU",
           "ThresholdedReLU", "Convolution3D", "Conv3D", "Deconvolution2D",
           "ShareConvolution2D", "LocallyConnected1D", "LocallyConnected2D",
           "Cropping3D", "UpSampling3D", "ZeroPadding3D", "ConvLSTM2D",
           "ConvLSTM3D", "CRF", "SparseMoE"]
