"""Keras-2 style API.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras2/`` (reference:
``zoo/.../pipeline/api/keras2/``): each Keras-2 layer is a constructor
adapter over the Keras-1 layer library with the Keras-2 argument names
(``units``, ``filters``, ``kernel_size``, ``padding``, ``rate``...); the
models add the Keras-2 ``fit`` dialect over the same engine.
"""

from .layers import (Activation, Add, Average, AveragePooling1D,
                     AveragePooling2D, AveragePooling3D,
                     BatchNormalization, Bidirectional, Concatenate,
                     Conv1D, Conv2D, Conv3D, Cropping1D, Cropping2D,
                     Cropping3D, Dense, Dot, Dropout, ELU, Embedding,
                     Flatten, GRU, GaussianDropout, GaussianNoise,
                     GlobalAveragePooling1D, GlobalAveragePooling2D,
                     GlobalAveragePooling3D, GlobalMaxPooling1D,
                     GlobalMaxPooling2D, GlobalMaxPooling3D, Input,
                     LSTM, LeakyReLU, LocallyConnected1D,
                     LocallyConnected2D, Masking, MaxPooling1D,
                     MaxPooling2D, MaxPooling3D, Maximum, Minimum,
                     Multiply, PReLU, Permute, RepeatVector, Reshape,
                     SeparableConv2D, SimpleRNN, Softmax,
                     SpatialDropout1D, SpatialDropout2D, SpatialDropout3D,
                     Subtract, ThresholdedReLU, TimeDistributed,
                     UpSampling1D, UpSampling2D, UpSampling3D,
                     ZeroPadding1D, ZeroPadding2D, ZeroPadding3D)
from .models import Model, Sequential

__all__ = [
    'Input', 'Dense', 'Conv1D', 'Conv2D', 'Conv3D', 'SeparableConv2D',
    'Activation', 'Dropout', 'Flatten', 'Embedding', 'BatchNormalization',
    'MaxPooling1D', 'MaxPooling2D', 'MaxPooling3D', 'AveragePooling1D',
    'AveragePooling2D', 'AveragePooling3D', 'GlobalMaxPooling1D',
    'GlobalMaxPooling2D', 'GlobalMaxPooling3D', 'GlobalAveragePooling1D',
    'GlobalAveragePooling2D', 'GlobalAveragePooling3D', 'Add', 'Subtract',
    'Multiply', 'Average', 'Maximum', 'Minimum', 'Concatenate', 'Dot',
    'Model', 'Sequential', 'Cropping1D', 'Cropping2D', 'Cropping3D',
    'ZeroPadding1D', 'ZeroPadding2D', 'ZeroPadding3D', 'UpSampling1D',
    'UpSampling2D', 'UpSampling3D', 'LocallyConnected1D',
    'LocallyConnected2D', 'SimpleRNN', 'LSTM', 'GRU', 'Bidirectional',
    'TimeDistributed', 'Reshape', 'Permute', 'RepeatVector', 'Masking',
    'LeakyReLU', 'PReLU', 'ELU', 'ThresholdedReLU', 'SpatialDropout1D',
    'SpatialDropout2D', 'SpatialDropout3D', 'GaussianNoise',
    'GaussianDropout', 'Softmax',
]
