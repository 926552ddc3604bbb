"""Keras-2 layer adapters.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras2/layers.py``
(parity: ``zoo/.../pipeline/api/keras2/layers/*.scala``). Each adapter
translates Keras-2 argument names onto the Keras-1 layer library: one
engine, two argument dialects.
"""

from __future__ import annotations

from typing import Optional

from ..keras import layers as k1
from ..keras.engine.base import Input  # re-export (same object)

_PADDING = {"valid": "valid", "same": "same"}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def Dense(units: int, activation=None, use_bias: bool = True,
          kernel_initializer="glorot_uniform", input_shape=None,
          name: Optional[str] = None, **kw):
    return k1.Dense(units, init=kernel_initializer, activation=activation,
                    bias=use_bias, input_shape=input_shape, name=name)


def Conv1D(filters: int, kernel_size: int, strides: int = 1,
           padding: str = "valid", activation=None, use_bias: bool = True,
           kernel_initializer="glorot_uniform", input_shape=None,
           name=None, **kw):
    return k1.Convolution1D(
        filters, kernel_size, init=kernel_initializer,
        activation=activation, border_mode=_PADDING[padding],
        subsample_length=strides, bias=use_bias,
        input_shape=input_shape, name=name)


def Conv2D(filters: int, kernel_size, strides=(1, 1), padding="valid",
           activation=None, use_bias: bool = True,
           kernel_initializer="glorot_uniform", input_shape=None,
           name=None, **kw):
    kh, kw_ = _pair(kernel_size)
    return k1.Convolution2D(
        filters, kh, kw_, init=kernel_initializer, activation=activation,
        border_mode=_PADDING[padding], subsample=_pair(strides),
        bias=use_bias, input_shape=input_shape, name=name)


def SeparableConv2D(filters: int, kernel_size, strides=(1, 1),
                    padding="valid", activation=None, use_bias=True,
                    depth_multiplier: int = 1, input_shape=None,
                    name=None, **kw):
    kh, kw_ = _pair(kernel_size)
    return k1.SeparableConvolution2D(
        filters, kh, kw_, activation=activation,
        border_mode=_PADDING[padding], subsample=_pair(strides),
        depth_multiplier=depth_multiplier, bias=use_bias,
        input_shape=input_shape, name=name)


def Activation(activation, input_shape=None, name=None, **kw):
    return k1.Activation(activation, input_shape=input_shape, name=name)


def Dropout(rate: float, input_shape=None, name=None, **kw):
    return k1.Dropout(rate, input_shape=input_shape, name=name)


def Flatten(input_shape=None, name=None, **kw):
    return k1.Flatten(input_shape=input_shape, name=name)


def Embedding(input_dim: int, output_dim: int,
              embeddings_initializer="uniform", input_length=None,
              input_shape=None, name=None, **kw):
    return k1.Embedding(input_dim, output_dim,
                        init=embeddings_initializer,
                        input_length=input_length,
                        input_shape=input_shape, name=name)


def BatchNormalization(axis: int = 1, momentum: float = 0.99,
                       epsilon: float = 1e-3, input_shape=None,
                       name=None, **kw):
    return k1.BatchNormalization(epsilon=epsilon, momentum=momentum,
                                 axis=axis, input_shape=input_shape,
                                 name=name)


def MaxPooling1D(pool_size: int = 2, strides=None, padding="valid",
                 input_shape=None, name=None, **kw):
    return k1.MaxPooling1D(pool_length=pool_size, stride=strides,
                           border_mode=_PADDING[padding],
                           input_shape=input_shape, name=name)


def MaxPooling2D(pool_size=(2, 2), strides=None, padding="valid",
                 input_shape=None, name=None, **kw):
    return k1.MaxPooling2D(pool_size=_pair(pool_size),
                           strides=None if strides is None
                           else _pair(strides),
                           border_mode=_PADDING[padding],
                           input_shape=input_shape, name=name)


def AveragePooling1D(pool_size: int = 2, strides=None, padding="valid",
                     input_shape=None, name=None, **kw):
    return k1.AveragePooling1D(pool_length=pool_size, stride=strides,
                               border_mode=_PADDING[padding],
                               input_shape=input_shape, name=name)


def AveragePooling2D(pool_size=(2, 2), strides=None, padding="valid",
                     input_shape=None, name=None, **kw):
    return k1.AveragePooling2D(pool_size=_pair(pool_size),
                               strides=None if strides is None
                               else _pair(strides),
                               border_mode=_PADDING[padding],
                               input_shape=input_shape, name=name)


def GlobalMaxPooling1D(input_shape=None, name=None, **kw):
    return k1.GlobalMaxPooling1D(input_shape=input_shape, name=name)


def GlobalMaxPooling2D(input_shape=None, name=None, **kw):
    return k1.GlobalMaxPooling2D(input_shape=input_shape, name=name)


def GlobalAveragePooling1D(input_shape=None, name=None, **kw):
    return k1.GlobalAveragePooling1D(input_shape=input_shape, name=name)


def GlobalAveragePooling2D(input_shape=None, name=None, **kw):
    return k1.GlobalAveragePooling2D(input_shape=input_shape, name=name)


# -- functional merges (keras-2 style: callable on a list) -----------------

from ..keras.layers.merge import (Add as _Add, Average as _Average,  # noqa
                                  Concatenate as _Concatenate,
                                  Maximum as _Maximum,
                                  Multiply as _Multiply)


def Add(name=None, **kw):
    return _Add(name=name)


def Multiply(name=None, **kw):
    return _Multiply(name=name)


def Average(name=None, **kw):
    return _Average(name=name)


def Maximum(name=None, **kw):
    return _Maximum(name=name)


def Concatenate(axis: int = -1, name=None, **kw):
    return _Concatenate(axis=axis, name=name)


def GlobalMaxPooling3D(input_shape=None, name=None, **kw):
    return k1.GlobalMaxPooling3D(input_shape=input_shape, name=name)


def GlobalAveragePooling3D(input_shape=None, name=None, **kw):
    return k1.GlobalAveragePooling3D(input_shape=input_shape, name=name)


def Cropping1D(cropping=(1, 1), input_shape=None, name=None, **kw):
    return k1.Cropping1D(cropping=cropping, input_shape=input_shape,
                         name=name)


def LocallyConnected1D(filters: int, kernel_size: int, strides: int = 1,
                       padding: str = "valid", activation=None,
                       use_bias: bool = True, input_shape=None, name=None,
                       **kw):
    return k1.LocallyConnected1D(
        filters, kernel_size, activation=activation,
        border_mode=_PADDING[padding], subsample_length=strides,
        bias=use_bias, input_shape=input_shape, name=name)


def Minimum(name=None, **kw):
    return k1.Merge(mode="min", name=name)


def Softmax(axis: int = -1, input_shape=None, name=None, **kw):
    return k1.Softmax(axis=axis, input_shape=input_shape, name=name)


# -- padding / cropping / upsampling ----------------------------------------

def ZeroPadding1D(padding=1, input_shape=None, name=None, **kw):
    return k1.ZeroPadding1D(padding=padding, input_shape=input_shape,
                            name=name)


def ZeroPadding2D(padding=(1, 1), input_shape=None, name=None, **kw):
    return k1.ZeroPadding2D(padding=padding, input_shape=input_shape,
                            name=name)


def ZeroPadding3D(padding=(1, 1, 1), input_shape=None, name=None, **kw):
    return k1.ZeroPadding3D(padding=padding, input_shape=input_shape,
                            name=name)


def Cropping2D(cropping=((0, 0), (0, 0)), input_shape=None, name=None,
               **kw):
    return k1.Cropping2D(cropping=cropping, input_shape=input_shape,
                         name=name)


def Cropping3D(cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
               name=None, **kw):
    return k1.Cropping3D(cropping=cropping, input_shape=input_shape,
                         name=name)


def UpSampling1D(size=2, input_shape=None, name=None, **kw):
    return k1.UpSampling1D(length=size, input_shape=input_shape, name=name)


def UpSampling2D(size=(2, 2), input_shape=None, name=None, **kw):
    return k1.UpSampling2D(size=_pair(size), input_shape=input_shape,
                           name=name)


def UpSampling3D(size=(2, 2, 2), input_shape=None, name=None, **kw):
    return k1.UpSampling3D(size=tuple(size), input_shape=input_shape,
                           name=name)


# Convolution / pooling, 3D + locally-connected

def Conv3D(filters: int, kernel_size, strides=(1, 1, 1), padding="valid",
           activation=None, use_bias: bool = True, input_shape=None,
           name=None, **kw):
    k = kernel_size if isinstance(kernel_size, (list, tuple)) \
        else (kernel_size,) * 3
    return k1.Convolution3D(
        filters, k[0], k[1], k[2], activation=activation,
        border_mode=_PADDING[padding], subsample=tuple(strides)
        if isinstance(strides, (list, tuple)) else (strides,) * 3,
        bias=use_bias, input_shape=input_shape, name=name)


def MaxPooling3D(pool_size=(2, 2, 2), strides=None, padding="valid",
                 input_shape=None, name=None, **kw):
    return k1.MaxPooling3D(pool_size=tuple(pool_size), strides=strides,
                           border_mode=_PADDING[padding],
                           input_shape=input_shape, name=name)


def AveragePooling3D(pool_size=(2, 2, 2), strides=None, padding="valid",
                     input_shape=None, name=None, **kw):
    return k1.AveragePooling3D(pool_size=tuple(pool_size), strides=strides,
                               border_mode=_PADDING[padding],
                               input_shape=input_shape, name=name)


def LocallyConnected2D(filters: int, kernel_size, strides=(1, 1),
                       padding="valid", activation=None,
                       use_bias: bool = True, input_shape=None, name=None,
                       **kw):
    k = _pair(kernel_size)
    return k1.LocallyConnected2D(
        filters, k[0], k[1], activation=activation,
        border_mode=_PADDING[padding], subsample=_pair(strides),
        bias=use_bias, input_shape=input_shape, name=name)


# Recurrent (keras-2: units/recurrent_activation -> keras-1:
# output_dim/inner_activation)

def SimpleRNN(units: int, activation="tanh", return_sequences=False,
              go_backwards=False, input_shape=None, name=None, **kw):
    return k1.SimpleRNN(units, activation=activation,
                        return_sequences=return_sequences,
                        go_backwards=go_backwards,
                        input_shape=input_shape, name=name)


def LSTM(units: int, activation="tanh",
         recurrent_activation="hard_sigmoid", return_sequences=False,
         go_backwards=False, input_shape=None, name=None, **kw):
    return k1.LSTM(units, activation=activation,
                   inner_activation=recurrent_activation,
                   return_sequences=return_sequences,
                   go_backwards=go_backwards, input_shape=input_shape,
                   name=name)


def GRU(units: int, activation="tanh",
        recurrent_activation="hard_sigmoid", return_sequences=False,
        go_backwards=False, input_shape=None, name=None, **kw):
    return k1.GRU(units, activation=activation,
                  inner_activation=recurrent_activation,
                  return_sequences=return_sequences,
                  go_backwards=go_backwards, input_shape=input_shape,
                  name=name)


def Bidirectional(layer, merge_mode="concat", input_shape=None, name=None,
                  **kw):
    return k1.Bidirectional(layer, merge_mode=merge_mode,
                            input_shape=input_shape, name=name)


def TimeDistributed(layer, input_shape=None, name=None, **kw):
    return k1.TimeDistributed(layer, input_shape=input_shape, name=name)


# Shape ops

def Reshape(target_shape, input_shape=None, name=None, **kw):
    return k1.Reshape(target_shape, input_shape=input_shape, name=name)


def Permute(dims, input_shape=None, name=None, **kw):
    return k1.Permute(dims, input_shape=input_shape, name=name)


def RepeatVector(n: int, input_shape=None, name=None, **kw):
    return k1.RepeatVector(n, input_shape=input_shape, name=name)


def Masking(mask_value=0.0, input_shape=None, name=None, **kw):
    return k1.Masking(mask_value=mask_value, input_shape=input_shape,
                      name=name)


# Advanced activations

def LeakyReLU(alpha=0.3, input_shape=None, name=None, **kw):
    return k1.LeakyReLU(alpha=alpha, input_shape=input_shape, name=name)


def PReLU(input_shape=None, name=None, **kw):
    return k1.PReLU(input_shape=input_shape, name=name)


def ELU(alpha=1.0, input_shape=None, name=None, **kw):
    return k1.ELU(alpha=alpha, input_shape=input_shape, name=name)


def ThresholdedReLU(theta=1.0, input_shape=None, name=None, **kw):
    return k1.ThresholdedReLU(theta=theta, input_shape=input_shape,
                              name=name)


# Regularization / noise (keras-2 `rate`/`stddev` -> keras-1 `p`/`sigma`)

def SpatialDropout1D(rate=0.5, input_shape=None, name=None, **kw):
    return k1.SpatialDropout1D(p=rate, input_shape=input_shape, name=name)


def SpatialDropout2D(rate=0.5, input_shape=None, name=None, **kw):
    return k1.SpatialDropout2D(p=rate, input_shape=input_shape, name=name)


def SpatialDropout3D(rate=0.5, input_shape=None, name=None, **kw):
    return k1.SpatialDropout3D(p=rate, input_shape=input_shape, name=name)


def GaussianNoise(stddev, input_shape=None, name=None, **kw):
    return k1.GaussianNoise(sigma=stddev, input_shape=input_shape,
                            name=name)


def GaussianDropout(rate, input_shape=None, name=None, **kw):
    return k1.GaussianDropout(p=rate, input_shape=input_shape, name=name)


# Remaining merge modes

def Subtract(name=None, **kw):
    return k1.Merge(mode="sub", name=name)


def Dot(axes=-1, normalize=False, name=None, **kw):
    """keras-2 Dot onto the engine's dot/cos merge. The merge flattens
    each input to (batch, -1) and dots — identical to keras-2 for rank-2
    inputs with ``axes=-1``; other axes (batched matrix products on
    higher-rank inputs) are not implemented and raise instead of silently
    computing the flattened dot."""
    if axes not in (-1, 1, None):
        raise NotImplementedError(
            f"Dot(axes={axes!r}): only the last-axis vector dot "
            "(axes=-1) is supported")
    return k1.Merge(mode="cos" if normalize else "dot", name=name)
