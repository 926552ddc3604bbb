"""ImageClassifier model family.

Counterpart of ``analytics_zoo_tpu/models/image/imageclassification/
image_classifier.py`` (parity: ``zoo/.../models/image/imageclassification/
ImageClassifier.scala``). The reference downloads pretrained BigDL graphs
by tag; like the JAX package, the port builds the architectures natively
(NCHW, and NHWC for resnet-50) with random weights from the context's
seed, which train from scratch or copy from the JAX package
(``utils.load_jax_params`` with ``state=`` for the moving statistics).
The default pre-processing waits for the image pipeline (ROADMAP A11),
so ``config.pre_processor`` is None; the label post-processing comes
over.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ....pipeline.api.keras.layers import (Activation, Add,
                                           BatchNormalization, Concatenate,
                                           Convolution2D, Dense, Dropout,
                                           Flatten, GlobalAveragePooling2D,
                                           Input, MaxPooling2D,
                                           SeparableConvolution2D,
                                           ZeroPadding2D)
from ....pipeline.api.keras.models import Model, Sequential
from ..common import ImageConfigure, ImageModel, LabelOutput

backbones: Dict[str, Callable] = {}


def _backbone(name):
    def deco(fn):
        backbones[name] = fn
        return fn
    return deco


def _conv_bn(x, filters, k, stride=1, pad="same", name=None,
             activation="relu", fmt="th"):
    x = Convolution2D(filters, k, k, subsample=(stride, stride),
                      border_mode=pad, bias=False, name=name,
                      dim_ordering=fmt)(x)
    x = BatchNormalization(axis=1 if fmt == "th" else -1,
                           name=None if name is None else name + "_bn")(x)
    if activation:
        x = Activation(activation)(x)
    return x


@_backbone("lenet")
def _lenet(class_num, shape=(1, 28, 28)):
    model = Sequential()
    model.add(Convolution2D(6, 5, 5, activation="tanh", input_shape=shape,
                            border_mode="same"))
    model.add(MaxPooling2D((2, 2)))
    model.add(Convolution2D(12, 5, 5, activation="tanh"))
    model.add(MaxPooling2D((2, 2)))
    model.add(Flatten())
    model.add(Dense(100, activation="tanh"))
    model.add(Dense(class_num, activation="softmax"))
    return model


@_backbone("vgg-16")
def _vgg16(class_num, shape=(3, 224, 224)):
    model = Sequential()
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    first = True
    for v in cfg:
        if v == "M":
            model.add(MaxPooling2D((2, 2)))
        else:
            kw = {"input_shape": shape} if first else {}
            model.add(Convolution2D(v, 3, 3, activation="relu",
                                    border_mode="same", **kw))
            first = False
    model.add(Flatten())
    model.add(Dense(4096, activation="relu"))
    model.add(Dropout(0.5))
    model.add(Dense(4096, activation="relu"))
    model.add(Dropout(0.5))
    model.add(Dense(class_num, activation="softmax"))
    return model


@_backbone("mobilenet")
def _mobilenet(class_num, shape=(3, 224, 224), alpha=1.0):
    def depth(d):
        return max(8, int(d * alpha))

    inp = Input(shape=shape)
    x = _conv_bn(inp, depth(32), 3, stride=2)
    for filters, stride in [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                            (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                            (512, 1), (1024, 2), (1024, 1)]:
        x = SeparableConvolution2D(
            depth(filters), 3, 3, subsample=(stride, stride),
            border_mode="same", bias=False)(x)
        x = BatchNormalization()(x)
        x = Activation("relu")(x)
    x = GlobalAveragePooling2D()(x)
    out = Dense(class_num, activation="softmax")(x)
    return Model(inp, out)


def _res_block(x, filters, stride=1, conv_shortcut=False, fmt="th"):
    bn_axis = 1 if fmt == "th" else -1
    shortcut = x
    if conv_shortcut:
        shortcut = Convolution2D(4 * filters, 1, 1,
                                 subsample=(stride, stride),
                                 bias=False, dim_ordering=fmt)(x)
        shortcut = BatchNormalization(axis=bn_axis)(shortcut)
    y = _conv_bn(x, filters, 1, stride=stride, fmt=fmt)
    y = _conv_bn(y, filters, 3, pad="same", fmt=fmt)
    y = Convolution2D(4 * filters, 1, 1, bias=False, dim_ordering=fmt)(y)
    y = BatchNormalization(axis=bn_axis)(y)
    y = Add()([y, shortcut])
    return Activation("relu")(y)


@_backbone("resnet-50")
def _resnet50(class_num, shape=(3, 224, 224), data_format="th"):
    """ResNet-50: the 7x7 stem, [3, 4, 6, 3] bottleneck blocks, global
    average pooling and a softmax Dense. ``data_format`` "tf" builds the
    NHWC variant (input (224, 224, 3)) over the same kernels."""
    fmt = _norm_format(data_format)
    shape = tuple(shape)
    if fmt == "tf" and shape[0] in (1, 3) and shape[-1] not in (1, 3):
        # a clearly channels-first shape with the NHWC format: swap rather
        # than silently building H=3 W=96 C=96 nonsense
        shape = shape[1:] + shape[:1]
    inp = Input(shape=shape)
    x = ZeroPadding2D((3, 3), dim_ordering=fmt)(inp)
    x = _conv_bn(x, 64, 7, stride=2, pad="valid", fmt=fmt)
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     dim_ordering=fmt)(x)
    for stage, (filters, blocks) in enumerate(
            [(64, 3), (128, 4), (256, 6), (512, 3)]):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            x = _res_block(x, filters, stride=stride,
                           conv_shortcut=(b == 0), fmt=fmt)
    x = GlobalAveragePooling2D(dim_ordering=fmt)(x)
    out = Dense(class_num, activation="softmax")(x)
    return Model(inp, out)


@_backbone("squeezenet")
def _squeezenet(class_num, shape=(3, 224, 224)):
    def fire(x, squeeze, expand):
        s = Convolution2D(squeeze, 1, 1, activation="relu")(x)
        e1 = Convolution2D(expand, 1, 1, activation="relu")(s)
        e3 = Convolution2D(expand, 3, 3, activation="relu",
                           border_mode="same")(s)
        return Concatenate(axis=1)([e1, e3])

    inp = Input(shape=shape)
    x = Convolution2D(64, 3, 3, subsample=(2, 2), activation="relu")(inp)
    x = MaxPooling2D((3, 3), strides=(2, 2))(x)
    x = fire(x, 16, 64)
    x = fire(x, 16, 64)
    x = MaxPooling2D((3, 3), strides=(2, 2))(x)
    x = fire(x, 32, 128)
    x = fire(x, 32, 128)
    x = MaxPooling2D((3, 3), strides=(2, 2))(x)
    x = fire(x, 48, 192)
    x = fire(x, 48, 192)
    x = fire(x, 64, 256)
    x = fire(x, 64, 256)
    x = Dropout(0.5)(x)
    x = Convolution2D(class_num, 1, 1, activation="relu")(x)
    x = GlobalAveragePooling2D()(x)
    out = Activation("softmax")(x)
    return Model(inp, out)


class ImageClassifier(ImageModel):
    """(ImageClassifier.scala parity) build by architecture tag: "lenet",
    "vgg-16", "mobilenet", "resnet-50" or "squeezenet"."""

    def __init__(self, class_num: int = 1000, model_name: str = "resnet-50",
                 dataset: str = "imagenet", input_shape=None,
                 label_map: Optional[dict] = None, data_format: str = "th"):
        key = model_name.lower()
        if key not in backbones:
            raise ValueError(
                f"unknown model {model_name}; have {sorted(backbones)}")
        fmt = _norm_format(data_format)
        if fmt == "tf" and key != "resnet-50":
            raise ValueError(
                "data_format='tf' (NHWC) is only supported for resnet-50; "
                f"{key} builds NCHW")
        self._record_config(class_num=class_num, model_name=key,
                            dataset=dataset, input_shape=input_shape,
                            data_format=fmt)
        kwargs = {} if input_shape is None else {"shape": tuple(input_shape)}
        if fmt == "tf":
            kwargs["data_format"] = "tf"
        self.model = backbones[key](class_num, **kwargs)
        self.config = ImageConfigure(post_processor=LabelOutput(label_map))


def _norm_format(data_format: str) -> str:
    fmt = str(data_format).lower()
    if fmt in ("th", "nchw", "channels_first"):
        return "th"
    if fmt in ("tf", "nhwc", "channels_last"):
        return "tf"
    raise ValueError(f"unknown data_format {data_format!r}; "
                     "use 'th'/'NCHW' or 'tf'/'NHWC'")
