"""Image model common layer.

Counterpart of ``analytics_zoo_tpu/models/image/common.py`` (parity:
``zoo/.../models/image/common/``): ``ImageConfigure`` (the per-model
pre/post-processing registry), ``imagenet_preprocess`` (the classifiers'
default chain), ``LabelOutput`` (their label post-processing) and
``ImageModel``, whose ``predict_image_set`` runs an ``ImageSet`` through
the pre-processing on the host, the model on the context's device, and
the post-processing per feature.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ...feature.common import ChainedPreprocessing, Preprocessing
from ...feature.image.image_feature import ImageFeature
from ...feature.image.preprocessing import (ImageCenterCrop,
                                            ImageChannelNormalize,
                                            ImageMatToTensor, ImageResize,
                                            ImageSetToSample)
from ..common import ZooModel


class ImageConfigure:
    """Bundle of pre/post processing + batching for one model flavor
    (ImageConfigure.scala parity)."""

    _REGISTRY: Dict[str, "ImageConfigure"] = {}

    def __init__(self, pre_processor=None,
                 post_processor: Optional[Callable] = None,
                 batch_per_partition: int = 4,
                 label_map: Optional[Dict[int, str]] = None,
                 feature_padding_param=None):
        self.pre_processor = pre_processor
        self.post_processor = post_processor
        self.batch_per_partition = batch_per_partition
        self.label_map = label_map

    @classmethod
    def register(cls, name: str, configure: "ImageConfigure"):
        cls._REGISTRY[name.lower()] = configure

    @classmethod
    def parse(cls, name: str) -> Optional["ImageConfigure"]:
        """Look up by model tag, e.g. "imageclassification_imagenet"
        (ImageConfigure.parse parity)."""
        return cls._REGISTRY.get(name.lower())


def imagenet_preprocess(size: int = 224,
                        mean=(123.68, 116.779, 103.939),
                        format: str = "NCHW") -> Preprocessing:
    """Standard imagenet eval chain: resize-256 -> center-crop ->
    normalize -> NCHW (or NHWC) tensor (the reference's default
    classifier preprocessing).

    The resize edge scales with the crop (256/224 ratio) so crops larger
    than 256 still fit inside the resized image."""
    edge = max(256, int(round(size * 256 / 224)))
    return ChainedPreprocessing([
        ImageResize(edge, edge),
        ImageCenterCrop(size, size),
        ImageChannelNormalize(*mean),
        ImageMatToTensor(format=format),
        ImageSetToSample(),
    ])


class LabelOutput:
    """Attach top-probability class + name to each prediction
    (LabelOutput.scala parity). ``feature`` is any mapping."""

    def __init__(self, label_map: Optional[Dict[int, str]] = None,
                 clses: str = "clses", probs: str = "probs",
                 top_n: int = 5):
        self.label_map = label_map or {}
        self.clses = clses
        self.probs = probs
        self.top_n = top_n

    def __call__(self, feature, output: np.ndarray):
        probs = np.asarray(output).reshape(-1)
        order = np.argsort(probs)[::-1][:self.top_n]
        feature[self.clses] = [self.label_map.get(int(i), str(int(i)))
                               for i in order]
        feature[self.probs] = probs[order].astype(np.float32)
        return feature


class ImageModel(ZooModel):
    """Base for image models (ImageModel.scala parity):
    ``predict_image_set`` runs preprocessing -> batched device predict ->
    per-feature postprocessing."""

    def predict_image_set(self, image_set, configure=None,
                          batch_size: int = 16):
        cfg = configure or getattr(self, "config", None)
        data = image_set
        if cfg is not None and cfg.pre_processor is not None:
            data = data.transform(cfg.pre_processor)
        feats = data.to_local().features
        arrays = np.stack([f.get_sample().features[0] for f in feats])
        preds = np.asarray(self.predict(arrays, batch_size=batch_size))
        for feat, pred in zip(feats, preds):
            feat[ImageFeature.predict] = pred
            if cfg is not None and cfg.post_processor is not None:
                cfg.post_processor(feat, pred)
        return data

    predictImageSet = predict_image_set
