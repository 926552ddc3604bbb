"""Image model common layer.

Counterpart of ``analytics_zoo_tpu/models/image/common.py`` (parity:
``zoo/.../models/image/common/``): ``ImageConfigure`` (the per-model
pre/post-processing registry), ``LabelOutput`` (the classifiers'
label post-processing) and ``ImageModel``. The image pipeline the
pre-processing and ``predict_image_set`` run on (``feature/image``,
decoding and resizing with OpenCV on the host) is not ported yet: those
two raise until it is (ROADMAP A11). ``predict`` on arrays works.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..common import ZooModel

_IMAGE_PIPELINE = ("the image pipeline (feature/image: ImageSet and its "
                   "OpenCV preprocessing) is not ported yet; it arrives "
                   "with ROADMAP A11. Feed predict() arrays instead")


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
                        format: str = "NCHW"):
    """The imagenet eval chain (resize, center-crop, normalize, to a
    tensor): not ported yet (ROADMAP A11)."""
    raise NotImplementedError(_IMAGE_PIPELINE)


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
    """Base for image models (ImageModel.scala parity)."""

    def predict_image_set(self, image_set, configure=None,
                          batch_size: int = 16):
        raise NotImplementedError(_IMAGE_PIPELINE)

    predictImageSet = predict_image_set
