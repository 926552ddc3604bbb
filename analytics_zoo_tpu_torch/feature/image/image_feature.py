"""ImageFeature: the per-image record flowing through image pipelines.

Counterpart of ``analytics_zoo_tpu/feature/image/image_feature.py``, a
copy. Parity: BigDL ``ImageFeature`` as used by
``zoo/.../feature/image/ImageSet.scala`` — a keyed map holding the raw
bytes, decoded mat (numpy HWC, BGR like OpenCV), label, uri, original size
and the final sample/predict results.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class ImageFeature(dict):
    bytes_key = "bytes"
    mat = "mat"
    floats = "floats"
    uri = "uri"
    label = "label"
    original_size = "originalSize"
    size = "size"
    sample = "sample"
    predict = "predict"
    bounding_box = "boundingBox"
    im_info = "imInfo"

    def __init__(self, image=None, label=None, uri: Optional[str] = None):
        super().__init__()
        if image is not None:
            img = np.asarray(image)
            if img.dtype == np.uint8 or img.ndim >= 2:
                self[self.mat] = img.astype(np.float32) \
                    if img.dtype != np.float32 else img
                self[self.original_size] = img.shape[:2] + (
                    img.shape[2] if img.ndim == 3 else 1,)
            else:
                self[self.bytes_key] = bytes(image)
        if label is not None:
            self[self.label] = label
        if uri is not None:
            self[self.uri] = uri

    # -- convenience ---------------------------------------------------
    def get_image(self) -> Optional[np.ndarray]:
        return self.get(self.mat)

    def set_image(self, img: np.ndarray):
        self[self.mat] = img
        return self

    def get_label(self):
        return self.get(self.label)

    def get_uri(self):
        return self.get(self.uri)

    def get_sample(self):
        return self.get(self.sample)

    def get_predict(self):
        return self.get(self.predict)

    @property
    def height(self):
        img = self.get_image()
        return None if img is None else img.shape[0]

    @property
    def width(self):
        img = self.get_image()
        return None if img is None else img.shape[1]
