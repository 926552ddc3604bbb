"""NNImageReader / NNImageSchema: images as frame rows.

Counterpart of ``analytics_zoo_tpu/pipeline/nnframes/nn_image_reader.py``
(parity: ``zoo/.../pipeline/nnframes/NNImageReader.scala``, readImages ->
a frame with an ``image`` struct column {origin, height, width,
nChannels, mode, data}; ``pyzoo/zoo/pipeline/nnframes/nn_image_reader.py``
/ ``nn_image_schema.py``).

An image row is a plain dict with the struct's fields (data = raw BGR
uint8 bytes, mode = the OpenCV type code). Files are decoded by the
port's codec (``feature/image/codec.py``, OpenCV's pixels on well-formed
files) and resized by its ``resize``; a file the codec cannot read is
skipped, as the JAX reader skips what ``cv2.imdecode`` refuses.
``readImages`` returns a dict of columns, ``{"image": rows}``: the port
never imports pandas (``pandas.DataFrame(...)`` of it is the JAX
package's frame).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ...feature.image import codec
from ...feature.image.image_feature import ImageFeature
from ...feature.image.resize import resize

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

# OpenCV type code for 8UC3 (the reference stores CvType), 8UC1
_CV_8UC3 = 16
_CV_8UC1 = 0


class NNImageSchema:
    """Row <-> ImageFeature codecs (NNImageSchema.scala parity)."""

    @staticmethod
    def to_row(img: np.ndarray, origin: str = "") -> dict:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        return {"origin": origin, "height": int(h), "width": int(w),
                "nChannels": int(c),
                "mode": _CV_8UC3 if c == 3 else _CV_8UC1,
                "data": np.ascontiguousarray(
                    img.astype(np.uint8)).tobytes()}

    @staticmethod
    def to_ndarray(row: dict) -> np.ndarray:
        arr = np.frombuffer(row["data"], np.uint8)
        return arr.reshape(row["height"], row["width"],
                           row["nChannels"]).astype(np.float32)

    @staticmethod
    def to_image_feature(row: dict) -> ImageFeature:
        return ImageFeature(NNImageSchema.to_ndarray(row),
                            uri=row.get("origin", ""))


class NNImageReader:
    """``NNImageReader.readImages(path)`` -> ``{"image": [row, ...]}``."""

    @staticmethod
    def readImages(path: str, sc=None, minPartitions: int = 1,
                   resizeH: int = -1, resizeW: int = -1,
                   image_codec: int = -1):
        if os.path.isfile(path):
            paths = [path]
        elif os.path.isdir(path):
            paths = sorted(
                p for p in glob.glob(os.path.join(path, "**", "*"),
                                     recursive=True)
                if p.lower().endswith(_IMAGE_EXTS))
        else:
            paths = sorted(p for p in glob.glob(path)
                           if p.lower().endswith(_IMAGE_EXTS))
        rows = []
        for p in paths:
            try:
                img = codec.imread(p)
            except ValueError:
                continue
            if resizeH > 0 and resizeW > 0:
                img = resize(img, (resizeW, resizeH))
            rows.append(NNImageSchema.to_row(img, origin=p))
        return {"image": rows}

    read_images = readImages
