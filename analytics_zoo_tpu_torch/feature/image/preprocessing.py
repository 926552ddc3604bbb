"""Image preprocessing ops (~30, numpy host-side).

Counterpart of ``analytics_zoo_tpu/feature/image/preprocessing.py``. The
JAX package decodes, resizes and converts colour with OpenCV; the port
uses its own codec (``codec.py``) and resize and HSV (``resize.py``),
which give OpenCV's pixels. The random ops draw from the standard
library's ``random`` in the JAX package's order, so one ``random.seed``
gives both packages the same draws. Parity:
``zoo/.../feature/image/*.scala`` (32 files — Resize, crops, flips,
hue/saturation/brightness/contrast, normalize, jitter, expand, filler,
aspect-scale...) and ``pyzoo/zoo/feature/image/imagePreprocessing.py``.

These run on the host in the FeatureSet's transform workers: decode
and augment overlap device compute; the device only ever sees dense
float batches. Convention: images are numpy HWC float32 in BGR channel
order (matching the reference's OpenCVMat) until ImageMatToTensor.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from ..common import Preprocessing
from ..feature_set import Sample
from . import codec
from .image_feature import ImageFeature
from .resize import (INTER_LINEAR, bgr_to_hsv, hsv_to_bgr,
                     resize as _resize)


class ImagePreprocessing(Preprocessing):
    """Base: transforms ImageFeature -> ImageFeature by rewriting its mat."""

    def apply(self, feature: ImageFeature) -> ImageFeature:
        img = feature.get_image()
        if img is not None:
            feature.set_image(self.transform_mat(img, feature))
        return feature

    def transform_mat(self, img: np.ndarray,
                      feature: ImageFeature) -> np.ndarray:
        return img


class ImageBytesToMat(ImagePreprocessing):
    """Decode encoded image bytes (jpg/png) to a BGR float mat."""

    def apply(self, feature: ImageFeature) -> ImageFeature:
        raw = feature.get(ImageFeature.bytes_key)
        if raw is None:
            return feature
        img = codec.decode(raw, feature.get_uri())
        feature.set_image(img.astype(np.float32))
        feature[ImageFeature.original_size] = img.shape
        return feature


class ImagePixelBytesToMat(ImagePreprocessing):
    """Raw pixel bytes (H*W*C uint8) -> mat."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (int(height), int(width), int(channels))

    def apply(self, feature: ImageFeature) -> ImageFeature:
        raw = feature.get(ImageFeature.bytes_key)
        if raw is not None:
            img = np.frombuffer(raw, np.uint8).reshape(self.shape)
            feature.set_image(img.astype(np.float32))
            feature[ImageFeature.original_size] = self.shape
        return feature


class ImageResize(ImagePreprocessing):
    """``resize_mode`` is an OpenCV interpolation flag; -1 picks a random
    method per image (Resize.scala semantics)."""

    _RANDOM_INTERPS = (0, 1, 2, 3, 4)  # nearest/linear/cubic/area/lanczos

    def __init__(self, resize_h: int, resize_w: int, resize_mode: int = 1,
                 use_scale_factor: bool = True):
        self.h, self.w = int(resize_h), int(resize_w)
        self.interp = int(resize_mode)

    def transform_mat(self, img, feature):
        interp = self.interp if self.interp >= 0 else \
            random.choice(self._RANDOM_INTERPS)
        return _resize(img, (self.w, self.h), interp)


class ImageAspectScale(ImagePreprocessing):
    """Scale the shorter edge to ``min_size`` capping the longer at
    ``max_size`` (AspectScale.scala)."""

    def __init__(self, min_size: int, scale_multiple_of: int = 1,
                 max_size: int = 1000):
        self.min_size = int(min_size)
        self.multiple = int(scale_multiple_of)
        self.max_size = int(max_size)

    def transform_mat(self, img, feature):
        return self._scale_mat(img, feature, self.min_size)

    def _scale_mat(self, img, feature, min_size):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = min_size / short
        if scale * long > self.max_size:
            scale = self.max_size / long
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.multiple > 1:
            nh = (nh // self.multiple) * self.multiple
            nw = (nw // self.multiple) * self.multiple
        feature[ImageFeature.im_info] = np.array(
            [nh, nw, nh / h, nw / w], np.float32)
        return _resize(img, (nw, nh), INTER_LINEAR)


class ImageRandomAspectScale(ImageAspectScale):
    def __init__(self, scales: Sequence[int], scale_multiple_of: int = 1,
                 max_size: int = 1000):
        super().__init__(scales[0], scale_multiple_of, max_size)
        self.scales = [int(s) for s in scales]

    def transform_mat(self, img, feature):
        # transformers are shared across prefetch threads — no self writes
        return self._scale_mat(img, feature, random.choice(self.scales))


class ImageBrightness(ImagePreprocessing):
    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def transform_mat(self, img, feature):
        return img + random.uniform(self.lo, self.hi)


class ImageContrast(ImagePreprocessing):
    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def transform_mat(self, img, feature):
        return img * random.uniform(self.lo, self.hi)


class ImageHue(ImagePreprocessing):
    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def transform_mat(self, img, feature):
        hsv = bgr_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(
            np.float32)
        hsv[..., 0] = (hsv[..., 0] + random.uniform(self.lo, self.hi)) % 180
        return hsv_to_bgr(np.clip(hsv, 0, 255).astype(np.uint8)).astype(
            np.float32)


class ImageSaturation(ImagePreprocessing):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def transform_mat(self, img, feature):
        hsv = bgr_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(
            np.float32)
        hsv[..., 1] = np.clip(
            hsv[..., 1] * random.uniform(self.lo, self.hi), 0, 255)
        return hsv_to_bgr(np.clip(hsv, 0, 255).astype(np.uint8)).astype(
            np.float32)


class ImageChannelOrder(ImagePreprocessing):
    """BGR <-> RGB."""

    def transform_mat(self, img, feature):
        return img[..., ::-1].copy()


class ImageColorJitter(ImagePreprocessing):
    """Random brightness/contrast/saturation/hue in random order
    (ColorJitter.scala)."""

    def __init__(self, brightness_prob=0.5, brightness_delta=32.0,
                 contrast_prob=0.5, contrast_lower=0.5, contrast_upper=1.5,
                 hue_prob=0.5, hue_delta=18.0,
                 saturation_prob=0.5, saturation_lower=0.5,
                 saturation_upper=1.5, random_order_prob=0.0):
        self.ops = [
            (brightness_prob,
             ImageBrightness(-brightness_delta, brightness_delta)),
            (contrast_prob, ImageContrast(contrast_lower, contrast_upper)),
            (hue_prob, ImageHue(-hue_delta, hue_delta)),
            (saturation_prob,
             ImageSaturation(saturation_lower, saturation_upper)),
        ]

    def transform_mat(self, img, feature):
        ops = list(self.ops)
        random.shuffle(ops)
        for prob, op in ops:
            if random.random() < prob:
                img = np.clip(op.transform_mat(img, feature), 0, 255)
        return img


class ImageChannelNormalize(ImagePreprocessing):
    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0):
        # stored in BGR order to match the mat layout
        self.mean = np.array([mean_b, mean_g, mean_r], np.float32)
        self.std = np.array([std_b, std_g, std_r], np.float32)

    def transform_mat(self, img, feature):
        return (img - self.mean) / self.std


class PerImageNormalize(ImagePreprocessing):
    """(x - min) / (max - min) per image (PerImageNormalize.scala)."""

    def __init__(self, min_val: float = 0.0, max_val: float = 1.0):
        self.min_val, self.max_val = float(min_val), float(max_val)

    def transform_mat(self, img, feature):
        lo, hi = float(img.min()), float(img.max())
        scale = (self.max_val - self.min_val) / max(hi - lo, 1e-8)
        return (img - lo) * scale + self.min_val


class ImagePixelNormalize(ImagePreprocessing):
    """Subtract a per-pixel mean array (PixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform_mat(self, img, feature):
        return img - self.means.reshape(img.shape)


def _crop(img, x1, y1, x2, y2):
    return img[int(y1):int(y2), int(x1):int(x2)].copy()


class ImageCenterCrop(ImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int,
                 is_clip: bool = True):
        self.cw, self.ch = int(crop_width), int(crop_height)

    def transform_mat(self, img, feature):
        h, w = img.shape[:2]
        x1 = (w - self.cw) // 2
        y1 = (h - self.ch) // 2
        return _crop(img, x1, y1, x1 + self.cw, y1 + self.ch)


class ImageRandomCrop(ImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int,
                 is_clip: bool = True):
        self.cw, self.ch = int(crop_width), int(crop_height)

    def transform_mat(self, img, feature):
        h, w = img.shape[:2]
        x1 = random.randint(0, max(w - self.cw, 0))
        y1 = random.randint(0, max(h - self.ch, 0))
        return _crop(img, x1, y1, x1 + self.cw, y1 + self.ch)


class ImageFixedCrop(ImagePreprocessing):
    """Crop at fixed (normalized or absolute) coordinates (Crop.scala)."""

    def __init__(self, x1, y1, x2, y2, normalized: bool = True,
                 is_clip: bool = True):
        self.box = (float(x1), float(y1), float(x2), float(y2))
        self.normalized = normalized

    def transform_mat(self, img, feature):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        x1, x2 = np.clip([x1, x2], 0, w)
        y1, y2 = np.clip([y1, y2], 0, h)
        return _crop(img, round(x1), round(y1), round(x2), round(y2))


class ImageExpand(ImagePreprocessing):
    """Pad the image into a larger mean-filled canvas at a random offset
    (Expand.scala)."""

    def __init__(self, means_r: float = 123, means_g: float = 117,
                 means_b: float = 104, min_expand_ratio: float = 1.0,
                 max_expand_ratio: float = 4.0):
        self.mean = np.array([means_b, means_g, means_r], np.float32)
        self.lo, self.hi = float(min_expand_ratio), float(max_expand_ratio)

    def transform_mat(self, img, feature):
        ratio = random.uniform(self.lo, self.hi)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        out = np.empty((nh, nw, img.shape[2]), np.float32)
        out[:] = self.mean
        y1 = random.randint(0, nh - h)
        x1 = random.randint(0, nw - w)
        out[y1:y1 + h, x1:x1 + w] = img
        feature[ImageFeature.bounding_box] = np.array(
            [x1, y1, x1 + w, y1 + h], np.float32)
        return out


class ImageFiller(ImagePreprocessing):
    """Fill a (normalized) region with a constant (Filler.scala)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: int = 255):
        self.box = (float(start_x), float(start_y), float(end_x),
                    float(end_y))
        self.value = float(value)

    def transform_mat(self, img, feature):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class ImageHFlip(ImagePreprocessing):
    def transform_mat(self, img, feature):
        return img[:, ::-1].copy()


class ImageMirror(ImageHFlip):
    pass


class ImageRandomPreprocessing(ImagePreprocessing):
    """Apply ``preprocessing`` with probability ``prob``."""

    def __init__(self, preprocessing: ImagePreprocessing, prob: float):
        self.preprocessing = preprocessing
        self.prob = float(prob)

    def apply(self, feature: ImageFeature) -> ImageFeature:
        if random.random() < self.prob:
            return self.preprocessing.apply(feature)
        return feature


class ImageMatToTensor(ImagePreprocessing):
    """HWC BGR mat -> float tensor. ``to_rgb`` flips channel order;
    ``format`` 'NCHW' (reference default) or 'NHWC'."""

    def __init__(self, to_rgb: bool = False, tensor_key: str = "floats",
                 format: str = "NCHW"):
        self.to_rgb = to_rgb
        self.tensor_key = tensor_key
        assert format in ("NCHW", "NHWC")
        self.format = format

    def apply(self, feature: ImageFeature) -> ImageFeature:
        img = feature.get_image().astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        if self.format == "NCHW":
            img = np.transpose(img, (2, 0, 1))
        feature[self.tensor_key] = np.ascontiguousarray(img)
        return feature


class ImageMatToFloats(ImageMatToTensor):
    pass


class ImageSetToSample(ImagePreprocessing):
    """Wrap selected tensors (+ label) into a Sample
    (ImageSetToSample.scala)."""

    def __init__(self, input_keys=("floats",), target_keys=None,
                 sample_key: str = "sample"):
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys) if target_keys else None
        self.sample_key = sample_key

    def apply(self, feature: ImageFeature) -> ImageFeature:
        feats = [np.asarray(feature[k], np.float32)
                 for k in self.input_keys]
        labels = None
        if self.target_keys:
            labels = [np.asarray(feature[k], np.float32)
                      for k in self.target_keys if k in feature]
            labels = labels if labels else None
        elif feature.get_label() is not None:
            labels = np.asarray(feature.get_label(), np.float32)
        feature[self.sample_key] = Sample(
            feats if len(feats) > 1 else feats[0], labels)
        return feature


class ImageFeatureToTensor(Preprocessing):
    def apply(self, feature: ImageFeature):
        return feature[ImageFeature.floats]


class ImageFeatureToSample(Preprocessing):
    def apply(self, feature: ImageFeature):
        return feature.get_sample()
