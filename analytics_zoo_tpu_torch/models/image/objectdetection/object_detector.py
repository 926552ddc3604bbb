"""ObjectDetector model family.

Counterpart of ``analytics_zoo_tpu/models/image/objectdetection/
object_detector.py`` (parity: ``ObjectDetector.scala`` + ``Visualizer``):
detection models with pre/post-processing configures and image-set
prediction over the SSD of ``ssd.py``. ``detect`` runs the forward and
``detection_output`` on the context's device in one eager pass, batch by
batch; only the (B, top_k, 6) rows come back to the host.
``visualize`` draws the boxes with numpy and leaves out the label text
OpenCV's ``putText`` would draw (ROADMAP C18).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ....feature.common import ChainedPreprocessing
from ....feature.image.image_feature import ImageFeature
from ....feature.image.preprocessing import (ImageChannelNormalize,
                                             ImageMatToTensor, ImageResize,
                                             ImageSetToSample)
from ..common import ImageConfigure, ImageModel
from .ssd import MultiBoxLoss, build_ssd, detection_output, match_priors


def ssd_preprocess(size: int = 300) -> ChainedPreprocessing:
    """Resize -> normalize -> NCHW (the reference SSD preprocessing
    chain)."""
    return ChainedPreprocessing([
        ImageResize(size, size),
        ImageChannelNormalize(123.0, 117.0, 104.0),
        ImageMatToTensor(format="NCHW"),
        ImageSetToSample(),
    ])


class ScaleDetection:
    """Rescale normalized boxes back to original image size
    (ScaleDetection.scala parity)."""

    def __call__(self, feature: ImageFeature, rows: np.ndarray):
        h = feature.get("original_height") or feature.height
        w = feature.get("original_width") or feature.width
        rows = np.asarray(rows).copy()
        rows[:, 2] *= w
        rows[:, 4] *= w
        rows[:, 3] *= h
        rows[:, 5] *= h
        feature["detection"] = rows
        return feature


class ObjectDetector(ImageModel):
    """SSD-based detector (ObjectDetector.scala parity).

    ``predict_image_set`` output: per image an (k, 6) array of
    [class, score, x1, y1, x2, y2] in original-image pixels, the rows of
    the top ``top_k`` whose score is above 0.
    """

    def __init__(self, class_num: int = 21, model_name: str = "ssd-300",
                 image_size: int = 300, base_channels: int = 32,
                 label_map: Optional[Dict[int, str]] = None,
                 conf_threshold: float = 0.3, top_k: int = 100):
        self._record_config(class_num=class_num, model_name=model_name,
                            image_size=image_size,
                            base_channels=base_channels,
                            conf_threshold=conf_threshold, top_k=top_k)
        self.model, self.priors = build_ssd(class_num, image_size,
                                            base_channels)
        self.label_map = label_map or {}
        self.config = ImageConfigure(pre_processor=ssd_preprocess(
            image_size))
        self._device_priors = None

    # -- training --------------------------------------------------------
    def compile(self, optimizer="sgd", loss=None, metrics=None):
        return self.model.compile(
            optimizer, loss or MultiBoxLoss(self.class_num), metrics)

    def encode_targets(self, gt_boxes: Sequence[np.ndarray],
                       gt_labels: Sequence[np.ndarray],
                       threshold: float = 0.5) -> np.ndarray:
        """Host-side target assignment for a batch of ground truths.
        Boxes are corner-form, normalized to [0,1]; labels are 1-based
        (0 = background). Returns (B, num_priors, 5)."""
        return np.stack([
            match_priors(b, l, self.priors, threshold)
            for b, l in zip(gt_boxes, gt_labels)])

    # -- inference -------------------------------------------------------
    def forward_device(self, images) -> torch.Tensor:
        """(B,3,S,S) preprocessed images -> the raw (B, priors, 4 + C)
        head output, left on the context's device."""
        trainer = self.model._ensure_trainer()
        self.model.to(trainer.device)
        x = torch.as_tensor(np.asarray(images, np.float32)).to(
            trainer.device)
        with torch.inference_mode():
            return trainer._forward([x], None, False)

    def postprocess(self, preds: torch.Tensor) -> torch.Tensor:
        """``detection_output`` of a head output on its device."""
        if self._device_priors is None or \
                self._device_priors.device != preds.device:
            self._device_priors = torch.as_tensor(self.priors).to(
                preds.device)
        with torch.inference_mode():
            return detection_output(preds, self._device_priors,
                                    self.class_num,
                                    conf_threshold=self.conf_threshold,
                                    top_k=self.top_k)

    def detect(self, images: np.ndarray, batch_size: Optional[int] = None
               ) -> np.ndarray:
        """(B,3,S,S) preprocessed images -> (B, top_k, 6) detections in
        normalized coordinates, ``batch_size`` images per device pass
        (all of them by default)."""
        images = np.asarray(images, np.float32)
        step = int(batch_size or len(images)) or 1
        out = [self.postprocess(self.forward_device(images[i:i + step]))
               .cpu().numpy() for i in range(0, len(images), step)]
        return np.concatenate(out) if out else \
            np.zeros((0, self.top_k, 6), np.float32)

    def predict_image_set(self, image_set,
                          configure: Optional[ImageConfigure] = None,
                          batch_size: int = 8):
        cfg = configure or self.config
        # remember the original image + size before the resize (detections
        # are reported, and visualized, in original pixels)
        for f in image_set.to_local().features:
            f["original_height"] = f.height
            f["original_width"] = f.width
            f["original_mat"] = f.get_image()
        data = image_set.transform(cfg.pre_processor)
        feats = data.to_local().features
        arrays = np.stack([f.get_sample().features[0] for f in feats])
        rows = self.detect(arrays, batch_size)
        scale = ScaleDetection()
        for f, r in zip(feats, rows):
            keep = r[:, 1] > 0
            f[ImageFeature.predict] = r[keep]
            scale(f, r[keep])
        return data

    predictImageSet = predict_image_set


def _draw_rect(img, x1, y1, x2, y2, color, thickness=2):
    """Box outline of ``thickness`` pixels, clipped to the image."""
    h, w = img.shape[:2]
    half = thickness // 2
    x1, x2 = sorted((int(x1), int(x2)))
    y1, y2 = sorted((int(y1), int(y2)))
    color = np.asarray(color, img.dtype)

    def fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h)
        xa, xb = max(xa, 0), min(xb, w)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb] = color

    fill(y1 - half, y1 - half + thickness, x1 - half, x2 + half + 1)
    fill(y2 - half, y2 - half + thickness, x1 - half, x2 + half + 1)
    fill(y1 - half, y2 + half + 1, x1 - half, x1 - half + thickness)
    fill(y1 - half, y2 + half + 1, x2 - half, x2 - half + thickness)


def visualize(feature: ImageFeature, label_map: Optional[dict] = None,
              threshold: float = 0.3,
              out_key: str = "visualized") -> np.ndarray:
    """Draw detection boxes on the original image (Visualizer parity);
    the label text is left out (ROADMAP C18)."""
    base = feature.get("original_mat")
    if base is None:
        base = feature.get_image()
    img = np.ascontiguousarray(base).astype(np.uint8)
    rows = feature.get("detection")
    for row in (rows if rows is not None else []):
        cls, score, x1, y1, x2, y2 = row[:6]
        if score < threshold:
            continue
        _draw_rect(img, x1, y1, x2, y2, (0, 255, 0), 2)
    feature[out_key] = img
    return img
