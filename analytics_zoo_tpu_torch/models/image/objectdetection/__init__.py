"""The SSD object detector; counterpart of
``analytics_zoo_tpu/models/image/objectdetection``."""

from .object_detector import (ObjectDetector, ScaleDetection,
                              ssd_preprocess, visualize)
from .ssd import (MultiBoxLoss, build_ssd, decode_boxes, detection_output,
                  generate_priors, match_priors, nms)

__all__ = ["ObjectDetector", "ScaleDetection", "visualize",
           "ssd_preprocess", "MultiBoxLoss", "build_ssd", "decode_boxes",
           "detection_output", "generate_priors", "match_priors", "nms"]
