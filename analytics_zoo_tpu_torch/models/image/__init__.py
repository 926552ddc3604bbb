"""Image model zoo (reference: ``zoo/.../models/image/``).

Counterpart of ``analytics_zoo_tpu/models/image``; so far the image
classifiers. ``ObjectDetector`` (SSD) waits (ROADMAP A9).
"""

from .common import (ImageConfigure, ImageModel, LabelOutput,
                     imagenet_preprocess)

__all__ = ["ImageModel", "ImageConfigure", "LabelOutput",
           "imagenet_preprocess"]
