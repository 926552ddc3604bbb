"""Image model zoo (reference: ``zoo/.../models/image/``).

Counterpart of ``analytics_zoo_tpu/models/image``: the image
classifiers (``imageclassification``) and the SSD object detector
(``objectdetection``).
"""

from .common import (ImageConfigure, ImageModel, LabelOutput,
                     imagenet_preprocess)

__all__ = ["ImageModel", "ImageConfigure", "LabelOutput",
           "imagenet_preprocess"]
