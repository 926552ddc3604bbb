"""Image features: ``ImageFeature``, ``ImageSet``, the image
preprocessing ops and the streaming ``ImagePipelineFeatureSet``, over the
port's own codec (``codec.py``) and resize and colour conversions
(``resize.py``); counterpart of ``analytics_zoo_tpu/feature/image``."""

from .image_feature import ImageFeature
from .pipeline import ImagePipelineFeatureSet, PipelineStats
from .image_set import DistributedImageSet, ImageSet, LocalImageSet
from .preprocessing import (ImageAspectScale, ImageBrightness,
                            ImageBytesToMat, ImageCenterCrop,
                            ImageChannelNormalize, ImageChannelOrder,
                            ImageColorJitter, ImageContrast, ImageExpand,
                            ImageFeatureToSample, ImageFeatureToTensor,
                            ImageFiller, ImageFixedCrop, ImageHFlip,
                            ImageHue, ImageMatToFloats, ImageMatToTensor,
                            ImageMirror, ImagePixelBytesToMat,
                            ImagePixelNormalize, ImagePreprocessing,
                            ImageRandomAspectScale, ImageRandomCrop,
                            ImageRandomPreprocessing, ImageResize,
                            ImageSaturation, ImageSetToSample,
                            PerImageNormalize)

__all__ = [
    "ImageFeature", "ImageSet", "LocalImageSet", "DistributedImageSet",
    "ImagePreprocessing", "ImageBytesToMat", "ImagePixelBytesToMat",
    "ImageResize", "ImageBrightness", "ImageContrast", "ImageChannelNormalize",
    "PerImageNormalize", "ImageMatToTensor", "ImageMatToFloats",
    "ImageSetToSample", "ImageHue", "ImageSaturation", "ImageChannelOrder",
    "ImageColorJitter", "ImageAspectScale", "ImageRandomAspectScale",
    "ImagePixelNormalize", "ImageRandomCrop", "ImageCenterCrop",
    "ImageFixedCrop", "ImageExpand", "ImageFiller", "ImageHFlip",
    "ImageMirror", "ImageFeatureToTensor", "ImageFeatureToSample",
    "ImageRandomPreprocessing", "ImagePipelineFeatureSet", "PipelineStats",
]
