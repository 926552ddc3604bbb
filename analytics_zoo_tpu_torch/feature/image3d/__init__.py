from .transformation import (AffineTransform3D, CenterCrop3D, Crop3D,
                             ImagePreprocessing3D, RandomCrop3D, Rotate3D)

__all__ = ["ImagePreprocessing3D", "Crop3D", "RandomCrop3D", "CenterCrop3D",
           "Rotate3D", "AffineTransform3D"]
