"""3D (medical) image transforms.

Counterpart of ``analytics_zoo_tpu/feature/image3d/transformation.py``, a
copy over ``scipy.ndimage``. Parity: ``zoo/.../feature/image3d/*.scala``
(6 files: Crop3D variants, Rotation3D, AffineTransform3D) and
``pyzoo/zoo/feature/image3d/transformation.py``. Volumes are numpy arrays
(depth, height, width) float32.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from ..image.preprocessing import ImagePreprocessing


class ImagePreprocessing3D(ImagePreprocessing):
    pass


class Crop3D(ImagePreprocessing3D):
    """Crop a patch starting at ``start`` (d, h, w) of size ``patch_size``."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = [int(s) for s in start]
        self.patch = [int(p) for p in patch_size]

    def transform_mat(self, img, feature):
        d, h, w = self.start
        pd, ph, pw = self.patch
        return img[d:d + pd, h:h + ph, w:w + pw].copy()


class RandomCrop3D(ImagePreprocessing3D):
    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.patch = (int(crop_depth), int(crop_height), int(crop_width))

    def transform_mat(self, img, feature):
        starts = [random.randint(0, max(img.shape[i] - self.patch[i], 0))
                  for i in range(3)]
        return Crop3D(starts, self.patch).transform_mat(img, feature)


class CenterCrop3D(ImagePreprocessing3D):
    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.patch = (int(crop_depth), int(crop_height), int(crop_width))

    def transform_mat(self, img, feature):
        starts = [(img.shape[i] - self.patch[i]) // 2 for i in range(3)]
        return Crop3D(starts, self.patch).transform_mat(img, feature)


class Rotate3D(ImagePreprocessing3D):
    """Rotate by Euler angles (yaw, pitch, roll) in radians
    (Rotation3D.scala — trilinear resample)."""

    def __init__(self, rotation_angles: Sequence[float]):
        self.angles = [float(a) for a in rotation_angles]

    def transform_mat(self, img, feature):
        out = img
        # rotate in the three orthogonal planes sequentially
        planes = [(1, 2), (0, 2), (0, 1)]
        for angle, plane in zip(self.angles, planes):
            if abs(angle) > 1e-12:
                out = ndimage.rotate(out, np.degrees(angle), axes=plane,
                                     reshape=False, order=1, mode="nearest")
        return out.astype(np.float32)


class AffineTransform3D(ImagePreprocessing3D):
    """Apply an affine map x -> A x + t in voxel space
    (AffineTransform3D.scala)."""

    def __init__(self, mat: np.ndarray, translation: Optional[np.ndarray]
                 = None, clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(mat, np.float64).reshape(3, 3)
        self.translation = np.zeros(3) if translation is None else \
            np.asarray(translation, np.float64).reshape(3)
        self.mode = "nearest" if clamp_mode == "clamp" else "constant"
        self.pad_val = float(pad_val)

    def transform_mat(self, img, feature):
        center = (np.asarray(img.shape, np.float64) - 1) / 2.0
        # resample about the volume center (reference semantics)
        inv = np.linalg.inv(self.mat)
        offset = center - inv @ (center + self.translation)
        out = ndimage.affine_transform(
            img, inv, offset=offset, order=1, mode=self.mode,
            cval=self.pad_val)
        return out.astype(np.float32)
