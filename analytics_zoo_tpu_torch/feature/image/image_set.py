"""ImageSet: collections of ImageFeatures + transform pipelines.

Counterpart of ``analytics_zoo_tpu/feature/image/image_set.py``; files
decode through the port's codec and resize (``codec.py``,
``resize.py``) where the JAX package calls OpenCV. Parity:
``zoo/.../feature/image/ImageSet.scala:46-140`` (LocalImageSet /
DistributedImageSet, ``ImageSet.read``, ``transform``, ``toDataSet``) and
``pyzoo/zoo/feature/image/imageset.py``.

"Distributed" here means *per-host shard of a global dataset*: each host
reads its slice and feeds its devices through the FeatureSet pipeline;
there is no central RDD. ``DistributedImageSet`` is the
same in-memory structure plus a (shard_index, num_shards) annotation.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence

import numpy as np

from ..feature_set import ArrayFeatureSet, FeatureSet
from .image_feature import ImageFeature
from .preprocessing import ImageBytesToMat
from .resize import resize as _resize

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageSet:
    def __init__(self, features: List[ImageFeature]):
        self.features = features

    # -- factories -----------------------------------------------------
    @classmethod
    def read(cls, path: str, resize_h: int = -1, resize_w: int = -1,
             image_codec: int = -1, with_label: bool = False,
             one_based_label: bool = True, shard_index: int = 0,
             num_shards: int = 1) -> "ImageSet":
        """Read images from a file / directory / glob.

        ``with_label``: treat immediate sub-directories as class labels
        (ImageSet.scala:86-118 readWithLabel). Sharding slices the sorted
        file list round-robin for multi-host reading.
        """
        if os.path.isfile(path):
            paths = [path]
        elif os.path.isdir(path):
            if with_label:
                return cls._read_with_label(path, resize_h, resize_w,
                                            one_based_label, shard_index,
                                            num_shards)
            paths = sorted(
                p for p in glob.glob(os.path.join(path, "**", "*"),
                                     recursive=True)
                if p.lower().endswith(_IMAGE_EXTS))
        else:
            paths = sorted(glob.glob(path))
        paths = paths[shard_index::num_shards]
        feats = [cls._load_one(p, resize_h, resize_w) for p in paths]
        out = LocalImageSet(feats) if num_shards == 1 else \
            DistributedImageSet(feats, shard_index, num_shards)
        return out

    @classmethod
    def _read_with_label(cls, root, resize_h, resize_w, one_based,
                         shard_index, num_shards):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        label_map = {c: i + (1 if one_based else 0)
                     for i, c in enumerate(classes)}
        # shard the path list BEFORE decoding so each host only reads its
        # slice (matches the unlabeled read() path)
        entries = [(p, c) for c in classes
                   for p in sorted(glob.glob(os.path.join(root, c, "*")))
                   if p.lower().endswith(_IMAGE_EXTS)]
        entries = entries[shard_index::num_shards]
        feats = []
        for p, c in entries:
            f = cls._load_one(p, resize_h, resize_w)
            f[ImageFeature.label] = np.float32(label_map[c])
            feats.append(f)
        out = LocalImageSet(feats) if num_shards == 1 else \
            DistributedImageSet(feats, shard_index, num_shards)
        out.label_map = label_map
        return out

    @staticmethod
    def _load_one(path, resize_h=-1, resize_w=-1) -> ImageFeature:
        with open(path, "rb") as f:
            raw = f.read()
        feat = ImageFeature(uri=path)
        feat[ImageFeature.bytes_key] = raw
        feat = ImageBytesToMat().apply(feat)
        if resize_h > 0 and resize_w > 0:
            img = _resize(feat.get_image(), (resize_w, resize_h))
            feat.set_image(img.astype(np.float32))
        return feat

    @classmethod
    def from_image_frame(cls, frame):  # parity alias
        return cls.array(frame)

    @classmethod
    def array(cls, images: Sequence, labels=None) -> "ImageSet":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature(np.asarray(img, np.float32))
            if labels is not None:
                f[ImageFeature.label] = np.float32(labels[i])
            feats.append(f)
        return LocalImageSet(feats)

    # -- surface -------------------------------------------------------
    def is_local(self) -> bool:
        return isinstance(self, LocalImageSet)

    def is_distributed(self) -> bool:
        return isinstance(self, DistributedImageSet)

    def to_local(self) -> "LocalImageSet":
        return LocalImageSet(self.features)

    def to_distributed(self, shard_index=0, num_shards=1):
        return DistributedImageSet(self.features, shard_index, num_shards)

    def transform(self, transformer) -> "ImageSet":
        self.features = [transformer.apply(f) for f in self.features]
        return self

    def get_image(self, key=ImageFeature.mat):
        return [f.get(key) for f in self.features]

    def get_label(self):
        return [f.get_label() for f in self.features]

    def get_predict(self, key=ImageFeature.predict):
        return [(f.get_uri(), f.get(key)) for f in self.features]

    def random_split(self, weights: Sequence[float], seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.features))
        total = float(sum(weights))
        splits, start = [], 0
        for w in weights[:-1]:
            n = int(len(idx) * w / total)
            splits.append([self.features[i] for i in idx[start:start + n]])
            start += n
        splits.append([self.features[i] for i in idx[start:]])
        outs = []
        for s in splits:
            if isinstance(self, DistributedImageSet):
                part = DistributedImageSet(s, self.shard_index,
                                           self.num_shards)
            else:
                part = type(self)(s)
            if hasattr(self, "label_map"):
                part.label_map = self.label_map
            outs.append(part)
        return outs

    def __len__(self):
        return len(self.features)

    # -- to training data ----------------------------------------------
    def to_feature_set(self, key: str = "floats") -> FeatureSet:
        """Stack transformed tensors (+labels) into an ArrayFeatureSet
        (the reference's ImageSet.toDataSet)."""
        samples = [f.get_sample() for f in self.features]
        if all(s is not None for s in samples):
            return FeatureSet.samples(samples)
        xs = np.stack([np.asarray(f[key], np.float32)
                       for f in self.features])
        labels = self.get_label()
        ys = None
        if all(l is not None for l in labels):
            ys = np.asarray(labels, np.float32)
        return ArrayFeatureSet(xs, ys)

    to_dataset = to_feature_set


class LocalImageSet(ImageSet):
    pass


class DistributedImageSet(ImageSet):
    """Per-host shard; parity for the reference's RDD-backed variant."""

    def __init__(self, features, shard_index: int = 0, num_shards: int = 1):
        super().__init__(features)
        self.shard_index = int(shard_index)
        self.num_shards = int(num_shards)
