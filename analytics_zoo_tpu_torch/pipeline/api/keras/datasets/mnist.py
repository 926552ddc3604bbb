"""MNIST loader (parity: ``datasets/mnist.py`` — idx/gzip files under
``<location>``; returns ``(train_images, train_labels), (test_images,
test_labels)`` with images ``(N, 28, 28, 1)`` uint8-valued float arrays)."""

from __future__ import annotations

import gzip
import logging
import os
import struct

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.datasets")

TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
TRAIN_LABELS = "train-labels-idx1-ubyte.gz"
TEST_IMAGES = "t10k-images-idx3-ubyte.gz"
TEST_LABELS = "t10k-labels-idx1-ubyte.gz"


def _read_idx_images(path):
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx3 magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path):
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx1 magic {magic}")
        return np.frombuffer(f.read(n), np.uint8)


def _synth(n, seed):
    """Deterministic digit-like surrogate: each class is a distinct blob
    pattern + noise (learnable by the lenet examples, not real MNIST)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    yy, xx = np.mgrid[0:28, 0:28]
    images = rng.integers(0, 30, (n, 28, 28)).astype(np.float32)
    for digit in range(10):
        cy, cx = 6 + 2 * (digit % 5), 6 + 3 * (digit // 5)
        blob = 220.0 * np.exp(-(((yy - cy - 7) / 4.0) ** 2 +
                                ((xx - cx - 7) / 4.0) ** 2))
        images[labels == digit] += blob
    return np.clip(images, 0, 255)[..., None].astype(np.uint8), labels


def load_data(location="/tmp/.zoo/dataset/mnist"):
    paths = {name: os.path.join(location, name) for name in
             (TRAIN_IMAGES, TRAIN_LABELS, TEST_IMAGES, TEST_LABELS)}
    if all(os.path.exists(p) for p in paths.values()):
        return ((_read_idx_images(paths[TRAIN_IMAGES]),
                 _read_idx_labels(paths[TRAIN_LABELS])),
                (_read_idx_images(paths[TEST_IMAGES]),
                 _read_idx_labels(paths[TEST_LABELS])))
    logger.warning("MNIST files not found under %s (no egress to download"
                   "); returning a deterministic synthetic surrogate",
                   location)
    return _synth(6000, 0), _synth(1000, 1)
