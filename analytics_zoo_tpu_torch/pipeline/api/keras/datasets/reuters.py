"""Reuters newswire loader (parity: ``datasets/reuters.py`` —
``load_data(dest_dir, nb_words, oov_char, test_split)``; 46 topic
classes)."""

from __future__ import annotations

import logging
import os

import numpy as np

from .imdb import _cap_words

logger = logging.getLogger("analytics_zoo_tpu_torch.datasets")

VOCAB = 5000
N_CLASSES = 46


def _synth(n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, n)
    seqs = []
    for y in labels:
        length = int(rng.integers(15, 120))
        ids = np.clip(rng.zipf(1.3, length).astype(np.int64) + 3, 4,
                      VOCAB - 1)
        topic = rng.integers(0, 20, max(length // 6, 1)) + 100 + 20 * y
        seqs.append(np.concatenate([ids, topic]).tolist())
    return seqs, labels.astype(np.int64)


def load_data(dest_dir="/tmp/.zoo/dataset", nb_words=None, oov_char=2,
              test_split=0.2):
    cache = os.path.join(dest_dir, "reuters.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as data:
            xs, ys = list(data["x"]), data["y"]
    else:
        logger.warning("reuters.npz not found under %s (no egress); "
                       "returning a deterministic synthetic surrogate",
                       dest_dir)
        xs, ys = _synth(2500, 0)
    xs = _cap_words(xs, nb_words, oov_char)
    # seeded shuffle before splitting (reference pattern; an ordered
    # corpus would otherwise put whole topic classes only in test)
    rng = np.random.default_rng(113)
    order = rng.permutation(len(xs))
    xs = [xs[i] for i in order]
    ys = np.asarray(ys)[order]
    split = int(len(xs) * (1 - test_split))
    return (xs[:split], ys[:split]), (xs[split:], ys[split:])
