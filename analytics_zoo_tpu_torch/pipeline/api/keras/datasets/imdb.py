"""IMDB sentiment loader (parity: ``datasets/imdb.py`` — ``load_data(
dest_dir, nb_words, oov_char)`` returning variable-length frequency-indexed
word-id sequences + binary labels, and ``get_word_index``)."""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.datasets")

VOCAB = 5000


def _cap_words(seqs, nb_words, oov_char):
    """Reference semantics: ids >= nb_words become ``oov_char``, or are
    DROPPED when ``oov_char`` is None."""
    if nb_words is None:
        return seqs
    out = []
    for seq in seqs:
        if oov_char is None:
            out.append([w for w in seq if w < nb_words])
        else:
            out.append([w if w < nb_words else oov_char for w in seq])
    return out


def _synth_split(n, seed):
    """Frequency-indexed sequences (Zipf-ish) whose sentiment shifts the
    word distribution — learnable by the text-classifier examples."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    seqs = []
    for y in labels:
        length = int(rng.integers(20, 200))
        base = rng.zipf(1.3, length).astype(np.int64)
        ids = np.clip(base + 3, 4, VOCAB - 1)        # 0-3 reserved
        # sentiment-marked tokens drawn from disjoint id bands
        marks = rng.integers(10, 60, max(length // 8, 1)) + \
            (0 if y == 0 else 60)
        seqs.append(np.concatenate([ids, marks]).tolist())
    return seqs, labels.astype(np.int64)


def load_data(dest_dir="/tmp/.zoo/dataset", nb_words=None, oov_char=2):
    cache = os.path.join(dest_dir, "imdb.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as data:
            x_train, y_train = list(data["x_train"]), data["y_train"]
            x_test, y_test = list(data["x_test"]), data["y_test"]
    else:
        logger.warning("imdb.npz not found under %s (no egress); "
                       "returning a deterministic synthetic surrogate",
                       dest_dir)
        x_train, y_train = _synth_split(2000, 0)
        x_test, y_test = _synth_split(500, 1)
    return ((_cap_words(x_train, nb_words, oov_char), y_train),
            (_cap_words(x_test, nb_words, oov_char), y_test))


def get_word_index(dest_dir="/tmp/.zoo/dataset"):
    path = os.path.join(dest_dir, "imdb_word_index.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {f"word{i}": i for i in range(4, VOCAB)}
