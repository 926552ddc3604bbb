"""Boston-housing loader (parity: ``datasets/boston_housing.py`` —
``load_data(path, dest_dir, test_split)`` returning 13-feature regression
rows)."""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.datasets")

N_ROWS, N_FEATURES = 506, 13


def load_data(path="boston_housing.npz", dest_dir="/tmp/.zoo/dataset",
              test_split=0.2):
    cache = os.path.join(dest_dir, path)
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=False) as data:
            x, y = data["x"], data["y"]
    else:
        logger.warning("%s not found under %s (no egress); returning a "
                       "deterministic synthetic surrogate", path, dest_dir)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((N_ROWS, N_FEATURES)).astype(np.float64)
        w = rng.standard_normal(N_FEATURES)
        y = (22.5 + x @ w * 2.0 +
             rng.normal(0, 2.0, N_ROWS)).astype(np.float64)
    rng = np.random.default_rng(113)        # reference shuffles with seed
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    split = int(len(x) * (1 - test_split))
    return (x[:split], y[:split]), (x[split:], y[split:])
