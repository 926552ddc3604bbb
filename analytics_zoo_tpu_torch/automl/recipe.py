"""Search-space recipes (automl-branch Recipe spec: named default spaces
the user picks instead of hand-writing a search space).

Counterpart of ``analytics_zoo_tpu/automl/recipe.py``."""

from __future__ import annotations

from typing import Dict

from .search import Choice, RandInt, Uniform


class Recipe:
    """A named search space + trial budget."""

    num_samples = 4
    epochs = 1

    def search_space(self) -> Dict:
        raise NotImplementedError


class LSTMRandomRecipe(Recipe):
    def __init__(self, num_samples: int = 4, epochs: int = 1):
        self.num_samples = num_samples
        self.epochs = epochs

    def search_space(self):
        return {
            "model": "lstm",
            "lstm_units": Choice([(16,), (32,), (32, 16)]),
            "dropout": Uniform(0.0, 0.3),
            "lr": Choice([1e-2, 3e-3, 1e-3]),
            "batch_size": Choice([16, 32]),
        }


class TCNRandomRecipe(Recipe):
    def __init__(self, num_samples: int = 4, epochs: int = 1):
        self.num_samples = num_samples
        self.epochs = epochs

    def search_space(self):
        return {
            "model": "tcn",
            "n_filters": Choice([8, 16, 32]),
            "kernel_size": Choice([2, 3]),
            "n_blocks": RandInt(1, 3),
            "dropout": Uniform(0.0, 0.3),
            "lr": Choice([1e-2, 3e-3, 1e-3]),
            "batch_size": Choice([16, 32]),
        }
