"""Parity module path: ``zoo.pipeline.nnframes``."""

from .nn_estimator import (NNClassifier, NNClassifierModel, NNEstimator,
                           NNModel)
from .nn_image_reader import NNImageReader, NNImageSchema

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader", "NNImageSchema"]
