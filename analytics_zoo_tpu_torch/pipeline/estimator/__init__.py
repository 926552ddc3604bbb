from .estimator import AbstractEstimator, Estimator, MultiOptimizer
from .local_estimator import LocalEstimator

__all__ = ["AbstractEstimator", "Estimator", "LocalEstimator",
           "MultiOptimizer"]
