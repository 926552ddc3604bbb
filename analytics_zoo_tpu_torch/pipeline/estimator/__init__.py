from .estimator import AbstractEstimator, Estimator, MultiOptimizer

__all__ = ["AbstractEstimator", "Estimator", "MultiOptimizer"]
