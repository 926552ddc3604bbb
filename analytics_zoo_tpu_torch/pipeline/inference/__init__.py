"""Parity module path: ``zoo.pipeline.inference``."""

from .inference_model import AbstractModel, FloatModel, InferenceModel

__all__ = ["InferenceModel", "AbstractModel", "FloatModel"]
