"""Parity module path: ``zoo.pipeline.inference``."""

from .inference_model import (AbstractModel, FloatModel, InferenceModel,
                              QuantizedModel)
from .inference_summary import InferenceSummary

__all__ = ["InferenceModel", "AbstractModel", "FloatModel",
           "QuantizedModel", "InferenceSummary"]
