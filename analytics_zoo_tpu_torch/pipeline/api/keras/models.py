"""Parity module path: ``zoo.pipeline.api.keras.models``."""

from .engine.topology import KerasNet, Model

__all__ = ["KerasNet", "Model"]
