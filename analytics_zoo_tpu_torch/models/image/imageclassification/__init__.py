from .image_classifier import ImageClassifier, backbones

__all__ = ["ImageClassifier", "backbones"]
