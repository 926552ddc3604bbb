from .text_classifier import TextClassifier

__all__ = ["TextClassifier"]
