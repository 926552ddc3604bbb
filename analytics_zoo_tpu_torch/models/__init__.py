"""The model zoo: built-in models over the Keras-style layers.

Counterpart of ``analytics_zoo_tpu/models``; so far ``ZooModel`` and the
recommendation models ``NeuralCF`` and ``WideAndDeep`` and the image
classifiers (``models.image.imageclassification.ImageClassifier``).
"""

from .common import KerasZooModel, ZooModel

__all__ = ["KerasZooModel", "ZooModel"]
