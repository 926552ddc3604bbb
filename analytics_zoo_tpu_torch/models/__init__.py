"""The model zoo: built-in models over the Keras-style layers.

Counterpart of ``analytics_zoo_tpu/models``; so far ``ZooModel`` and
``Ranker``, the recommendation models (``NeuralCF``, ``WideAndDeep``,
``SessionRecommender``), the image classifiers
(``models.image.imageclassification.ImageClassifier``),
``textclassification.TextClassifier``,
``anomalydetection.AnomalyDetector``, ``textmatching.KNRM`` and
``seq2seq.Seq2seq``. ``image.objectdetection`` (SSD) is not ported yet
(ROADMAP A9).
"""

from .common import KerasZooModel, ZooModel

__all__ = ["KerasZooModel", "ZooModel"]
