"""TFPark (counterpart of ``analytics_zoo_tpu/tfpark``; reference
``pyzoo/zoo/tfpark``).

Ported so far: ``TFDataset`` (a declarative wrapper over the port's
``FeatureSet``), ``GANEstimator`` (alternating generator/discriminator
updates) and ``tfpark.text`` (the text models and BERT estimators). The
parts that trace TensorFlow graphs (``KerasModel``, ``TFEstimator``,
``TFOptimizer``, the graph bridge) are ROADMAP A14.8's items 3-5. Nothing
here imports TensorFlow.
"""

from .gan_estimator import GANEstimator
from .tf_dataset import TFDataset

__all__ = ["TFDataset", "GANEstimator"]
