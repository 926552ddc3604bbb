"""TFPark (counterpart of ``analytics_zoo_tpu/tfpark``; reference
``pyzoo/zoo/tfpark``).

TensorFlow models -- tf.keras models, raw loss graphs, estimator
model_fns -- trained and served by the port's engine: the graphs lower
ONCE to torch (``tfpark.tf_bridge``) and train through the port's
``SPMDTrainer``, with trained weights written back into the live TF
objects. ``TFDataset``, ``GANEstimator`` and ``tfpark.text`` need no
TensorFlow; the lowering bridge and what stands on it (``KerasModel``,
``TFEstimator``, ``TFOptimizer``) import it when they trace, and raise
``ImportError`` naming it where it is not installed.
"""

from .estimator import ModeKeys, TFEstimator, TFEstimatorSpec
from .gan_estimator import GANEstimator
from .model import KerasModel
from .tf_bridge import LoweredTF, lower_keras_model, lower_tf_callable
from .tf_dataset import TFDataset
from .tf_optimizer import TFOptimizer

__all__ = ["TFDataset", "TFOptimizer", "TFEstimator", "TFEstimatorSpec",
           "ModeKeys", "KerasModel", "GANEstimator", "LoweredTF",
           "lower_keras_model", "lower_tf_callable"]
