"""analytics-zoo-tpu-torch: the PyTorch and CUDA port of ``analytics_zoo_tpu``
for one NVIDIA H100 (Hopper).

The JAX package stays beside it as the reference; each module here keeps
its counterpart's subpackage and module name. This package imports
``torch`` and never ``jax`` or ``analytics_zoo_tpu``.

Package map (the part ported so far: serving and training a Keras model):
  common/     context: config and the device the entry points run on; the
              trigger algebra
  feature/    ``FeatureSet``: in-memory arrays batched in the JAX order
  ops/        attention (hand-written CUDA flash-attention forward and
              backward under ``ops/csrc``), layer norm, dropout + residual
              + layer norm (hand-written CUDA forward and backward)
  pipeline/   keras-style graph, layers, ``Model`` with ``compile``/
              ``fit``/``evaluate``/``predict``, losses, metrics,
              optimizers, the training engine, and ``InferenceModel``
  utils/      ``load_jax_params``: copy a JAX model's weights into the port
"""

__version__ = "0.1.0"
