"""analytics-zoo-tpu-torch: the PyTorch and CUDA port of ``analytics_zoo_tpu``
for one NVIDIA H100 (Hopper).

The JAX package stays beside it as the reference; each module here keeps
its counterpart's subpackage and module name. This package imports
``torch`` and never ``jax`` or ``analytics_zoo_tpu``.

Package map (the part ported so far: serving, training in float32 or
bf16 with checkpoints and gradient accumulation, saving and loading, and
generating with Keras-style models, recurrent ones among them):
  common/     context: config (``compute_dtype`` among it) and the device
              the entry points run on; the trigger algebra
  feature/    ``Sample``, ``FeatureSet``: in-memory arrays batched in the
              JAX order
  models/     ``ZooModel``; the recommenders ``NeuralCF``,
              ``WideAndDeep`` and ``SessionRecommender``; the image
              classifiers; ``TextClassifier``, ``AnomalyDetector``,
              ``KNRM`` and ``Seq2seq``
  ops/        attention (hand-written CUDA flash-attention forward and
              backward under ``ops/csrc``), layer norm, dropout + residual
              + layer norm (hand-written CUDA forward and backward), the
              KV cache
  pipeline/   keras-style graph, layers (the recurrent ones and their
              wrappers among them), ``Lambda``, ``Model`` and ``Sequential`` with
              ``compile``/``fit``/``evaluate``/``predict`` and
              ``save_model``/``load_model`` (``engine/model_io.py``),
              losses, metrics, optimizers, the training engine (with its
              checkpoint store), ``Estimator`` and ``InferenceModel``
  serving/    generation: decode engines and the continuous-batching
              scheduler
  utils/      ``load_jax_params``: copy a JAX model's weights into the
              port; the files both packages read and write
              (``serialization``, ``crc32c`` over a g++-built loop,
              ``tensorboard``), ``file_io`` and ``faults``
"""

__version__ = "0.1.0"
