"""BERT estimator base.

Counterpart of ``analytics_zoo_tpu/tfpark/text/estimator/bert_base.py``
(parity target ``pyzoo/zoo/tfpark/text/estimator/bert_base.py:108``,
where ``BERTBaseEstimator`` wires the original TF BERT ``model_fn`` into
TFPark's TFEstimator and ``bert_input_fn`` adapts RDDs of feature dicts).
As in the JAX package, the estimators build on the in-repo BERT layer: a
zoo ``Model`` = BERT trunk + task head, trained by the port's engine, so
train, evaluate and predict run the trunk's attention (K1-K3) and fused
dropout + layer norm (K4-K5) kernels on the card. ``model_dir`` and
``init_checkpoint`` are the engine's checkpoint store, the JAX package's
format: either package resumes the other's directory.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ....common.zoo_trigger import MaxEpoch, MaxIteration
from ....feature.feature_set import ArrayFeatureSet
from ....pipeline.api.keras.engine.base import Input
from ....pipeline.api.keras.layers.self_attention import BERT
from ....pipeline.api.keras.models import Model
from ....pipeline.api.keras.optimizers import get_optimizer


def bert_input_fn(features: Dict[str, np.ndarray],
                  labels: Optional[np.ndarray] = None,
                  batch_size: int = 32):
    """Build the estimator input from BERT feature dicts
    (``input_ids``, optional ``input_mask``, ``token_type_ids``).

    Reference surface: ``bert_base.py`` ``bert_input_fn(rdd, ...)``; here
    the data plane is host arrays (the RDD tier dissolved into FeatureSet).
    Returns a callable so call sites match the reference's input_fn style.
    """
    ids = np.asarray(features["input_ids"], np.int32)
    b, l = ids.shape
    mask = np.asarray(features.get("input_mask", np.ones((b, l))),
                      np.float32).reshape(b, 1, 1, l)
    seg = np.asarray(features.get("token_type_ids", np.zeros((b, l))),
                     np.int32)
    pos = np.tile(np.arange(l, dtype=np.int32), (b, 1))
    xs = [ids, pos, seg, mask]
    if labels is None:
        ys = None
    elif isinstance(labels, (list, tuple)):
        ys = [np.asarray(lab) for lab in labels]
    else:
        ys = np.asarray(labels)

    def input_fn():
        return ArrayFeatureSet(xs, ys), batch_size
    return input_fn


class BERTBaseEstimator:
    """Common machinery: BERT trunk + ``head_fn``-built head.

    Subclasses pass ``head_fn(seq_output_var, pooled_var) -> output var(s)``
    plus the loss; ``params`` mirrors the reference's estimator params dict.
    """

    def __init__(self, head_fn: Callable, loss, vocab_size: int = 30522,
                 hidden_size: int = 768, n_block: int = 12, n_head: int = 12,
                 seq_length: int = 128, intermediate_size: Optional[int] =
                 None, optimizer="adam", model_dir: Optional[str] = None,
                 init_checkpoint: Optional[str] = None,
                 bert_config_file: Optional[str] = None, **params):
        self.bert_config = None
        if bert_config_file:
            # the reference's estimators build their trunk from a google
            # bert_config.json (bert_base.py:108 model_fn); its keys win
            # over the constructor's arguments where it names them
            with open(bert_config_file) as f:
                cfg = json.load(f)
            vocab_size = cfg.get("vocab_size", vocab_size)
            hidden_size = cfg.get("hidden_size", hidden_size)
            n_block = cfg.get("num_hidden_layers", n_block)
            n_head = cfg.get("num_attention_heads", n_head)
            intermediate_size = cfg.get("intermediate_size",
                                        intermediate_size)
            seq_length = min(seq_length,
                             cfg.get("max_position_embeddings", seq_length))
            self.bert_config = cfg
        self.params = dict(params)
        self.model_dir = model_dir
        self.bert = BERT(vocab=vocab_size, hidden_size=hidden_size,
                         n_block=n_block, n_head=n_head, seq_len=seq_length,
                         intermediate_size=intermediate_size or
                         4 * hidden_size, output_all_block=False)
        tokens = Input(shape=(seq_length,), name="input_ids")
        positions = Input(shape=(seq_length,), name="positions")
        segments = Input(shape=(seq_length,), name="token_type_ids")
        mask = Input(shape=(1, 1, seq_length), name="input_mask")
        seq_out, pooled = self.bert([tokens, positions, segments, mask])
        outputs = head_fn(seq_out, pooled)
        self.model = Model([tokens, positions, segments, mask],
                           outputs if isinstance(outputs, (list, tuple))
                           else [outputs])
        self.model.compile(optimizer=get_optimizer(optimizer), loss=loss)
        if init_checkpoint:
            self.load_checkpoint(init_checkpoint)

    # ------------------------------------------------------------------
    def _resolve(self, input_fn):
        fs, batch_size = input_fn() if callable(input_fn) else input_fn
        return fs, batch_size

    def train(self, input_fn, steps: Optional[int] = None,
              epochs: Optional[int] = None):
        fs, batch_size = self._resolve(input_fn)
        trainer = self.model._ensure_trainer()
        # triggers are absolute against the trainer's global counters:
        # offset so repeated train() calls keep advancing
        end = MaxIteration(trainer.step + steps) if steps is not None else \
            MaxEpoch(trainer.epoch + (epochs or 1))
        trainer.train(fs, batch_size, end_trigger=end)
        if self.model_dir:
            trainer.checkpoint_dir = self.model_dir
            trainer.save_checkpoint(self.model_dir)
        return self

    def evaluate(self, input_fn, metrics: Optional[Sequence[str]] = None
                 ) -> Dict[str, float]:
        fs, batch_size = self._resolve(input_fn)
        trainer = self.model._ensure_trainer()
        if metrics:
            from ....pipeline.api.keras.metrics import get_metric

            trainer.metrics = [get_metric(m, trainer.loss_fn)
                               for m in metrics]
        return trainer.evaluate(fs, batch_size)

    def predict(self, input_fn):
        fs, batch_size = self._resolve(input_fn)
        return self.model.predict(list(fs.features), batch_size=batch_size)

    # ------------------------------------------------------------------
    def load_checkpoint(self, directory: str):
        trainer = self.model._ensure_trainer()
        trainer.load_checkpoint(directory)
