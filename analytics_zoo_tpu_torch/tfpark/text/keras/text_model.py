"""TextKerasModel base.

Counterpart of ``analytics_zoo_tpu/tfpark/text/keras/text_model.py``
(parity target ``pyzoo/zoo/tfpark/text/keras/text_model.py``, which wraps
an ``nlp_architect`` tf.keras "labor" model). The labor networks (NER
tagger, sequence tagger, intent + slot model) are built on the port's
Keras layers; this base gives them the common compile / fit / evaluate /
predict and save / load surface. ``_SubLayerNet`` is the port's shape of
the JAX nets' composite layers: sub-layers held as submodules under the
stable keys the JAX params tree uses (``sub{i}_{class}``).
"""

from __future__ import annotations

from typing import Any

import torch

from ....pipeline.api.keras.engine.base import KerasLayer


class _SubLayerNet(KerasLayer):
    """A layer made of sub-layers. :meth:`_set_subs` registers them in
    order as submodules named ``sub{i}_{class}`` (the JAX nets'
    ``_stabilize_sub_names``: auto-generated names depend on global
    counters, so a rebuilt net, as a definition load builds it, would
    otherwise key its parameters differently); :meth:`_keep` holds a
    named reference to a sub-layer without registering it twice.
    Subclasses give each sub-layer's input shape (``_sub_shapes``)."""

    stochastic = True

    def _keep(self, **subs):
        for key, sub in subs.items():
            object.__setattr__(self, key, sub)

    def _set_subs(self, subs):
        object.__setattr__(self, "_subs", list(subs))
        for i, sub in enumerate(self._subs):
            sub.name = f"sub{i}_{type(sub).__name__.lower()}"
            self.add_module(sub.name, sub)

    def _sub_shapes(self):
        raise NotImplementedError

    def build_params(self, generator, input_shape) -> None:
        self.built = True
        for sub, shape in zip(self._subs, self._sub_shapes()):
            if not sub.built:
                sub.build_params(generator, shape)

    def _chars_to_words(self, words, chars, training):
        """``[word embedding ∥ char-BiLSTM features]`` (B, L, .) for word
        ids (B, L) and char ids (B, L, W)."""
        b, l = words.shape
        w = self.word_emb(words)
        c = self.char_emb(chars)
        cw = c.reshape((b * l,) + tuple(c.shape[2:]))     # (B*L, W, ce)
        cf = self.char_lstm(cw, training=training).reshape(b, l, -1)
        return torch.cat([w, cf], dim=-1)


class TextKerasModel:
    """Common surface for the tfpark text models.

    Subclasses build ``self.model`` (a zoo Keras ``Model``) in __init__ and
    hand their losses (one per output) to this constructor."""

    def __init__(self, model, optimizer, losses, loss_weights=None):
        from ....pipeline.api.keras.optimizers import Adam

        self.model = model
        self.labor = model  # reference attribute name for the inner model
        loss: Any = list(losses) if len(losses) > 1 else losses[0]
        if loss_weights is not None:
            from ....pipeline.api.keras.objectives import MultiLoss
            loss = MultiLoss(list(losses), loss_weights)
        self.model.compile(optimizer=optimizer or Adam(lr=1e-3), loss=loss)

    # ------------------------------------------------------------------
    def fit(self, x, y, batch_size: int = 32, epochs: int = 1,
            validation_data=None, distributed: bool = True):
        self.model.fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                       validation_data=validation_data)
        return self

    def evaluate(self, x, y, batch_size: int = 32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 128, distributed: bool = True):
        return self.model.predict(x, batch_size=batch_size)

    # ------------------------------------------------------------------
    def save_model(self, path: str):
        self.model.save_model(path)

    @classmethod
    def _load_model(cls, path: str):
        from ....pipeline.api.keras.models import Model

        obj = cls.__new__(cls)
        obj.model = Model.load_model(path)
        obj.labor = obj.model
        return obj
