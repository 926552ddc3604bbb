"""ZooModel base.

Counterpart of ``analytics_zoo_tpu/models/common.py`` (parity:
``ZooModel.scala`` + ``KerasZooModel`` and the python mirror
``pyzoo/zoo/models/common/zoo_model.py``): a built-in model owns an
internal Keras graph (``self.model``) and forwards the training and
inference surface to it. Saving and loading a zoo model arrive with the
persistence slice of the port and raise until then; ``Ranker`` arrives
with the text-matching models.
"""

from __future__ import annotations

_PERSISTENCE = ("saving and loading a zoo model is not ported yet; it "
                "arrives with the persistence slice of the port")


class ZooModel:
    """Base for the built-in model zoo; subclasses set ``self.model`` to a
    KerasNet built in ``build_model``."""

    model = None

    # -- training surface forwarded to the internal KerasNet -----------
    def compile(self, optimizer, loss, metrics=None):
        return self.model.compile(optimizer, loss, metrics)

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, **kw):
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                              validation_data=validation_data, **kw)

    def evaluate(self, x, y=None, batch_size=32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=128, distributed=True):
        return self.model.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size=128, zero_based_label=True):
        return self.model.predict_classes(
            x, batch_size=batch_size, zero_based_label=zero_based_label)

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.model.set_constant_gradient_clipping(min_value, max_value)

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self.model.set_gradient_clipping_by_l2_norm(clip_norm)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, weights):
        self.model.set_weights(weights)

    # -- persistence ---------------------------------------------------
    def save_model(self, path, weight_path=None, over_write=False):
        raise NotImplementedError(_PERSISTENCE)

    saveModel = save_model

    @classmethod
    def load_model(cls, path, weight_path=None):
        raise NotImplementedError(_PERSISTENCE)

    def _record_config(self, **kwargs):
        self._zoo_config = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)


KerasZooModel = ZooModel
