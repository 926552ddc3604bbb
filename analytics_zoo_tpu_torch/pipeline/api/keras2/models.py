"""Keras-2 model entry points.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras2/models.py``: the
Keras-1 topology with the Keras-2 argument dialect on the training
surface, ``fit(epochs=...)`` and ``validation_split=``.
"""

from __future__ import annotations

import numpy as np

from ..keras import models as k1


class _Keras2Fit:
    """Keras-2 training-surface dialect over the keras-1 topology."""

    def fit(self, x, y=None, batch_size=32, epochs=None,
            validation_data=None, distributed=True,
            checkpoint_trigger=None, validation_split=0.0, **kw):
        # positional arg order matches the keras-1 fit this class
        # previously aliased (x, y, batch_size, epochs, validation_data,
        # distributed, checkpoint_trigger) — validation_split is
        # keyword-position-last so existing positional callers keep
        # their meaning
        if "nb_epoch" in kw:   # accept the keras-1 spelling too
            nb = kw.pop("nb_epoch")
            if epochs is not None and epochs != nb:
                raise TypeError(
                    f"conflicting epochs={epochs} and nb_epoch={nb}")
            epochs = nb
        if kw:  # unknown kwargs must fail loudly, as KerasNet.fit does
            raise TypeError(
                f"fit() got unexpected keyword arguments {sorted(kw)}")
        epochs = 10 if epochs is None else int(epochs)
        if validation_data is not None:
            validation_split = 0.0   # keras-2 precedence: explicit
            # validation_data wins; the split is ignored
        if validation_split:
            if not 0.0 < float(validation_split) < 1.0:
                raise ValueError(
                    f"validation_split must be in (0, 1), got "
                    f"{validation_split}")
            if y is None:
                raise ValueError(
                    "validation_split requires array inputs (x, y); pass "
                    "validation_data for FeatureSet/ImageSet input")
            xs = [np.asarray(a) for a in
                  (x if isinstance(x, (list, tuple)) else [x])]
            ys = [np.asarray(a) for a in
                  (y if isinstance(y, (list, tuple)) else [y])]
            n = xs[0].shape[0]   # sample axis, NOT len(y) — y may be a
            # multi-output label LIST (ArrayFeatureSet supports those)
            n_val = int(n * float(validation_split))
            if n_val > 0:
                # keras-2 semantics: the split is taken from the END of
                # the (un-shuffled) inputs
                val_x = [a[n - n_val:] for a in xs]
                val_y = [a[n - n_val:] for a in ys]
                validation_data = (
                    val_x if len(val_x) > 1 else val_x[0],
                    val_y if len(val_y) > 1 else val_y[0])
                trn_x = [a[:n - n_val] for a in xs]
                trn_y = [a[:n - n_val] for a in ys]
                x = trn_x if len(trn_x) > 1 else trn_x[0]
                y = trn_y if len(trn_y) > 1 else trn_y[0]
        return super().fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                           validation_data=validation_data,
                           distributed=distributed,
                           checkpoint_trigger=checkpoint_trigger)

    @staticmethod
    def load_model(path):
        """Load and KEEP the keras-2 dialect: the underlying loader
        rebuilds keras-1 classes, so re-bless onto the keras2 twins
        (same layout — the mixin adds behavior only)."""
        obj = k1.KerasNet.load_model(path)
        if type(obj) is k1.Sequential:
            obj.__class__ = Sequential
        elif type(obj) is k1.Model:
            obj.__class__ = Model
        return obj


class Sequential(_Keras2Fit, k1.Sequential):
    pass


class Model(_Keras2Fit, k1.Model):
    pass


__all__ = ["Model", "Sequential"]
