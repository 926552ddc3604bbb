"""TFPark ``KerasModel`` -- tf.keras models trained by the port's engine.

Counterpart of ``analytics_zoo_tpu/tfpark/model.py`` (parity:
``pyzoo/zoo/tfpark/model.py:30``; ``_fit_distributed``:160,
``_evaluate_distributed``:218, ``_predict_distributed``:293). The
tf.keras model is lowered ONCE to torch (``tf_bridge``), trained by the
port's ``SPMDTrainer`` as a one-layer zoo ``Model`` around a ``TFNet``,
and the trained weights are assigned back into the live tf.keras object,
so the user's model is updated in place. Lowering needs TensorFlow.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..feature.feature_set import FeatureSet
from ..pipeline.api.keras.engine.base import Input
from ..pipeline.api.keras.models import Model as ZooModel
from ..pipeline.api.net.tfnet import TFNet
from .tf_bridge import lower_keras_model
from .tf_dataset import TFDataset, _tensors_to_fs

_LOSS_NAMES = {
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "binary_crossentropy": "binary_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kld": "kld", "kullback_leibler_divergence": "kld",
    "poisson": "poisson", "cosine_proximity": "cosine_proximity",
}


def _map_loss(loss) -> str:
    if loss is None:
        raise ValueError("the tf.keras model must be compiled with a loss")
    name = loss if isinstance(loss, str) else \
        getattr(loss, "name", None) or type(loss).__name__
    key = name.lower()
    # class names like MeanSquaredError -> snake
    snake = "".join(("_" + c.lower()) if c.isupper() else c
                    for c in name).lstrip("_")
    for cand in (key, snake):
        if cand in _LOSS_NAMES:
            return _LOSS_NAMES[cand]
    return key  # let get_loss() decide / raise


def _map_optimizer(optimizer):
    from ..pipeline.api.keras.optimizers import SGD, Adam, RMSprop

    if optimizer is None or isinstance(optimizer, str):
        return optimizer or "adam"
    cfg = optimizer.get_config() if hasattr(optimizer, "get_config") else {}
    name = cfg.get("name", type(optimizer).__name__).lower()
    lr = cfg.get("learning_rate", 1e-3)
    if isinstance(lr, dict):  # schedule config; fall back to initial lr
        lr = lr.get("config", {}).get("initial_learning_rate", 1e-3)
    lr = float(lr)
    if "adam" in name:
        return Adam(lr=lr)
    if "rmsprop" in name:
        return RMSprop(lr=lr)
    if "sgd" in name:
        return SGD(lr=lr, momentum=float(cfg.get("momentum", 0.0)))
    return Adam(lr=lr)


def tfnet_model(graph_fn, input_shapes, optimizer, loss, metrics=None,
                first_output: bool = False):
    """(compiled zoo ``Model``, its ``TFNet``) over ``graph_fn`` (inputs
    ``in0``, ``in1``, ...); with ``first_output`` only its first output
    is the model's (a loss graph's loss)."""
    net = TFNet(graph_fn=graph_fn)
    ins = [Input(shape=tuple(s), name=f"in{k}")
           for k, s in enumerate(input_shapes)]
    out = net(ins if len(ins) > 1 else ins[0])
    if first_output and isinstance(out, tuple):
        out = out[0]
    zoo = ZooModel(ins, list(out) if isinstance(out, tuple) else out)
    zoo.compile(optimizer=optimizer, loss=loss, metrics=metrics)
    return zoo, net


class KerasModel:
    """Wraps a compiled ``tf.keras.Model``; fit/evaluate/predict run on
    the port's engine (model.py:30 parity)."""

    def __init__(self, model):
        self.model = model
        self._lowered = None
        self._zoo_model: Optional[ZooModel] = None
        self._tfnet: Optional[TFNet] = None

    # -- lowering -------------------------------------------------------
    def _ensure_lowered(self) -> ZooModel:
        if self._zoo_model is not None:
            return self._zoo_model
        self._warn_inference_semantics()
        self._lowered = lower_keras_model(self.model, training=False)
        loss = getattr(self.model, "loss", None)
        self._zoo_model, self._tfnet = tfnet_model(
            self._lowered.graph_fn,
            [tuple(i.shape[1:]) for i in self.model.inputs],
            _map_optimizer(getattr(self.model, "optimizer", None)),
            _map_loss(loss),
            metrics=["accuracy"] if _is_classification(loss) else None)
        return self._zoo_model

    def _warn_inference_semantics(self):
        """The graph lowers in inference mode: dropout is a no-op and BN
        normalizes with (trainable) moving statistics rather than batch
        statistics. Flag it once so training behavior isn't a surprise."""
        import warnings

        stochastic = [l.name for l in getattr(self.model, "layers", [])
                      if type(l).__name__ in ("Dropout",
                                              "BatchNormalization",
                                              "GaussianNoise")]
        if stochastic:
            warnings.warn(
                "tfpark.KerasModel lowers the tf.keras graph with "
                f"training=False; layers {stochastic} will use inference "
                "semantics during fit (dropout off, BN moving stats). "
                "For exact training-mode parity build the model with "
                "analytics_zoo_tpu_torch keras layers instead.",
                stacklevel=3)

    def _sync_back(self):
        """Copy trained params back into the live tf.keras variables."""
        if self._zoo_model is None or self._zoo_model.trainer is None:
            return
        self._lowered.write_back(self._tfnet.param_tree())

    # -- training surface (model.py fit/evaluate/predict) ---------------
    def fit(self, x=None, y=None, batch_size: int = 32, epochs: int = 1,
            validation_data=None, distributed: bool = True, **kw):
        zoo = self._ensure_lowered()
        data, val, bs = _resolve_data(x, y, batch_size, validation_data)
        zoo.fit(data, batch_size=bs, nb_epoch=epochs,
                validation_data=val, **kw)
        self._sync_back()
        return self

    def evaluate(self, x=None, y=None, batch_per_thread: int = 32,
                 distributed: bool = True) -> Dict[str, float]:
        zoo = self._ensure_lowered()
        data, _, bs = _resolve_data(x, y, batch_per_thread, None)
        return zoo.evaluate(data, batch_size=bs)

    def predict(self, x, batch_per_thread: int = 32,
                distributed: bool = True):
        zoo = self._ensure_lowered()
        data, _, bs = _resolve_data(x, None, batch_per_thread, None)
        return zoo.predict(data, batch_size=bs)

    # -- persistence (model.py:56-73) -----------------------------------
    def save_model(self, path: str):
        self._sync_back()
        self.model.save(path)

    @staticmethod
    def load_model(path: str) -> "KerasModel":
        from ..pipeline.api.net.tfnet import _tf

        tf = _tf("KerasModel.load_model")
        return KerasModel(tf.keras.models.load_model(path, compile=True))


def _is_classification(loss) -> bool:
    name = loss if isinstance(loss, str) else type(loss).__name__
    return "crossentropy" in str(name).lower().replace("_", "")


def _resolve_data(x, y, batch_size, validation_data):
    """Accept TFDataset / FeatureSet / ndarrays, mirroring the reference's
    dual local-vs-TFDataset dispatch (model.py:90-160)."""
    if isinstance(x, TFDataset):
        return x.feature_set, x.validation_set, x.batch_size
    if isinstance(x, FeatureSet):
        return x, validation_data, batch_size
    fs = _tensors_to_fs((x, y) if y is not None else x)
    val = None
    if validation_data is not None:
        val = _tensors_to_fs(validation_data)
    return fs, val, batch_size
