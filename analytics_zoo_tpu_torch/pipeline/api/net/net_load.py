"""``Net`` loader facade.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/net_load.py``
(parity: ``NetUtils.scala:142`` -- ``Net.load``, ``Net.loadTF``,
``Net.loadTorch``, ``Net.loadCaffe`` -- and python ``net_load.py:77-127``).
``load_tf`` of a frozen ``.pb`` or of a SavedModel without variables needs
no TensorFlow; ``load_keras`` does (``tfnet.py``).
"""

from __future__ import annotations

import os


class Net:
    """Static loaders returning framework models."""

    @staticmethod
    def load(path: str, weight_path=None):
        """Load a model saved by this framework (Net.load parity)."""
        from ..keras.models import KerasNet
        return KerasNet.load_model(path)

    @staticmethod
    def load_tf(path: str, **kw):
        """Frozen pb / SavedModel / keras h5 -> TFNet (Net.loadTF parity)."""
        from .tfnet import TFNet
        return TFNet.from_path(path, **kw)

    @staticmethod
    def load_keras(path: str, **kw):
        """Keras h5/keras file -> TFNet via tf.keras (Net.loadKeras)."""
        from .tfnet import TFNet
        return TFNet.from_keras(path, **kw)

    @staticmethod
    def load_torch(module_or_path, **kw):
        """nn.Module or TorchScript file -> TorchNet (Net.loadTorch)."""
        from .torchnet import TorchNet
        if isinstance(module_or_path, (str, os.PathLike)):
            import torch
            module = torch.jit.load(str(module_or_path), map_location="cpu")
            return TorchNet(module, lower=False, **kw)
        return TorchNet.from_pytorch(module_or_path, **kw)

    @staticmethod
    def load_onnx(path: str):
        """ONNX file -> zoo Keras Model (OnnxLoader parity)."""
        from ..onnx import load_onnx
        return load_onnx(path)

    @staticmethod
    def load_caffe(def_path: str, model_path: str):
        """Caffe prototxt + caffemodel -> zoo Keras Model (parity:
        ``CaffeLoader.scala:718`` + LayerConverter/V1LayerConverter)."""
        from ..caffe import load_caffe
        return load_caffe(def_path, model_path)

    # camelCase aliases (scala-side naming)
    loadTF = load_tf
    loadTorch = load_torch
    loadCaffe = load_caffe
    loadKeras = load_keras
