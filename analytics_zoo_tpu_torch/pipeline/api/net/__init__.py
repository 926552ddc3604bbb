"""Interop nets; counterpart of ``analytics_zoo_tpu/pipeline/api/net``.

PyTorch modules, ONNX files and Caffe nets imported into the port. TFNet
and the TF graph reader (``TFNet``, ``TFGraphFunction``,
``UnsupportedTFGraph``) are not ported yet (ROADMAP A14.8).
"""

from .net_load import Net
from .torch_fx import TorchFxConverter, UnsupportedTorchGraph
from .torchnet import TorchCriterion, TorchNet

__all__ = ["Net", "TorchNet", "TorchCriterion", "TorchFxConverter",
           "UnsupportedTorchGraph"]
