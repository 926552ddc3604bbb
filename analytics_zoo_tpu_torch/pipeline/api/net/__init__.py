"""Interop nets; counterpart of ``analytics_zoo_tpu/pipeline/api/net``.

Foreign-runtime models -- TF graphs, PyTorch modules, ONNX files, Caffe
nets -- imported into the port, each translated to torch where it can be.
"""

from .net_load import Net
from .tf_graph import TFGraphFunction, UnsupportedTFGraph
from .tfnet import TFNet
from .torch_fx import TorchFxConverter, UnsupportedTorchGraph
from .torchnet import TorchCriterion, TorchNet

__all__ = ["Net", "TFNet", "TorchNet", "TorchCriterion",
           "TFGraphFunction", "TorchFxConverter",
           "UnsupportedTFGraph", "UnsupportedTorchGraph"]
