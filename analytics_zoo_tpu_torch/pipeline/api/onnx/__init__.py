"""ONNX import (reference: ``pyzoo/zoo/pipeline/api/onnx``); counterpart
of ``analytics_zoo_tpu/pipeline/api/onnx``."""

from .onnx_loader import GraphModule, OnnxIR, OnnxLoader, load_onnx

__all__ = ["OnnxLoader", "OnnxIR", "GraphModule", "load_onnx"]
