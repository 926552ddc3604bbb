"""Caffe import; counterpart of ``analytics_zoo_tpu/pipeline/api/caffe``."""

from .loader import CaffeLoader, load_caffe

__all__ = ["CaffeLoader", "load_caffe"]
