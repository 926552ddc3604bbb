"""Minimal ONNX model builder (mirror of onnx.helper.make_*), a copy of
``analytics_zoo_tpu/pipeline/api/onnx/builder.py``.

Tests and ``chip_smoke.py`` write real ``.onnx`` files with it, without
the onnx package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import proto


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs) -> Dict[str, Any]:
    return {"op_type": op_type, "input": list(inputs),
            "output": list(outputs), "name": name or outputs[0],
            "attribute": [proto.make_attr(k, v) for k, v in attrs.items()
                          if v is not None]}


def make_graph(nodes: List[dict], name: str,
               inputs: List[dict], outputs: List[dict],
               initializers: Optional[Dict[str, np.ndarray]] = None) -> dict:
    return {
        "name": name,
        "node": nodes,
        "input": list(inputs),
        "output": list(outputs),
        "initializer": [proto.numpy_to_tensor(arr, n)
                        for n, arr in (initializers or {}).items()],
    }


def make_model(graph: dict, opset: int = 13) -> bytes:
    return proto.encode({
        "ir_version": 8,
        "producer_name": "analytics-zoo-tpu",
        "opset_import": [{"domain": "", "version": opset}],
        "graph": graph,
    })


def value_info(name: str, shape, dtype=np.float32) -> dict:
    return proto.make_value_info(
        name, shape, proto.DTYPE_CODES[np.dtype(dtype)])


def save_model(model_bytes: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model_bytes)
