"""Count the aten ops a region of eager PyTorch dispatches.

The port's counterpart of the JAX package's jaxpr probes of the int8
path (``bench.py``'s count of ``preferred_element_type=int32`` products,
int8 converts and divisions in the lowered program): a
``TorchDispatchMode`` sees every op a forward runs, with its output's
dtype, on the CPU and on the card alike.

    with OpCensus() as census:
        model.predict(x)
    census.int8_summary()
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ops that multiply two matrices (after or before decomposition)
_PRODUCTS = ("aten._int_mm", "aten.mm", "aten.matmul", "aten.bmm",
             "aten.addmm")


def _op_name(func) -> str:
    """``aten.mm.default`` -> ``aten.mm``."""
    name = str(func)
    return name.rsplit(".", 1)[0] if name.count(".") > 1 else name


class OpCensus(TorchDispatchMode):
    """Counts ``(op, dtype of the first output)`` pairs dispatched inside
    the context, on this thread."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (list, tuple)) and out else out
        dtype = first.dtype if isinstance(first, torch.Tensor) else None
        self.counts[(_op_name(func), dtype)] += 1
        return out

    def count(self, op: str, dtype=None) -> int:
        """Launches of ``op`` (``"aten.div"``), of any output dtype or of
        ``dtype``."""
        return sum(n for (name, dt), n in self.counts.items()
                   if name == op and (dtype is None or dt == dtype))

    def int8_summary(self) -> dict:
        """The int8 path's structure: int32-accumulating products, float
        products, roundings (the entry quantize and each requantize),
        divisions, softmaxes."""
        return dict(
            int32_products=sum(self.count(op, torch.int32)
                               for op in _PRODUCTS),
            float_products=sum(n for (name, dt), n in self.counts.items()
                               if name in _PRODUCTS and dt is not None
                               and dt.is_floating_point),
            roundings=self.count("aten.round"),
            divisions=self.count("aten.div"),
            softmaxes=self.count("aten._softmax") + self.count("aten.softmax"),
        )
