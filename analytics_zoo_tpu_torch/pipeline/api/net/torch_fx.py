"""torch.fx conversion: kept names, nothing to translate.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/torch_fx.py``. The
JAX package traces a module with ``torch.fx`` and maps every call onto
``jax.numpy``/``lax``, because the TPU cannot run torch. The port runs
torch on the card, so a module needs no translation: :class:`TorchNet`
calls it as it is. :class:`TorchFxConverter` keeps the public name and
``convert()``'s contract -- ``(fn, params)`` with ``fn(params, *xs)``
the module's forward and ``params`` its parameters and buffers under
JAX's keys (``name.replace(".", "_")``) -- by wrapping the module with
``torch.func.functional_call``. Unlike the JAX converter it refuses no
module; :class:`UnsupportedTorchGraph` is kept for callers that catch it
(ROADMAP C logs this as a kept difference).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


class UnsupportedTorchGraph(Exception):
    pass


class TorchFxConverter:
    """``TorchFxConverter(module).convert() -> (fn, params)``."""

    def __init__(self, module):
        self.module = module

    def convert(self) -> Tuple[Callable, Dict[str, Any]]:
        names = {}
        params: Dict[str, Any] = {}
        for name, t in list(self.module.named_parameters()) + \
                list(self.module.named_buffers()):
            key = name.replace(".", "_")
            names[key] = name
            params[key] = t.detach()
        module = self.module

        def run(P, *args):
            return torch.func.functional_call(
                module, {names[k]: v for k, v in P.items()}, args)

        return run, params
