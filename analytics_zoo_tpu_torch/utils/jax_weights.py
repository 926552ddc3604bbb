"""Copy a JAX model's weights into the port.

No JAX counterpart. The JAX package keeps a model's parameters as a pytree
``{layer_name: {...}}`` (``GraphFunction.init``); the port keeps the same
names and layouts on its modules. :func:`load_jax_params` takes that
pytree as nested dicts of numpy arrays — convert with ``np.asarray``
first; this module imports no JAX — and copies it into a port model.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _auto_class(name: str) -> Optional[str]:
    """The class a JAX auto-generated layer name encodes ("dense_3" ->
    "dense"), or None for a user-given name."""
    m = re.fullmatch(r"([a-z0-9]+)_\d+", name)
    return m.group(1) if m else None


def load_jax_params(model, params: Mapping[str, Mapping[str, Any]]
                    ) -> None:
    """Copy the JAX params pytree ``params`` into the port ``model``.

    Layers match by name first. Port layers left over then pair with the
    leftover JAX entries by topological position — ``params`` must keep
    the insertion order ``GraphFunction.init`` gives it — and an
    auto-generated JAX name must name the port layer's class ("bert_2"
    is a BERT). Raises on a missing, extra or mis-shaped leaf, and on
    layers left unpaired.
    """
    port_layers = [l for l in model.graph_function().layers
                   if any(True for _ in l.parameters())]
    jax_names = list(params)
    pairs = []
    unmatched_port = []
    for layer in port_layers:
        if layer.name in params:
            pairs.append((layer, layer.name))
        else:
            unmatched_port.append(layer)
    taken = {name for _, name in pairs}
    unmatched_jax = [n for n in jax_names if n not in taken]
    if len(unmatched_port) != len(unmatched_jax):
        raise ValueError(
            f"cannot pair layers: port {[l.name for l in unmatched_port]} "
            f"vs JAX {unmatched_jax}")
    for layer, name in zip(unmatched_port, unmatched_jax):
        cls = _auto_class(name)
        if cls is not None and cls != type(layer).__name__.lower():
            raise ValueError(
                f"layer order differs: port {layer.name} "
                f"({type(layer).__name__}) vs JAX {name} ({cls})")
        pairs.append((layer, name))

    for layer, name in pairs:
        src = _flatten(params[name])
        dst = dict(layer.named_parameters())
        missing = sorted(set(dst) - set(src))
        extra = sorted(set(src) - set(dst))
        if missing or extra:
            raise ValueError(f"{layer.name} <- {name}: missing {missing}, "
                             f"extra {extra}")
        for path, p in dst.items():
            arr = np.asarray(src[path])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{layer.name}.{path} <- {name}.{path}: shape "
                    f"{tuple(arr.shape)} vs {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
