"""Copy a JAX model's weights into the port.

No JAX counterpart. The JAX package keeps a model's parameters as a pytree
``{layer_name: {...}}`` (``GraphFunction.init``); the port keeps the same
names and layouts on its modules. :func:`load_jax_params` takes that
pytree as nested dicts of numpy arrays — convert with ``np.asarray``
first; this module imports no JAX — and copies it into a port model, or
into one layer built on its own; with ``state=``, the JAX ``net_state``
(BatchNorm's moving statistics) comes along into the layers' buffers. :func:`load_jax_decode_state` carries a
JAX KV-cache ``DecodeState`` into the port's, so both sides can start
from the same mid-stream cache.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.kv_cache import DecodeState, Int8KVSlab


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _auto_parts(name: str) -> Optional[Tuple[str, int]]:
    """(class, number) of an auto-generated layer name ("dense_3" ->
    ("dense", 3)), or None for a user-given name."""
    m = re.fullmatch(r"([a-z0-9]+)_(\d+)", name)
    return (m.group(1), int(m.group(2))) if m else None


def _pair_layers(port_layers, names) -> list:
    """(port layer, JAX entry name) pairs: user-named layers by name,
    auto-named ones by class and creation order (see
    :func:`load_jax_params`). Raises on layers left unpaired."""
    pairs = []
    port_auto: Dict[str, list] = {}   # class -> [(number, layer)]
    for layer in port_layers:
        cls = type(layer).__name__.lower()
        parts = _auto_parts(layer.name)
        if parts is not None and parts[0] == cls:
            port_auto.setdefault(cls, []).append((parts[1], layer))
        elif layer.name in names:
            pairs.append((layer, layer.name))
        else:
            raise ValueError(f"cannot pair layers: port {layer.name} has "
                             f"no JAX entry of that name")
    taken = {name for _, name in pairs}
    jax_auto: Dict[str, list] = {}    # class -> [(number, name)]
    for name in names:
        if name in taken:
            continue
        parts = _auto_parts(name)
        if parts is None:
            raise ValueError(f"cannot pair layers: JAX {name} has no port "
                             f"layer of that name")
        jax_auto.setdefault(parts[0], []).append((parts[1], name))
    counts = lambda groups: {c: len(v) for c, v in groups.items()}
    if counts(port_auto) != counts(jax_auto):
        raise ValueError(
            f"cannot pair layers: port {counts(port_auto)} vs JAX "
            f"{counts(jax_auto)} auto-named layers by class")
    for cls, port in port_auto.items():
        for (_, layer), (_, name) in zip(sorted(port, key=lambda t: t[0]),
                                         sorted(jax_auto[cls])):
            pairs.append((layer, name))
    return pairs


def _copy_leaves(layer, name, src_tree, dst, what) -> None:
    src = _flatten(src_tree)
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise ValueError(f"{layer.name} <- {name}: {what} missing "
                         f"{missing}, extra {extra}")
    for path, t in dst.items():
        arr = np.asarray(src[path])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"{layer.name}.{path} <- {name}.{path}: shape "
                f"{tuple(arr.shape)} vs {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))


def load_jax_params(model, params: Mapping[str, Mapping[str, Any]],
                    state: Optional[Mapping[str, Mapping[str, Any]]] = None
                    ) -> None:
    """Copy the JAX params pytree ``params`` into the port ``model`` (a
    graph model, or a single layer: then ``params`` holds one entry, the
    layer's pytree, as ``{layer.name: layer_params}``), and with
    ``state`` the JAX ``net_state`` (``{layer: {"moving_mean",
    "moving_var"}}``) into the layers' state buffers.

    A port layer with a user-given name (any name but its class's
    auto-name pattern) takes the JAX entry of that name. Auto-named
    layers ("dense_3", "embedding_12": the class, then a per-class
    counter in creation order) pair by class and creation order: the
    port's k-th auto-named Dense of the model takes the JAX entry with
    the k-th smallest "dense_N". The two packages number their layers
    with separate counters, and JAX hands its params back with the keys
    sorted, so neither the numbers nor the order of ``params`` matter;
    building the model with the same code on both sides is what lines
    the layers up. The state pairs the same way, over the layers that
    have state. Raises on a missing, extra or mis-shaped leaf, and on
    layers left unpaired.
    """
    layers = (model.graph_function().layers
              if hasattr(model, "graph_function") else [model])
    with_params = [l for l in layers if any(True for _ in l.parameters())]
    for layer, name in _pair_layers(with_params, params):
        _copy_leaves(layer, name, params[name],
                     dict(layer.named_parameters()), "params")
    if state is None:
        return
    with_state = [l for l in layers if any(True for _ in l.buffers())]
    for layer, name in _pair_layers(with_state, state):
        _copy_leaves(layer, name, state[name], dict(layer.named_buffers()),
                     "state")


def load_jax_decode_state(state, device=None, rng=None) -> DecodeState:
    """The port's ``DecodeState`` holding a copy of a JAX ``DecodeState``.

    ``state`` has the JAX fields ``k_cache``, ``v_cache`` (one slab per
    layer: an array, or an int8 slab with ``q`` and ``scale``) and
    ``lengths``; anything ``np.asarray`` reads will do (JAX arrays or
    numpy). Every slab is copied, so K and V come apart even where the
    JAX state aliases them. The JAX sampling key does not carry over;
    ``rng`` (a ``torch.Generator`` or None) takes its place."""
    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    def slab(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return Int8KVSlab(tensor(x.q), tensor(x.scale))
        return tensor(x)

    return DecodeState(k_cache=tuple(slab(x) for x in state.k_cache),
                       v_cache=tuple(slab(x) for x in state.v_cache),
                       lengths=tensor(state.lengths).to(torch.int32),
                       rng=rng)
