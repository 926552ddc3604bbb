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

The other direction is what the files hold. A model's ``param_tree()``
and ``state_tree()`` are already the JAX-shaped trees (``{layer name:
{...}}``) that ``model.npz`` and ``weights.npz`` store;
:func:`optimizer_leaves` gives the optimizer state as the leaf list of
``optim.npz``, in the order optax's ``tree_leaves`` gives the same
optimizer: each transform of the chain in turn; within one, its fields
in optax's order (``count``, ``mu``, ``nu``; ``e_g``, ``e_x``), a count
as a 0-d int32 array, and each per-parameter tree by parameter path
sorted level by level (:func:`param_order`). Reading one back,
:func:`param_order` sorts by the file's paths: a file written by another
model instance (or by the JAX package, with its own layer numbering)
pairs its layers with the model's as :func:`load_jax_params` does, and
:func:`load_optimizer_leaves` copies the leaves into the live state. The
checkpoint store and ``save_model`` both go through these.

A layer that names its tensors otherwise than the JAX layer does (an
ONNX ``GraphModule``, whose initializer names lose their "."; a
``TorchNet``, whose JAX fx lowering names a module's tensors ``0_w``,
``1_rm``) has a ``load_jax_params(tree)`` method that maps its JAX
tree, and :func:`load_jax_params` hands it the layer's entry.

A layer's tree may nest deeper than one level: a wrapper's role keys
(``bidirectional_1.forward.W``, ``timedistributed_1.layer.kernel``), a
Seq2seq coder's ``l{i}`` groups and ``embedding``, a MoE transformer
block's ``block{i}.moe.w_in`` (nested ``ParameterDict``s), a custom
transformer embedding's ``embedding.table`` and a tfpark text net's
sub-layers (``_nernet_1.sub2_bidirectional.forward.W``,
``sub6_crf.trans``; the net's private class auto-names with a leading
underscore and pairs like any auto-named layer) are submodule paths, so
they flatten, pair and sort as the JAX trees do; a frozen
``WordEmbedding`` table stays a parameter (it takes a zero gradient), so
it keeps its place among optax's leaves.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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
    ("dense", 3); a private class's "_nernet_2" -> ("_nernet", 2)), or
    None for a user-given name."""
    m = re.fullmatch(r"(_?[a-z0-9]+)_(\d+)", name)
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


def _restack(src_tree, dst):
    """A transformer's blocks in the other layout than ``dst`` holds
    (``model_io`` reads either): per-block ``block{i}.*`` leaves stacked
    into ``blocks.*`` (the GPipe layout, ``self_attention.py``), or
    ``blocks.*`` unstacked into ``block{i}.*``."""
    src = _flatten(src_tree)
    stacked = any(k.startswith("blocks.") for k in dst)
    if stacked and not any(k.startswith("blocks.") for k in src):
        per = {}
        for k, v in src.items():
            m = re.fullmatch(r"block(\d+)\.(.+)", k)
            if m:
                per.setdefault(m.group(2), {})[int(m.group(1))] = v
        if per:
            for sub, byi in per.items():
                src[f"blocks.{sub}"] = np.stack(
                    [np.asarray(byi[i]) for i in sorted(byi)])
            src = {k: v for k, v in src.items()
                   if not re.fullmatch(r"block\d+\..+", k)}
    elif not stacked and any(k.startswith("blocks.") for k in src):
        for k in [k for k in src if k.startswith("blocks.")]:
            arr = np.asarray(src.pop(k))
            for i in range(arr.shape[0]):
                src[f"block{i}.{k[len('blocks.'):]}"] = arr[i]
    return src


def _copy_leaves(layer, name, src_tree, dst, what) -> None:
    # (imported here: parallel/ imports ops/, which imports this module)
    from ..parallel.sharding import full_shape, load_whole

    src = _restack(src_tree, dst)
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise ValueError(f"{layer.name} <- {name}: {what} missing "
                         f"{missing}, extra {extra}")
    for path, t in dst.items():
        arr = np.asarray(src[path])
        want = full_shape(t)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{layer.name}.{path} <- {name}.{path}: shape "
                f"{tuple(arr.shape)} vs {want}")
        # a parameter laid out over the ranks takes its block
        load_whole(t, arr)


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
        if hasattr(layer, "load_jax_params"):
            # a layer that names its tensors otherwise than JAX does (an
            # imported graph's, a TorchNet's) maps the JAX tree itself
            layer.load_jax_params(params[name])
            continue
        _copy_leaves(layer, name, params[name],
                     dict(layer.named_parameters()), "params")
    if state is None:
        return
    with_state = [l for l in layers if any(True for _ in l.buffers())]
    for layer, name in _pair_layers(with_state, state):
        _copy_leaves(layer, name, state[name], dict(layer.named_buffers()),
                     "state")


def _graph_layers(model):
    return (model.graph_function().layers
            if hasattr(model, "graph_function") else [model])


def param_order(model, names: Optional[Sequence[str]] = None) -> List[str]:
    """The model's parameter paths (``named_parameters()`` keys, the
    trainer's and optimizer's keys) in the order a file's per-parameter
    leaves are stored: sorted by path level by level, where a path's
    layer name is the file's. ``names`` are the file's layer names (the
    keys of its params tree); None takes the model's own. They pair with
    the model's layers as in :func:`load_jax_params`."""
    layers = [l for l in _graph_layers(model)
              if any(True for _ in l.parameters())]
    if names is None:
        pairs = [(l, l.name) for l in layers]
    else:
        pairs = _pair_layers(layers, list(names))
    keys = []
    for layer, name in pairs:
        for path, _ in layer.named_parameters():
            port = path if layer is model else f"{layer.name}.{path}"
            keys.append((tuple([name] + path.split(".")), port))
    return [port for _, port in sorted(keys)]


def _opt_walk(state, order, param_set, visit, keyed=False):
    """Visit the optimizer state's leaves in optax's order: ``visit(leaf)``
    (``visit(leaf, path)`` with ``keyed``, the parameter path a leaf
    mirrors or None) returns the value that replaces it. Returns the
    rebuilt state."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return type(state)(_opt_walk(s, order, param_set, visit, keyed)
                           for s in state)
    if isinstance(state, dict):
        if state and all(k in param_set for k in state):
            out = dict(state)
            for k in order:
                if k in state:
                    out[k] = visit(state[k], k) if keyed else \
                        visit(state[k])
            return out
        return {k: _opt_walk(v, order, param_set, visit, keyed)
                for k, v in state.items()}
    return visit(state, None) if keyed else visit(state)


def optimizer_leaf_params(opt_state, order: Sequence[str]
                          ) -> List[Optional[str]]:
    """The parameter path each leaf of :func:`optimizer_leaves` mirrors
    (an Adam moment's), None for a leaf that mirrors none (a count)."""
    paths: List[Optional[str]] = []

    def visit(leaf, path):
        paths.append(path)
        return leaf

    _opt_walk(opt_state, list(order), set(order), visit, keyed=True)
    return paths


def optimizer_leaves(opt_state, order: Sequence[str]) -> List[Any]:
    """The leaves of a port optimizer state (``Transformation.init``'s
    structure) in optax's ``tree_leaves`` order for the same optimizer;
    ``order`` is :func:`param_order`'s. Tensors are returned as they are;
    a count becomes a 0-d int32 array, as optax keeps it."""
    leaves: List[Any] = []

    def visit(leaf):
        leaves.append(np.asarray(leaf, np.int32)
                      if isinstance(leaf, (int, np.integer)) else leaf)
        return leaf

    _opt_walk(opt_state, list(order), set(order), visit)
    return leaves


def check_optimizer_leaves(opt_state, leaves: Sequence[Any],
                           order: Sequence[str]) -> None:
    """Raise unless ``leaves`` match the optimizer state's leaves in
    number and shape."""
    live = optimizer_leaves(opt_state, order)
    if len(live) != len(leaves):
        raise ValueError(f"the file holds {len(leaves)} optimizer leaves, "
                         f"this optimizer has {len(live)}")
    for i, (have, got) in enumerate(zip(live, leaves)):
        if tuple(np.shape(got)) != tuple(have.shape):
            raise ValueError(f"optimizer leaf {i}: shape "
                             f"{tuple(np.shape(got))} vs {tuple(have.shape)}")


def load_optimizer_leaves(opt_state, leaves: Sequence[Any],
                          order: Sequence[str]):
    """``opt_state`` with each leaf taken from ``leaves`` (in the order of
    :func:`optimizer_leaves`): tensors are copied into in place, counts
    become Python ints. Returns the state; raises when the number of
    leaves or a shape disagrees, before any tensor is written."""
    check_optimizer_leaves(opt_state, leaves, order)
    it = iter(leaves)

    def visit(leaf):
        src = next(it)
        if isinstance(leaf, (int, np.integer)):
            return int(np.asarray(src))
        with torch.no_grad():
            leaf.copy_(torch.from_numpy(np.array(src)).to(leaf.dtype))
        return leaf

    return _opt_walk(opt_state, list(order), set(order), visit)


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
