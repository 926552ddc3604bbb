"""Parameter sharding rules, and where each parameter lies over the ranks.

Counterpart of ``analytics_zoo_tpu/parallel/sharding.py``. Layers
annotate their parameters with *logical axes* (``KerasLayer._annotate``:
a Dense kernel ('in', 'out'), an Embedding table ('vocab', 'embed'), the
transformer's qkv ('embed', 'heads'), ...) and the rules map logical axes
to mesh axes. :func:`make_param_sharding_fn` gives, for each parameter, a
plain spec: one mesh-axis name or None per dimension, what the JAX
function's ``PartitionSpec`` holds. JAX's two traps are kept exactly:

* a dimension that does not divide its mesh axis falls back to
  replication, with a warning from 16,384 elements on;
* one mesh axis shards only one dimension of a parameter (the FSDP rules
  map several logical axes to ``data``): the largest divisible one.

JAX hands the specs to GSPMD, which inserts the collectives. Here each
rank keeps only its block of a sharded parameter (:class:`LeafShard`,
installed on the model by :func:`install_layout`): the parameter's
``data`` is the block, and the layout rides on the parameter as
``_zoo_shard``. A layer computes on blocks where its
``sharded_compute`` says it does (TransformerLayer's heads and MLP over
``model``, its stacked blocks over ``pipe``, SparseMoE's experts over
``expert``); every other sharded dimension reaches the layer whole,
all-gathered at use by :func:`gather_param`, whose backward is a
reduce-scatter, so the gradient and the optimizer state stay sharded.
That gives the FSDP rules and a vocabulary-sharded table what GSPMD gives
them, with no per-layer code.

A dimension made of equal parts computed apart (the fused QKV kernel's
q, k and v columns, ``KerasLayer.param_pieces``) is cut part by part: a
rank's block is its share of each part, so its columns are whole heads
of q, k and v. Such a block is several regions of the whole leaf
(:meth:`LeafShard.regions`), which is what the sharded checkpoint writes.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .collectives import _all_gather, _reduce_scatter, group_size
from .mesh import AXES

logger = logging.getLogger("analytics_zoo_tpu_torch.parallel")

# Default logical-axis -> mesh-axis mapping (Megatron-style TP):
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "heads": "model",     # qkv column-parallel
    "mlp": "model",       # mlp-in column-parallel / mlp-out row-parallel
    "vocab": "model",     # embedding vocab-sharded
    "embed": None,        # hidden dim replicated
    "in": None,
    "out": None,
    "kv": None,
    "expert": "expert",   # stacked expert weights over the EP axis
    "stage": "pipe",      # stacked pipeline-stage weights over the PP axis
}

# Fully-sharded variant (ZeRO-3 style): weights, and with them their
# optimizer moments, spread over the data axis; 'embed' covers the
# transformer's hidden dims, 'in'/'out' plain Dense kernels
FSDP_RULES = dict(DEFAULT_RULES, embed="data", out="data")
FSDP_RULES["in"] = "data"   # ("in" is a keyword; no kwarg spelling)

Spec = Tuple[Optional[str], ...]


def _spec_entries(spec) -> tuple:
    """A spec as a tuple: a tuple/list as it is, a PartitionSpec-like
    object through its ``spec``, None as ()."""
    if spec is None:
        return ()
    spec = getattr(spec, "spec", spec)
    return tuple(spec)


def make_param_sharding_fn(graph, mesh, rules: Optional[Dict] = None):
    """A ``params -> tree of specs`` function for a graph whose layers
    carry axis annotations: ``params`` is ``{layer name: nested dict of
    tensors or shapes}`` (``KerasNet.param_tree()``), the result the same
    tree with one spec (a tuple of mesh-axis names or None, one entry per
    dimension) a leaf."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    annotations: Dict[str, Dict[str, tuple]] = {
        layer.name: layer.param_axes() for layer in graph.layers}

    def spec_for(layer_name, path, shape) -> Spec:
        axes = annotations.get(layer_name, {})
        key = "/".join(path)
        logical = axes.get(key)
        if logical is None:
            return (None,) * len(shape)
        mesh_axes: List[Optional[str]] = []
        for i, ax in enumerate(logical):
            mapped = rules.get(ax) if ax is not None else None
            if mapped not in mesh.axis_names:
                mapped = None
            # a dim can only be sharded if divisible by the axis size:
            # small leaves (biases, tiny heads) replicate; from 16K
            # elements on the fallback defeats the layout's purpose, so
            # it warns
            if mapped is not None and (
                    i >= len(shape) or
                    shape[i] % mesh.shape[mapped] != 0):
                if math.prod(shape) >= 16_384:
                    logger.warning(
                        "param %s/%s dim %d (size %s) is not divisible "
                        "by mesh axis %r (%d) — REPLICATING a large "
                        "tensor; pad the dim or change the layout",
                        layer_name, key, i,
                        shape[i] if i < len(shape) else "?",
                        mapped, mesh.shape[mapped])
                mapped = None
            mesh_axes.append(mapped)
        # one mesh axis may shard only ONE dim (fsdp maps several logical
        # axes to 'data'): keep it on the largest divisible dim
        seen: Dict[str, int] = {}
        for i, mapped in enumerate(mesh_axes):
            if mapped is None:
                continue
            j = seen.get(mapped)
            if j is None:
                seen[mapped] = i
            elif shape[i] > shape[j]:
                mesh_axes[j] = None
                seen[mapped] = i
            else:
                mesh_axes[i] = None
        mesh_axes += [None] * (len(shape) - len(mesh_axes))
        return tuple(mesh_axes)

    def sharding_fn(params):
        def walk(subtree, layer_name, path):
            if isinstance(subtree, dict):
                return {k: walk(v, layer_name, path + [k])
                        for k, v in subtree.items()}
            shape = tuple(getattr(subtree, "shape", subtree))
            return spec_for(layer_name, path, tuple(int(d) for d in shape))

        return {layer_name: walk(sub, layer_name, [])
                for layer_name, sub in params.items()}

    return sharding_fn


def spec_is_replicated(spec) -> bool:
    """True when a spec places the array on no mesh axis at all (fully
    replicated). A missing/None spec counts as replicated; nested tuple
    entries (axis groups) count as sharded. ZeRO-1 uses this to pick the
    trainer's mode (``parallel.zero``)."""
    for entry in _spec_entries(spec):
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            if any(a is not None for a in entry):
                return False
        else:
            return False
    return True


def spec_mentions(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, (tuple, list)) and axis in e)
               for e in _spec_entries(spec))


class LeafShard:
    """Where one parameter of ``full_shape`` lies over the rank ``mesh``
    under ``spec``: this rank's block of it, its regions of the whole
    leaf, and the collectives that rebuild the whole. ``pieces`` is
    ``(dim, count)`` for a dimension of ``count`` parts cut part by part.
    Axes of size 1 shard nothing."""

    def __init__(self, full_shape, spec, mesh,
                 pieces: Optional[Tuple[int, int]] = None):
        self.full_shape = tuple(int(d) for d in full_shape)
        entries = list(_spec_entries(spec))
        entries += [None] * (len(self.full_shape) - len(entries))
        self.spec: Spec = tuple(entries)
        self.mesh = mesh
        #: (dim, axis, ranks on the axis, this rank's coordinate) of each
        #: dimension laid out over an axis longer than one
        self.dims: List[Tuple[int, str, int, int]] = []
        for d, axis in enumerate(self.spec):
            if axis is None or isinstance(axis, (tuple, list)):
                if axis:
                    raise ValueError(f"axis groups are not supported: "
                                     f"{self.spec}")
                continue
            n = int(mesh.shape[axis])
            if n > 1:
                self.dims.append((d, axis, n, mesh.index(axis)))
        self.pieces = {}
        if pieces is not None:
            dim, count = pieces
            self.pieces[int(dim)] = int(count)
        for d, axis, n, _ in self.dims:
            p = self.pieces.get(d, 1)
            if self.full_shape[d] % (n * p):
                raise ValueError(
                    f"dimension {d} of {self.full_shape} ({p} part(s)) "
                    f"does not split over {axis}'s {n} ranks part by part")

    @property
    def sharded(self) -> bool:
        return bool(self.dims)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is cut over."""
        return tuple(axis for _, axis, _, _ in self.dims)

    def _intervals(self, d: int, n: int, c: int) -> List[Tuple[int, int]]:
        """This rank's intervals of dimension ``d`` (one a part)."""
        p = self.pieces.get(d, 1)
        part = self.full_shape[d] // p
        size = part // n
        return [(j * part + c * size, j * part + (c + 1) * size)
                for j in range(p)]

    def block_of(self, full):
        """This rank's block of the whole leaf ``full`` (a tensor or a
        numpy array), a copy."""
        out = full
        for d, _, n, c in self.dims:
            ivs = self._intervals(d, n, c)
            if isinstance(out, np.ndarray):
                out = np.concatenate([out.take(range(a, b), axis=d)
                                      for a, b in ivs], axis=d)
            else:
                out = torch.cat([out.narrow(d, a, b - a) for a, b in ivs],
                                dim=d)
        return out.copy() if isinstance(out, np.ndarray) else out.clone()

    def regions(self) -> List[Tuple[List[Tuple[int, int]],
                                    Tuple[slice, ...]]]:
        """This rank's (region of the whole leaf, slices of the block)
        pairs: one region unless a cut dimension has parts."""
        per_dim = []
        for d, size in enumerate(self.full_shape):
            cut = [(dd, n, c) for dd, _, n, c in self.dims if dd == d]
            if not cut:
                per_dim.append([((0, size), slice(0, size))])
                continue
            _, n, c = cut[0]
            ivs = self._intervals(d, n, c)
            w = ivs[0][1] - ivs[0][0]
            per_dim.append([(iv, slice(j * w, (j + 1) * w))
                            for j, iv in enumerate(ivs)])
        out = []
        for combo in _product(per_dim):
            out.append(([iv for iv, _ in combo],
                        tuple(sl for _, sl in combo)))
        return out

    def replica_axes(self) -> Tuple[str, ...]:
        """The mesh axes whose ranks hold the same block (the first of
        them writes it to a checkpoint, JAX's ``replica_id == 0``)."""
        cut = set(self.axes)
        return tuple(a for a in AXES if a not in cut and
                     int(self.mesh.shape[a]) > 1)

    def gather(self, block: torch.Tensor, skip=()) -> torch.Tensor:
        """The whole leaf from every rank's block (all-gathers over the
        cut axes; differentiable, :func:`gather_param`), leaving the
        dimensions cut over an axis in ``skip`` as blocks."""
        out = block
        for d, axis, n, _ in self.dims:
            if axis in skip:
                continue
            out = gather_param(out, self.mesh.group(axis), d,
                               self.pieces.get(d, 1),
                               1.0 if axis == "data" else 1.0 / n)
        return out

    def __eq__(self, other):
        return isinstance(other, LeafShard) and \
            (self.full_shape, self.spec, self.pieces) == \
            (other.full_shape, other.spec, other.pieces)

    def __repr__(self):
        return (f"LeafShard({self.full_shape}, {self.spec}"
                f"{', pieces=' + str(self.pieces) if self.pieces else ''})")


def _product(lists):
    out = [[]]
    for options in lists:
        out = [prev + [o] for prev in out for o in options]
    return out


class _GatherParam(torch.autograd.Function):
    """All-gather of a parameter's blocks along ``dim``; the backward
    reduce-scatters the gradient and scales it: 1 over ``data`` (the
    ranks' gradients are parts of the batch's), 1/n over an axis whose
    ranks computed the same loss from the same rows (their gradients are
    copies)."""

    @staticmethod
    def forward(ctx, x, group, dim, scale):
        ctx.group, ctx.dim, ctx.scale = group, dim, scale
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g.contiguous(), ctx.group, ctx.dim)
        if ctx.scale != 1.0:
            out = out * ctx.scale
        return out, None, None, None


def gather_param(x: torch.Tensor, group, dim: int, pieces: int = 1,
                 scale: float = 1.0) -> torch.Tensor:
    """The whole of a parameter cut along ``dim`` over ``group`` from
    this rank's block ``x`` (a block of ``pieces`` parts is reordered part
    by part); the backward reduce-scatters the gradient, times
    ``scale``."""
    n = group_size(group)
    if n == 1:
        return x
    out = _GatherParam.apply(x, group, dim, scale)
    if pieces > 1:
        w = x.shape[dim] // pieces
        # [rank 0's parts | rank 1's parts | ...] -> [part 0 of every
        # rank | part 1 of every rank | ...]
        out = out.unflatten(dim, (n, pieces, w)).transpose(dim, dim + 1) \
            .flatten(dim, dim + 2)
    return out


def shard_params(params, sharding_fn, mesh=None):
    """This rank's block of every leaf of ``params`` (``{layer: nested
    dict of tensors}``) under ``sharding_fn``'s specs, on the rank mesh
    (the context's by default)."""
    if mesh is None:
        from ..common.nncontext import get_nncontext
        mesh = get_nncontext().mesh
    specs = sharding_fn(params)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return LeafShard(tree.shape, spec, mesh).block_of(tree)

    return walk(params, specs)


# ---------------------------------------------------------------------------
# a model's layout
# ---------------------------------------------------------------------------

def model_specs(model, fn) -> Dict[str, Spec]:
    """{parameter path: spec} of ``model`` (``named_parameters()`` keys)
    under the sharding function ``fn`` (``params -> {layer: tree of
    specs}``; PartitionSpec-like leaves are read through ``spec``)."""
    shapes = {}
    for layer in model.graph_function().layers:
        tree = {}
        for path, p in layer.named_parameters():
            node = tree
            *parents, leaf = path.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = full_shape(p)
        if tree:
            shapes[layer.name] = tree
    specs = fn(shapes)
    out: Dict[str, Spec] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = tuple(_spec_entries(v))

    walk(specs, "")
    return out


def full_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The whole leaf's shape of a parameter (its own where unsharded)."""
    shard = getattr(p, "_zoo_shard", None)
    return shard.full_shape if shard is not None else tuple(p.shape)


def leaf_shard(p: torch.Tensor) -> Optional[LeafShard]:
    return getattr(p, "_zoo_shard", None)


def _layer_of(model, path: str):
    name = path.split(".", 1)[0]
    return getattr(model, name, None)


def gathered_dims(model, path: str, shard: LeafShard) -> Tuple[str, ...]:
    """The mesh axes of ``shard`` that the owning layer computes on as
    blocks (its ``sharded_compute`` of the dimension's logical axis)."""
    layer = _layer_of(model, path)
    if layer is None:
        return ()
    logical = layer.param_axes().get(path.split(".", 1)[1].replace(".", "/"))
    if logical is None:
        return ()
    kept = []
    for d, axis, _, _ in shard.dims:
        name = logical[d] if d < len(logical) else None
        if name is not None and layer.sharded_compute.get(name) == axis:
            kept.append(axis)
    return tuple(kept)


def install_layout(model, specs: Dict[str, Spec], mesh) -> Dict[str,
                                                                 LeafShard]:
    """Cut every parameter of ``model`` that ``specs`` lays out over an
    axis longer than one into this rank's block, in place (the
    parameter's ``data`` becomes the block; its layout rides on it as
    ``_zoo_shard``, and ``_zoo_keep`` holds the axes its layer computes on
    as blocks). Returns {path: LeafShard} of the cut parameters. A model
    already cut under the same layout is left as it is."""
    out: Dict[str, LeafShard] = {}
    pieces_of = {}
    for layer in model.graph_function().layers:
        for key, pc in layer.param_pieces().items():
            pieces_of[f"{layer.name}.{key.replace('/', '.')}"] = pc
    with torch.no_grad():
        for path, p in model.named_parameters():
            shard = LeafShard(full_shape(p), specs.get(path, ()), mesh,
                              pieces_of.get(path))
            have = leaf_shard(p)
            if have is not None:
                if have != shard:
                    raise ValueError(f"{path} is already laid out as {have}; "
                                     f"cannot lay it out as {shard}")
                out[path] = have
                continue
            if not shard.sharded:
                continue
            p.data = shard.block_of(p.data).contiguous()
            p._zoo_shard = shard
            p._zoo_keep = gathered_dims(model, path, shard)
            out[path] = shard
    return out


def use_param(p: torch.Tensor) -> torch.Tensor:
    """A parameter as its layer computes on it: its block where the
    layer computes on blocks, all-gathered over every other cut axis."""
    shard = leaf_shard(p)
    if shard is None:
        return p
    return shard.gather(p, skip=getattr(p, "_zoo_keep", ()))


def full_param(p: torch.Tensor) -> torch.Tensor:
    """The whole leaf of a parameter (a collective where it is cut: every
    rank of its axes calls it), without autograd."""
    shard = leaf_shard(p)
    if shard is None:
        return p.detach()
    with torch.no_grad():
        return shard.gather(p.detach())


def load_whole(p: torch.Tensor, whole) -> None:
    """Copy the whole leaf ``whole`` (array or tensor) into the parameter
    ``p``: its block where it is cut."""
    shard = leaf_shard(p)
    src = torch.as_tensor(np.array(whole)) if not isinstance(
        whole, torch.Tensor) else whole
    if tuple(src.shape) != full_shape(p):
        raise ValueError(f"shape {tuple(src.shape)} does not match "
                         f"{full_shape(p)}")
    if shard is not None:
        src = shard.block_of(src)
    with torch.no_grad():
        p.copy_(src.to(device=p.device, dtype=p.dtype))


__all__ = ["DEFAULT_RULES", "FSDP_RULES", "LeafShard", "full_param",
           "full_shape", "gather_param", "install_layout", "leaf_shard",
           "load_whole", "make_param_sharding_fn", "model_specs",
           "shard_params", "spec_is_replicated", "spec_mentions",
           "use_param"]
