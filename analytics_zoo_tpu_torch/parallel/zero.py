"""ZeRO stage-1 optimizer-state partitioning over the ``data`` axis.

Counterpart of ``analytics_zoo_tpu/parallel/zero.py``: its "flat" mode
(below) and, through :class:`DimLayout`, its "gspmd" mode. Following
Rajbhandari et al. ("ZeRO: Memory
Optimizations Toward Training Trillion Parameter Models"), stage 1 keeps
the parameters replicated but gives each of the ``dp`` data-parallel
ranks a 1/dp slice of the optimizer state:

* each parameter's gradient is flattened and zero-padded to
  :func:`padded_size`, and the gradients are **reduce-scattered** over
  ``data``: rank r receives block r of every padded leaf, summed over the
  ranks (the bytes of the all-reduce, in two phases);
* the optimizer update runs on the **local shards only** (1/dp of the
  Adam moments a rank);
* the updated shards are **all-gathered** back to full parameters.

:class:`FlatLayout` packs the leaves for that: row r of a (dp, S) buffer
holds block r of every padded leaf, one after the other, so one
``reduce_scatter`` and one ``all_gather`` of the buffer move every leaf
(the JAX step has one of each per leaf inside its program).

Beside a non-data axis, or with any parameter laid out over the mesh,
the trainer runs JAX's "gspmd" mode instead (JAX ``engine.py:395-478``):
the parameters keep their layout, and the moments of each leaf not laid
out over ``data`` are cut over ``data`` along the first dimension of the
leaf's spec that is unsharded and divides by dp (``_zero_widen_sharding``;
:func:`widen_dim`). :class:`DimLayout` packs those blocks: each such
gradient is reduce-scattered along that dimension, the update runs on
the block, and the updated blocks are all-gathered back into the
parameter.

The on-disk format is always the canonical (parameter-shaped) optimizer
state (:func:`unshard_opt_state`, :func:`shard_opt_state`): stage 0 and
stage 1, and any two dp degrees, restore each other's checkpoints.
:func:`assert_zero_collectives` holds a step to the collective contract,
read from ``collectives.CALLS``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .collectives import all_gather, group_rank


def padded_size(n: int, dp: int) -> int:
    """Smallest multiple of ``dp`` >= n (every rank gets an equal slice)."""
    return -(-int(n) // int(dp)) * int(dp)


class FlatLayout:
    """Where each parameter's block lies in a rank's flat shard.

    ``shapes`` maps each parameter path (in a fixed order) to its shape;
    leaf ``k`` of ``n`` elements is padded to ``padded_size(n, dp)`` and
    its block of ``padded_size(n, dp) // dp`` elements sits at
    ``offsets[k]`` of every rank's shard of length ``width``."""

    def __init__(self, shapes: Dict[str, torch.Size], dp: int):
        self.dp = int(dp)
        self.shapes = dict(shapes)
        self.numel = {k: int(torch.Size(s).numel()) for k, s in
                      self.shapes.items()}
        self.block = {k: padded_size(n, dp) // dp
                      for k, n in self.numel.items()}
        self.offsets: Dict[str, int] = {}
        off = 0
        for k in self.shapes:
            self.offsets[k] = off
            off += self.block[k]
        self.width = off

    def pack(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(dp, width) rows of every leaf's padded blocks, flattened: the
        operand of the reduce-scatter."""
        cols = []
        for k in self.shapes:
            t = tensors[k].reshape(-1)
            pad = self.block[k] * self.dp - t.numel()
            if pad:
                t = torch.cat([t, t.new_zeros(pad)])
            cols.append(t.reshape(self.dp, self.block[k]))
        return torch.cat(cols, dim=1).reshape(-1)

    def split(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A rank's flat shard (width,) as {path: its block} views."""
        return {k: shard.narrow(0, self.offsets[k], self.block[k])
                for k in self.shapes}

    def own_block(self, full: torch.Tensor, key: str, rank: int
                  ) -> torch.Tensor:
        """Block ``rank`` of a full, parameter-shaped leaf (a copy)."""
        t = full.reshape(-1)
        b = self.block[key]
        out = t.new_zeros(b)
        lo = rank * b
        hi = min(lo + b, t.numel())
        if hi > lo:
            out[:hi - lo] = t[lo:hi]
        return out

    def unpack(self, gathered: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The all-gathered (dp * width,) shards as full,
        parameter-shaped leaves."""
        rows = gathered.reshape(self.dp, self.width)
        return {k: rows[:, self.offsets[k]:self.offsets[k] + self.block[k]]
                .reshape(-1)[:self.numel[k]].reshape(self.shapes[k])
                for k in self.shapes}

    def gather(self, blocks: Dict[str, torch.Tensor], group
               ) -> Dict[str, torch.Tensor]:
        """Full leaves from every rank's blocks (one all-gather)."""
        shard = torch.cat([blocks[k].reshape(-1) for k in self.shapes])
        return self.unpack(all_gather(shard, group, dim=0))


def widen_dim(spec, shape, dp: int):
    """gspmd mode: the dimension of a leaf of ``shape`` laid out as
    ``spec`` (one entry a dimension) whose moments are cut over ``data``:
    the first unsharded one that ``dp`` divides; None for a leaf already
    laid out over ``data``, or without such a dimension (JAX's
    ``_zero_widen_sharding``)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(e == "data" or (isinstance(e, (tuple, list)) and "data" in e)
           for e in entries):
        return None
    for i, dim in enumerate(shape):
        if entries[i] is None and dim > 0 and dim % dp == 0:
            return i
    return None


class DimLayout:
    """gspmd mode's blocks: leaf ``k`` (of the local ``shapes[k]``) cut
    into ``dp`` equal blocks along ``dims[k]``. One reduce-scatter of
    :meth:`pack`'s buffer gives every rank its block of every leaf; one
    all-gather (:meth:`gather`) brings the blocks back."""

    def __init__(self, shapes: Dict[str, torch.Size], dims: Dict[str, int],
                 dp: int):
        self.dp = int(dp)
        self.dims = dict(dims)
        self.shapes = {k: tuple(shapes[k]) for k in self.dims}
        self.block: Dict[str, tuple] = {}
        self.offsets: Dict[str, int] = {}
        off = 0
        for k, d in self.dims.items():
            shape = list(self.shapes[k])
            shape[d] //= self.dp
            self.block[k] = tuple(shape)
            self.offsets[k] = off
            off += int(torch.Size(shape).numel())
        self.width = off

    def _moved(self, k):
        """A block's shape with its cut dimension first."""
        d, shape = self.dims[k], self.block[k]
        return (shape[d],) + shape[:d] + shape[d + 1:]

    def own(self, t: torch.Tensor, k: str, rank: int) -> torch.Tensor:
        """Block ``rank`` of leaf ``k`` (a view)."""
        d = self.dims[k]
        b = self.block[k][d]
        return t.narrow(d, rank * b, b)

    def pack(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(dp * width,): row r holds block r of every leaf."""
        cols = [tensors[k].movedim(self.dims[k], 0).reshape(self.dp, -1)
                for k in self.dims]
        return torch.cat(cols, dim=1).reshape(-1)

    def split(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A rank's (width,) buffer as {k: its block}."""
        out = {}
        for k, d in self.dims.items():
            n = int(torch.Size(self.block[k]).numel())
            out[k] = shard.narrow(0, self.offsets[k], n) \
                .view(self._moved(k)).movedim(0, d)
        return out

    def gather(self, blocks: Dict[str, torch.Tensor], group
               ) -> Dict[str, torch.Tensor]:
        """The leaves from every rank's blocks (one all-gather)."""
        shard = torch.cat([blocks[k].movedim(self.dims[k], 0).reshape(-1)
                           for k in self.dims])
        rows = all_gather(shard, group, dim=0).reshape(self.dp, self.width)
        out = {}
        for k, d in self.dims.items():
            n = int(torch.Size(self.block[k]).numel())
            moved = self._moved(k)
            full = rows[:, self.offsets[k]:self.offsets[k] + n].reshape(
                (self.dp * moved[0],) + moved[1:])
            out[k] = full.movedim(0, d)
        return out


def _is_param_dict(tree, layout: FlatLayout) -> bool:
    """A dict of tensors keyed by every parameter path (a moment)."""
    return isinstance(tree, dict) and set(tree) == set(layout.shapes) and \
        all(isinstance(v, torch.Tensor) for v in tree.values())


def _map_param_dicts(tree, fn):
    """``tree`` (an optimizer state: dicts, lists, counts) with every
    parameter-keyed dict of tensors replaced by ``fn(dict)``."""
    if isinstance(tree, dict):
        if tree and all(isinstance(v, torch.Tensor) for v in tree.values()):
            return fn(tree)
        return {k: _map_param_dicts(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_param_dicts(v, fn) for v in tree)
    return tree


def shard_opt_state(opt_state, layout: FlatLayout, group):
    """Canonical (parameter-shaped) -> this rank's flat blocks: every
    parameter-keyed dict of the state keeps block ``rank`` of each leaf;
    counts and scalars pass unchanged."""
    rank = group_rank(group)

    def shard(d):
        if not _is_param_dict(d, layout):
            return d
        return {k: layout.own_block(v, k, rank) for k, v in d.items()}

    return _map_param_dicts(opt_state, shard)


def unshard_opt_state(opt_state, layout: FlatLayout, group):
    """This rank's flat blocks -> the canonical (parameter-shaped) state,
    the inverse of :func:`shard_opt_state`: one all-gather a
    parameter-keyed dict, called on every rank of ``group``. Every
    checkpoint writes this, so the file is a stage-0 run's."""
    def unshard(d):
        return layout.gather(d, group) if _is_param_dict(d, layout) else d

    return _map_param_dicts(opt_state, unshard)


def per_rank_bytes(opt_state) -> int:
    """Bytes of the tensors of an optimizer state this rank holds (the
    number the 1/dp claim is about)."""
    total = 0

    def visit(tree):
        nonlocal total
        if isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
        elif isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v)

    visit(opt_state)
    return total


def assert_zero_collectives(report: Dict[str, Dict[str, int]],
                            grad_numel_floor: int) -> None:
    """The stage-1 step's contract, over a ``collectives.CALLS``
    snapshot of one step: at least one reduce-scatter and one
    all-gather, and no all-reduce of a full-gradient-sized operand
    (anything of ``grad_numel_floor`` elements or more; the loss, mass
    and norm all-reduces are scalars). Raises AssertionError."""
    if not report.get("reduce_scatter", {}).get("calls"):
        raise AssertionError(f"no reduce_scatter in the step: {report}")
    if not report.get("all_gather", {}).get("calls"):
        raise AssertionError(f"no all_gather in the step: {report}")
    largest = report.get("all_reduce", {}).get("largest", 0)
    if largest >= grad_numel_floor:
        raise AssertionError(
            f"full-gradient all-reduce still present: largest all_reduce "
            f"operand {largest} >= floor {grad_numel_floor}")


__all__: List[str] = ["DimLayout", "FlatLayout", "assert_zero_collectives",
                      "padded_size", "per_rank_bytes", "shard_opt_state",
                      "unshard_opt_state", "widen_dim"]
