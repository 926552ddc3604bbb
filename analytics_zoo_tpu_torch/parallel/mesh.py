"""The rank mesh: ``AXES`` and ``make_mesh``.

Counterpart of ``analytics_zoo_tpu/parallel/mesh.py``. The JAX mesh lays
devices of one multi-controller program over named axes; here every
device is one process (a rank), and the mesh lays the ranks of
``torch.distributed``'s world over the same axes:

  data   — data parallelism (gradients summed over the data group)
  pipe   — pipeline stages (GPipe, ``parallel/pipeline.py``)
  seq    — sequence parallelism (Ulysses all-to-alls, ring ppermutes)
  expert — expert parallelism (``SparseMoE``'s stacked experts)
  model  — tensor parallelism (the Megatron layout of TransformerLayer)

Ranks are numbered row-major over (data, pipe, seq, expert, model), as
``np.array(devices).reshape(shape)`` numbers JAX's devices, so the last
axis varies fastest. :func:`make_mesh` creates one process group for each
slice of each axis longer than 1 (every rank creates every group, in the
same order, as ``new_group`` requires): for data=2 x seq=2 over four
ranks the seq groups are {0, 1} and {2, 3}, the data groups {0, 2} and
{1, 3}. An axis of size 1 has no group, and its collectives are the
identity (``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

AXES = ("data", "pipe", "seq", "expert", "model")


class RankMesh:
    """Ranks over the named :data:`AXES`: ``shape`` maps each axis to
    its size, ``ranks`` is the row-major array of ranks, ``rank`` this
    process's. ``group(axis)`` is the process group of this rank's slice
    of ``axis`` (None for an axis of size 1), ``index(axis)`` its
    coordinate along it."""

    def __init__(self, shape: Tuple[int, ...], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, (int(n) for n in shape)))
        self.ranks = np.arange(int(np.prod(shape))).reshape(shape)
        self.rank = int(rank)
        self._coords = tuple(int(c) for c in
                             np.argwhere(self.ranks == self.rank)[0])
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def index(self, axis: str) -> int:
        return self._coords[AXES.index(axis)]

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"RankMesh({self.shape}, rank={self.rank})"


def ambient_axis(axis: str) -> Tuple[object, int, int]:
    """(process group, size, this rank's index) of ``axis`` in the global
    context's mesh; (None, 1, 0) without a context or on an axis of one
    rank. Peeks the context without creating one."""
    from ..common import nncontext as _nn
    mesh = getattr(_nn._global_context, "mesh", None)
    if mesh is None or mesh.shape[axis] <= 1:
        return None, 1, 0
    return mesh.group(axis), mesh.shape[axis], mesh.index(axis)


def axis_slices(ranks: np.ndarray, axis: str) -> List[List[int]]:
    """Every slice of ``axis`` through the rank array, in row-major
    order of the other axes."""
    moved = np.moveaxis(ranks, AXES.index(axis), -1)
    return [[int(r) for r in row] for row in moved.reshape(-1,
                                                           moved.shape[-1])]


def make_mesh(data: int = -1, pipe: int = 1, seq: int = 1, expert: int = 1,
              model: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> RankMesh:
    """The rank mesh over ``world_size`` ranks (the ``torch.distributed``
    world when it is initialised, else 1), with one process group per
    slice of each axis longer than 1. ``data`` <= 0 fills the world."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if joined else 1
    if rank is None:
        rank = dist.get_rank() if joined else 0
    fixed = pipe * seq * expert * model
    if data <= 0:
        data = max(world_size // fixed, 1)
    shape = (data, pipe, seq, expert, model)
    total = int(np.prod(shape))
    if total != world_size:
        # JAX ZooContext's message
        raise ValueError(f"mesh shape {dict(zip(AXES, shape))} needs "
                         f"{total} devices but {world_size} are visible")
    ranks = np.arange(world_size).reshape(shape)
    groups: Dict[str, object] = {}
    if world_size > 1:
        if not joined:
            raise RuntimeError("a mesh of more than one rank needs "
                               "torch.distributed initialised")
        for axis, n in zip(AXES, shape):
            if n <= 1:
                continue
            for members in axis_slices(ranks, axis):
                # every rank creates every group, in the same order
                g = dist.new_group(members)
                if rank in members:
                    groups[axis] = g
    return RankMesh(shape, rank, groups)
