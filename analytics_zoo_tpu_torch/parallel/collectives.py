"""Differentiable collectives over the rank mesh's process groups.

The port's counterpart of the ``jax.lax`` collectives the JAX package's
parallel code calls inside ``shard_map`` (``psum``, ``psum_scatter``,
``all_gather``, ``all_to_all``, ``ppermute``). Each is a
``torch.autograd.Function`` whose backward is the collective JAX's
autodiff transposes it to:

  all_reduce (sum)     backward: all_reduce (psum transposes to psum)
  reduce_scatter       backward: all_gather
  all_gather           backward: reduce_scatter
  all_to_all           backward: the reverse all_to_all
  ppermute             backward: ppermute by the inverse permutation

and Megatron's pair around a region whose ranks each compute a part
(tensor parallelism's heads, expert parallelism's experts):
:func:`copy_to_region` (identity forward, all-reduce backward) and
:func:`reduce_from_region` (all-reduce forward, identity backward).

``reduce_scatter``, ``all_gather`` and ``all_to_all`` follow JAX's
``tiled=True`` layout: ``all_gather(x, dim)`` concatenates the ranks'
``x`` along ``dim`` in group order; ``reduce_scatter(x, dim)`` sums over
the group and keeps this rank's ``1/n`` block of ``dim``; ``all_to_all(x,
split_axis, concat_axis)`` cuts ``x`` into ``n`` blocks along
``split_axis``, sends block ``j`` to the group's rank ``j`` and
concatenates what arrives along ``concat_axis`` in group order.

Over a group of one rank (or ``group=None``) every collective is the
identity and makes no call. :data:`CALLS` counts the calls that were
made, by kind, with their element counts (ZeRO's collective contract,
``parallel/zero.py``, reads them).

Gloo on tensors of a card: where ranks share a card the backend is gloo
(NCCL refuses two ranks on one GPU), and gloo carries some collectives on
CUDA tensors itself; the kinds in :data:`GLOO_HOST_ROUTED` it refuses on
them, and for those (under gloo only) the tensor is copied through pinned
host memory and back. :data:`CALLS` counts those copies by kind too
(``host_routed``). Nothing of the compute moves to the CPU.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: collectives gloo refuses on CUDA tensors, carried through pinned host
#: memory under the gloo backend. Gloo (PyTorch 2.11 on an H100, two
#: ranks on one card, each op checked in a gang of its own) carries the
#: all-reduce, reduce-scatter, all-gather and all-to-all on CUDA tensors;
#: its send/recv pair, under the ppermute, kills the gang
GLOO_HOST_ROUTED = frozenset({"ppermute"})


class CallCounter:
    """Thread-safe counts of the collectives made, by kind: calls,
    elements moved (the output of a gather, the input of a reduction),
    the largest operand, and calls routed through host memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._calls: Dict[str, int] = {}
            self._elements: Dict[str, int] = {}
            self._largest: Dict[str, int] = {}
            self._host: Dict[str, int] = {}

    def add(self, kind: str, numel: int, host: bool = False) -> None:
        with self._lock:
            self._calls[kind] = self._calls.get(kind, 0) + 1
            self._elements[kind] = self._elements.get(kind, 0) + int(numel)
            self._largest[kind] = max(self._largest.get(kind, 0), int(numel))
            if host:
                self._host[kind] = self._host.get(kind, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{kind: {"calls", "elements", "largest", "host_routed"}}."""
        with self._lock:
            return {k: {"calls": n, "elements": self._elements[k],
                        "largest": self._largest[k],
                        "host_routed": self._host.get(k, 0)}
                    for k, n in self._calls.items()}


CALLS = CallCounter()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _host_routed(kind: str, group, tensors: Sequence[torch.Tensor]) -> bool:
    return kind in GLOO_HOST_ROUTED and any(t.is_cuda for t in tensors) \
        and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _call(kind: str, group, fn, out: torch.Tensor,
          inputs: Sequence[torch.Tensor], numel: int):
    """Run ``fn(out, *inputs)`` (the raw collective, writing ``out``, in
    place for the all-reduce), through pinned host copies where gloo
    refuses CUDA tensors."""
    host = _host_routed(kind, group, [out, *inputs])
    CALLS.add(kind, numel, host)
    with torch.profiler.record_function(f"zoo_collective/{kind}"):
        if not host:
            fn(out, *inputs)
            return out
        h_out = _to_host(out)
        fn(h_out, *[_to_host(t) for t in inputs])
        out.copy_(h_out)
        return out


# ---------------------------------------------------------------------------
# the raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    out = x.contiguous().clone()
    return _call("all_reduce", group,
                  lambda o: dist.all_reduce(o, group=group), out, [],
                  out.numel())


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _call("all_gather", group,
           lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
           out, [src], out.numel())
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _call("reduce_scatter", group,
           lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
           out, [src], src.numel())
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    # block j of the split axis goes to rank j: lay the blocks out along
    # a new leading axis, exchange along it, then put the received
    # blocks (one from each rank, in rank order) along the concat axis
    shape = list(x.shape)
    shape[split_axis:split_axis + 1] = [n, shape[split_axis] // n]
    src = x.reshape(shape).movedim(split_axis, 0).contiguous()
    out = torch.empty_like(src)
    _call("all_to_all", group,
           lambda o, i: dist.all_to_all_single(o, i, group=group),
           out, [src], src.numel())
    # out[j] is rank j's block; its axes are x's with the split axis
    # cut to 1/n: concatenate the blocks along the concat axis
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def _ppermute(x: torch.Tensor, group,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from group rank ``src`` to ``dst`` for each pair; a rank
    nobody sends to receives zeros (``jax.lax.ppermute``)."""
    n = group_size(group)
    if n == 1:
        if any(s != d for s, d in perm):
            raise ValueError(f"ppermute {perm} over one rank")
        return x if perm else torch.zeros_like(x)
    me = group_rank(group)
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    src = x.contiguous()
    out = torch.zeros_like(src)

    def fn(o, i):
        ranks = dist.get_process_group_ranks(group)
        ops = [dist.P2POp(dist.isend, i, ranks[d], group=group)
               for d in send_to]
        ops += [dist.P2POp(dist.irecv, o, ranks[s], group=group)
                for s in recv_from]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return _call("ppermute", group, fn, out, [src], src.numel())


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, ctx.group, concat_axis, split_axis), None,
                None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), \
            None, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's f: the identity forward, the gradient all-reduced over
    ``group`` backward. Where a replicated activation enters a region
    each rank of ``group`` computes a part of (its heads, its experts),
    the parts' gradients sum into the whole one."""
    return _CopyToRegion.apply(x, group) if group_size(group) > 1 else x


def reduce_from_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's g: the ranks' partial results summed over ``group``
    forward, the gradient passed through unchanged backward (every rank
    holds the same, whole gradient of the sum)."""
    return _ReduceFromRegion.apply(x, group) if group_size(group) > 1 \
        else x


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group`` on every rank (``lax.psum``)."""
    return _AllReduce.apply(x, group) if group_size(group) > 1 else x


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group order
    (``lax.all_gather(..., axis=dim, tiled=True)``)."""
    return _AllGather.apply(x, group, dim) if group_size(group) > 1 else x


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block of the group's sum along ``dim``
    (``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
    return _ReduceScatter.apply(x, group, dim) if group_size(group) > 1 \
        else x


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=, concat_axis=, tiled=True)``."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis % x.dim(),
                           concat_axis % x.dim())


def ppermute(x: torch.Tensor, group=None,
             perm: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """``lax.ppermute``: group rank ``src`` sends ``x`` to ``dst`` for each
    ``(src, dst)`` of ``perm``; a rank nobody sends to gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if group_size(group) == 1:
        return _ppermute(x, group, perm)
    return _PPermute.apply(x, group, perm)


def barrier(group=None) -> None:
    """Every rank of ``group`` (the world by default) reaches this point
    before any leaves it; nothing without ``torch.distributed``."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size(group) > 1:
        dist.barrier(group=group)


__all__: List[str] = ["CALLS", "CallCounter", "GLOO_HOST_ROUTED",
                      "all_gather", "all_reduce", "all_to_all", "barrier",
                      "copy_to_region", "group_rank", "group_size",
                      "ppermute", "reduce_from_region", "reduce_scatter"]
