"""Pipeline parallelism over the ``pipe`` axis of the rank mesh (GPipe).

Counterpart of ``analytics_zoo_tpu/parallel/pipeline.py``. The model's
repeated trunk is one stage function and parameters stacked along a
leading stage axis cut over ``pipe`` (:func:`stack_stage_params`,
:func:`stage_param_sharding`): each pipe rank holds its stage's
parameters only. :func:`pipeline_forward` runs GPipe's ``M + S - 1``
ticks: rank 0 takes microbatch ``t`` at tick ``t``, rank ``s`` works on
microbatch ``t - s`` while ``0 <= t - s < M`` and idles otherwise, and
after each tick the busy ranks hand their outputs one stage on. The JAX
function computes every tick on every rank inside a scan (a bubble tick
computes on zeros and is discarded); here a bubble tick computes
nothing, so each rank runs its stage exactly ``M`` times a call.

The backward is GPipe's too, written out: the forward keeps each
microbatch's graph, and the backward walks the ticks in reverse, each
rank receiving the gradient of its output from the next stage, running
that microbatch's backward and handing the gradient of its input to the
previous stage. The stage parameters' gradients sum over the
microbatches; the input's gradient (rank 0's) is all-reduced over the
pipe group, so whatever feeds the pipeline (an embedding every pipe
rank computes alike) gets the same gradient on every rank. The output is
the last stage's, all-reduced from it to every pipe rank (JAX's masked
``psum``), and its gradient, the same on every rank, enters the last
stage as it is.

Hand-offs go through the raw ``ppermute`` (``collectives._ppermute``):
NCCL keeps them on the card, and under gloo, which kills its gang on
send/recv of CUDA tensors, they go through pinned host memory
(``collectives.GLOO_HOST_ROUTED``).

The activations are a tensor or a dict of batch-leading tensors that
travel together (the hidden states with the attention mask): each leaf
keeps its shape and dtype through a stage, and only the leaves that
require a gradient carry one back. A stage that draws dropout needs to
know which microbatch it holds: with ``pass_micro`` the stage function
is called as ``stage_fn(params, x, m)``, ``m`` the microbatch's index,
a host integer every pipe rank knows, so nothing crosses the wire for
it.

Telemetry (JAX's ``_record_schedule``): the ``pipeline/schedule`` event
with the bubble fraction ``(S - 1) / (M + S - 1)``, and each rank's
``pipeline/stage_occupancy`` with the ticks it actually computed; a
schedule of one microbatch over several stages warns and, with
telemetry on, records ``pipeline/degenerate_schedule``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from .collectives import _all_reduce, _ppermute, group_rank, group_size

logger = logging.getLogger("analytics_zoo_tpu_torch.parallel")


def stack_stage_params(per_stage_params) -> Any:
    """Stack identically shaped per-stage parameter trees (dicts of
    tensors) along a new leading 'stage' axis (the axis cut over
    ``pipe``)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))


def stage_param_sharding(stacked_params, mesh=None, axis: str = "pipe"):
    """The specs placing each stage's slice of the stacked parameters on
    its pipe rank: ``(axis, None, ...)`` a leaf."""
    if isinstance(stacked_params, dict):
        return {k: stage_param_sharding(v, mesh, axis)
                for k, v in stacked_params.items()}
    return (axis,) + (None,) * (stacked_params.dim() - 1)


def sequential_reference(stage_fn: Callable, per_stage_params, x):
    """Unpipelined reference: the stages one after another (for tests)."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x


def _record_schedule(S: int, M: int, rank: int, busy: int) -> None:
    """The schedule's telemetry (see the module docstring)."""
    if S <= 1:
        return
    ticks = M + S - 1
    bubble = (S - 1) / ticks
    from ..utils import telemetry
    if M == 1:
        logger.warning(
            "degenerate pipeline schedule: 1 microbatch over %d stages "
            "runs fully serialized (bubble fraction %.2f) — raise "
            "n_microbatch", S, bubble)
        if telemetry.enabled():
            telemetry.event("pipeline/degenerate_schedule", stages=S,
                            microbatches=M, bubble_fraction=bubble)
    if telemetry.enabled():
        telemetry.event("pipeline/schedule", stages=S, microbatches=M,
                        ticks=ticks, bubble_fraction=bubble)
        telemetry.event("pipeline/stage_occupancy", rank=rank,
                        busy_ticks=busy, total_ticks=ticks)


def _flatten(x):
    """(keys or None, leaves) of a tensor or a dict of tensors."""
    if isinstance(x, dict):
        keys = list(x)
        return keys, [x[k] for k in keys]
    return None, [x]


def _unflatten(keys, leaves):
    return leaves[0] if keys is None else dict(zip(keys, leaves))


class _Schedule:
    """What the autograd function needs besides its tensors."""

    def __init__(self, stage_fn, group, n_micro, x_keys, p_keys,
                 pass_micro):
        self.stage_fn = stage_fn
        self.group = group
        self.n_micro = n_micro
        self.x_keys = x_keys
        self.p_keys = p_keys
        self.pass_micro = pass_micro
        self.S = group_size(group)
        self.rank = group_rank(group)

    def pairs(self, t: int):
        """The hand-offs after tick ``t``: (i, i + 1) for each stage ``i``
        that computed at tick ``t``, but the last."""
        return [(i, i + 1) for i in range(self.S - 1)
                if 0 <= t - i < self.n_micro]

    def run_stage(self, params, inp, m):
        p = params[0] if self.p_keys is None else \
            dict(zip(self.p_keys, params))
        x = _unflatten(self.x_keys, inp)
        out = self.stage_fn(p, x, m) if self.pass_micro else \
            self.stage_fn(p, x)
        keys, leaves = _flatten(out)
        if keys != self.x_keys:
            raise ValueError(f"a stage must keep the activations' "
                             f"structure: {self.x_keys} -> {keys}")
        return leaves

    def hand_off(self, leaves, pairs):
        """``leaves`` sent along ``pairs`` (received where this rank is a
        destination); no call where this rank is in no pair."""
        if not any(self.rank in pair for pair in pairs):
            return None
        return [_ppermute(a, self.group, pairs) for a in leaves]


def _forward_schedule(sched: _Schedule, xs, params, graph: bool):
    """The forward ticks on this rank: (the output leaves on every pipe
    rank, each microbatch's (inputs, outputs) where ``graph`` keeps the
    graphs for the backward, which inputs carry a gradient)."""
    S, r, M = sched.S, sched.rank, sched.n_micro
    mb = xs[0].shape[0] // M
    micro = [[a[m * mb:(m + 1) * mb] for a in xs] for m in range(M)]
    template = [torch.zeros_like(a) for a in micro[0]]
    diff = [graph and a.requires_grad and a.is_floating_point()
            for a in xs]
    p_in = [p.detach().requires_grad_(graph and p.requires_grad)
            for p in params]
    kept: Dict[int, tuple] = {}
    outs: List[Optional[list]] = [None] * M
    received = None
    busy = 0
    for t in range(M + S - 1):
        m = t - r
        out = None
        if 0 <= m < M:
            src = micro[m] if r == 0 else received
            inp = [a.detach().requires_grad_(d) for a, d in zip(src, diff)]
            with torch.set_grad_enabled(graph):
                out = sched.run_stage(p_in, inp, m)
            if graph:
                kept[m] = (inp, out)
            busy += 1
            if r == S - 1:
                outs[m] = [o.detach() for o in out]
        payload = [o.detach() for o in out] if out is not None \
            else template
        got = sched.hand_off(payload, sched.pairs(t))
        if got is not None:
            received = got
    _record_schedule(S, M, r, busy)
    if r == S - 1:
        result = [torch.cat([o[i] for o in outs]) for i in range(len(xs))]
    else:
        result = [torch.zeros_like(a) for a in xs]
    # the last stage's output on every pipe rank (JAX's masked psum)
    result = [_all_reduce(a, sched.group) for a in result]
    return result, kept, diff, p_in


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, n_x: int, *tensors):
        xs, params = list(tensors[:n_x]), list(tensors[n_x:])
        result, kept, diff, p_in = _forward_schedule(sched, xs, params,
                                                     graph=True)
        ctx.sched, ctx.kept, ctx.diff, ctx.p_in = sched, kept, diff, p_in
        ctx.x_like = [(tuple(a.shape), a.dtype, a.device) for a in xs]
        ctx.mark_non_differentiable(*[a for a, d in zip(result, diff)
                                      if not d])
        return tuple(result)

    @staticmethod
    def backward(ctx, *g_out):
        sched, kept, diff, p_in = ctx.sched, ctx.kept, ctx.diff, ctx.p_in
        S, r, M = sched.S, sched.rank, sched.n_micro
        idx = [i for i, d in enumerate(diff) if d]
        mb = ctx.x_like[0][0][0] // M
        g_x = [torch.zeros(ctx.x_like[i][0], dtype=ctx.x_like[i][1],
                           device=ctx.x_like[i][2]) for i in idx]
        template = [g[:mb].clone() for g in g_x]
        to_send = None          # the gradient of this rank's last input
        received = None
        for t in reversed(range(M + S - 1)):
            m = t - r
            back = [(d, s) for s, d in sched.pairs(t)]
            got = sched.hand_off(to_send if to_send is not None
                                 else template, back)
            if got is not None:
                received = got
                to_send = None
            if not 0 <= m < M:
                continue
            inp, out = kept.pop(m)
            if r == S - 1:
                grads = [None if g_out[i] is None else
                         g_out[i][m * mb:(m + 1) * mb] for i in idx]
            else:
                grads = received
            pairs = [(out[i], g) for i, g in zip(idx, grads)
                     if g is not None and out[i].requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs],
                                        [g.to(o.dtype) for o, g in pairs])
            in_grads = [inp[i].grad if inp[i].grad is not None
                        else torch.zeros_like(inp[i]) for i in idx]
            if r == 0:
                for j, g in enumerate(in_grads):
                    g_x[j][m * mb:(m + 1) * mb] = g
            else:
                to_send = in_grads
        # rank 0 holds the input's gradient: the same on every pipe rank
        g_x = [_all_reduce(g, sched.group) for g in g_x]
        out = [None] * len(diff)
        for j, i in enumerate(idx):
            out[i] = g_x[j]
        p_grads = [p.grad if p.requires_grad else None for p in p_in]
        ctx.kept = ctx.p_in = None
        return (None, None, *out, *p_grads)


def pipeline_forward(stage_fn: Callable, stage_params, x, mesh=None,
                     n_microbatch: int = 1, axis: str = "pipe",
                     group=None, pass_micro: bool = False):
    """Run this rank's stage of ``S`` pipelined stages over ``x`` with
    GPipe microbatching.

    ``stage_fn(params, activation)`` (or ``(params, activation, m)`` with
    ``pass_micro``) is one stage; it keeps the activations' structure.
    ``stage_params`` is THIS rank's stage parameters (a tensor or a dict
    of tensors; the block of the stacked parameters the pipe rank
    holds). ``x`` holds the activations entering stage 0 (a tensor or a
    dict of batch-leading tensors), the same on every pipe rank;
    ``n_microbatch`` (M) must divide its batch. The pipe group is
    ``mesh.group(axis)`` (or ``group``); over one rank the stage runs
    on each microbatch in turn. Returns the activations after the last
    stage, on every pipe rank."""
    if group is None and mesh is not None:
        group = mesh.group(axis)
    x_keys, x_leaves = _flatten(x)
    batch = x_leaves[0].shape[0]
    if batch % n_microbatch:
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_microbatch {n_microbatch}")
    if isinstance(stage_params, dict):
        p_keys, p_leaves = _flatten(stage_params)
    else:
        p_keys, p_leaves = None, [stage_params]
    sched = _Schedule(stage_fn, group, int(n_microbatch), x_keys, p_keys,
                      pass_micro)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in x_leaves + p_leaves):
        out = _GPipe.apply(sched, len(x_leaves), *x_leaves, *p_leaves)
    else:
        out = _forward_schedule(sched, x_leaves, p_leaves, graph=False)[0]
    return _unflatten(x_keys, list(out))


__all__ = ["pipeline_forward", "sequential_reference",
           "stack_stage_params", "stage_param_sharding"]
