"""Training engine: one device a rank, over a mesh of ranks.

Counterpart of ``analytics_zoo_tpu/pipeline/engine.py`` (``SPMDTrainer``
:180, ``GradientClipping`` :147). The JAX trainer compiles one XLA program
per step over a device mesh; this one runs the step eagerly on its rank's
``torch.device``: forward through the model's graph, the loss on f32
predictions, ``loss.backward()`` (so the flash-attention and
dropout+add+layer-norm kernels run their backward kernels on the card),
the frozen-layer masks, clipping, and the optimizer's functional update,
applied to the model's own parameters in place. ``predict`` and
``InferenceModel`` therefore serve the trained weights.

``compute_dtype`` (the model's ``set_compute_dtype``, else
``ZooConfig.compute_dtype``): "bfloat16" runs the forward and backward
of the loss (training and ``evaluate``) and of ``predict`` in bf16, as
the JAX trainer's ``_cast_tree`` does: the floating parameters are cast
inside autograd (``torch.func.functional_call`` over ``p.to(bf16)``, so
each cast's backward hands a float32 gradient to its float32 parameter),
and every floating input leaf is cast too — float-encoded ids included,
which bf16 rounds above 256, as in the JAX package. Integer inputs pass
unchanged. Predictions return to float32 before the loss. Parameters and
the optimizer state stay float32.

The model's non-trainable state (BatchNorm's moving statistics, the JAX
trainer's ``net_state``) lives in float32 buffers on its layers. The
bf16 cast leaves them out, as JAX's leaves ``net_state`` out, so the
layers read and update their own float32 buffers in either dtype. A
training forward (``train_step``, ``loss_and_grads``) updates them in
place, once a microbatch: the state a step commits with its update, as
JAX's ``_step_body`` returns it. ``evaluate`` and ``predict`` run with
``training=False`` and only read them.

The training stream: each step draws its dropout from a
``torch.Generator`` on the device seeded from ``(seed, step)``, the
counterpart of ``fold_in(key(seed), step)``, and microbatch ``i`` of an
accumulated step from ``(seed, step, i)``. The stream differs from JAX's
by design; the epoch order (``seed + epoch`` shuffles) is the same.

Gradient accumulation (``ZooConfig.grad_accum_steps``, JAX's
``_weighted_grad_sums``/``_accumulated_grads``): the batch splits into
equal microbatches, each one's forward and backward runs in turn, its
weighted-mean loss scaled by its sample-weight mass over the batch's, so
the gradients PyTorch sums into ``.grad`` are the batch's weighted mean,
not a mean of microbatch means; peak activation memory is one
microbatch's.

The host loop (``train``) mirrors the JAX trainer's: the checkpoint,
validation and end triggers per iteration and at epoch end, the
mid-epoch skip of the batches a restored checkpoint had consumed
(``epoch_batches``), auto-resume, the failure-retry policy (restore
``latest`` and go on, up to ``failure_retry_times``; an injected
``ZOO_TPU_FAULT`` step failure counts as a failed step here), the
preemption drain (save, then raise :class:`TrainingPreempted`), and the
TensorBoard scalars once per ``log_every_n_steps`` window. The losses
stay on the device and are read on the host only at window boundaries,
at epoch end and once when ``train`` returns.

The checkpoint store is the JAX package's flat store v2, byte for byte
in layout: ``ckpt-<step>/`` holding ``model.npz``, ``optim.npz``,
``meta.npz`` and their treedefs, then ``manifest.json`` (crc32c and size
of every file) written last and atomically, then the ``latest``
pointer; keep-last-k retention; a checkpoint whose checksums fail is
skipped for the previous one. The files hold the float32 parameters,
the state buffers, the optimizer state in optax's leaf order and the
training position with the host RNG (``utils/jax_weights.py`` maps the
port's state to those trees), so a JAX checkpoint restores here. The
snapshot is owned host memory (pinned and reused between saves on the
GPU) and is complete before ``save_checkpoint`` returns, so the next
step's in-place update cannot reach an async write.

Observability (JAX's ``_epoch_loop`` :1260-1470): with
``ZooConfig.health_monitor`` each step folds ``~isfinite(loss)`` (and of
the grad norm where clipping computed it, or ``health_grad_sentinel``
asks) into a device scalar holding the first bad step's index; the host
reads it at each logging window, at epoch end and before every
checkpoint save (the step is host-bound, so a read a step would
serialize it), and a latched non-finite with ``health_halt`` refuses the
save and raises :class:`TrainingHalted`, leaving ``latest`` at the last
good step. The ``step:nan@N`` / ``grad:nan@N`` faults poison the step's
floating inputs or the first floating parameter. The first step of
``train`` (and of ``evaluate`` / ``predict``) runs inside the FLOP
counter (when a TrainSummary is attached) and the memory accountant
(``ZooConfig.memory_accounting``); each window times the host pipeline's
fetches into an ``InfeedMonitor``, steps the profiler hook, polls the
card's allocator and writes ``HealthState``, ``HBM*MB``,
``InfeedWaitMs``, ``InputBoundFraction``, ``InfeedWorkers`` /
``InfeedWorkerUtilization`` (a transform pool's) and ``MFU`` beside the
loss. Nothing on the training path reads the device every step.

Input (JAX's ``_run_epoch`` / ``_inference_pipeline``): ``train``,
``evaluate`` and ``predict`` read their data through
``feature.host_pipeline.build_host_pipeline`` (a ``TransformedFeatureSet``'s
thread or process pool, the prefetch thread) wrapped in a
``DeviceStagingIterator`` that keeps ``ZooConfig.device_ahead`` batches
staged ahead of the step (k = 1: the fused dispatch is not ported). On a
CUDA device the staging is :class:`PinnedStager`'s: each batch is written
into pinned host buffers and copied with ``non_blocking=True`` on a side
stream, and the step's stream waits on the copy's event before it reads
the batch; on the CPU it is ``put_batch``. ``put_batch`` and
:func:`as_device_tensor` stay for callers outside the engine (serving).

Data parallelism (the context's rank mesh, ``parallel/mesh.py``): with
more than one rank every rank reads the same global batch and keeps its
contiguous block (``P("data")``; padded first to a multiple of dp with
zero-weight rows, JAX's ``_pad_to_dp_multiple``), or, from a dataset
partitioned by ``process_topology()``, reads its 1/dp of the global batch
from its own part. Each rank's loss enters the backward scaled by its
weight mass over the data group's, and the gradients are summed over
every rank holding a replica (data, and seq, whose sum is divided by sp)
in one all-reduce of one flat buffer (:meth:`SPMDTrainer._sum_grads`),
or under ZeRO-1 (``ZooConfig.zero_stage=1``, ``parallel/zero.py``)
reduce-scattered, each rank updating its 1/dp of the optimizer state and
all-gathering the parameters. Each data rank draws its dropout from the
step's generator folded with its data rank. Only rank 0 writes logs,
summaries and checkpoint files; every rank calls ``save_checkpoint``
(the ZeRO gather is a collective) and waits at a barrier for rank 0's
commit. ``evaluate`` and ``predict`` give each data rank its block of
every batch: the metric sums are all-reduced over the data group, and
the predictions all-gathered in order onto every rank.

The parameters' layout (``parallel/sharding.py``, JAX's
``_place_state``): the model's ``set_param_sharding`` function, else
``ZooConfig.param_sharding``'s rules, gives each parameter a spec, and
at the trainer's first use each parameter laid out over an axis longer
than one is cut to this rank's block, in place (``shards``); a pipe or
expert axis nothing is laid out over raises JAX's misconfiguration
error. The forward hands each cut parameter to its layer as the layer
computes on it (``sharding.use_param``: TransformerLayer and SparseMoE
take their model-, pipe- and expert-axis blocks as they are; every other
cut dimension, FSDP's over data or a vocabulary-sharded table, is
all-gathered at use and its gradient reduce-scattered), so the
gradients and the optimizer state have the blocks' shapes. The step
stays the one step: the gradients are summed over data (the leaves not
cut over it) and seq; the model, pipe and expert ranks hold the same
gradient of every replicated leaf (``copy_to_region`` /
``reduce_from_region`` in the layers). Clipping's norm sums each leaf's
squares over the axes it is cut over. ZeRO-1 beside such a layout is
JAX's gspmd mode (:meth:`zero_mode`). Checkpoints of a layout are the
sharded format, each rank writing its regions of every cut leaf
(a qkv block is three regions) and reading back its own regions from
whatever layout wrote the file; ``get_weights``, ``get_params`` and
``save_model`` all-gather the whole leaves.

Checkpoint formats: the flat store above, or with
``ZOO_TPU_SHARDED_CHECKPOINT=1`` the JAX package's sharded format
(``utils/sharded_checkpoint.py``: a shard file a process, manifests,
crc32c, a commit), which either package reads. Both hold the canonical
(parameter-shaped) optimizer state.

Not ported: the fused k-step dispatch (A2/A15).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.nncontext import ZooContext, get_nncontext
from ..common.zoo_trigger import EveryEpoch, MaxEpoch, TrainRecord, \
    ZooTrigger
from ..feature.feature_set import ArrayFeatureSet, FeatureSet, MiniBatch
from ..feature.feature_set import minibatch_len, pad_minibatch
from ..feature.host_pipeline import (DeviceStagingIterator,
                                     build_host_pipeline)
from ..parallel import collectives, sharding, zero
from ..utils import (faults, file_io, memory, serialization,
                     sharded_checkpoint, telemetry)
from ..utils.crc32c import crc32c
from ..utils.jax_weights import (check_optimizer_leaves, load_jax_params,
                                 load_optimizer_leaves, optimizer_leaf_params,
                                 optimizer_leaves, param_order)
from ..utils.profiling import (FlopCounter, InfeedMonitor, ProfilerHook,
                               device_kind, inference_window, peak_flops)
from ..utils.telemetry import span
from .api.keras.optimizers import global_norm

logger = logging.getLogger("analytics_zoo_tpu_torch.engine")

_MASK64 = (1 << 64) - 1


class TrainingPreempted(RuntimeError):
    """Raised out of ``train()`` after a preemption notice: the loop
    saved a final checkpoint (when it has a checkpoint directory) at the
    step boundary. Never retried by the failure-retry policy."""


class TrainingHalted(TrainingPreempted):
    """Raised out of ``train()`` when the health monitor escalated a
    latched non-finite to halt (``ZooConfig.health_halt``). Subclasses
    :class:`TrainingPreempted` so the failure-retry policy never restores
    and retries a diverged run; unlike a preemption no final checkpoint
    is written: the live parameters are poisoned, so ``latest`` keeps the
    last good step."""


class ChecksumError(RuntimeError):
    """A checkpoint file's bytes do not match its recorded crc32c/size."""


# preemption drain: a SIGTERM handler flips this event; every live
# training loop checkpoints at the next step boundary and raises
# TrainingPreempted
_PREEMPTION = threading.Event()
_ACTIVE_TRAINERS: "weakref.WeakSet[SPMDTrainer]" = weakref.WeakSet()


def request_preemption() -> None:
    """Ask every live training loop to checkpoint and exit at its next
    step boundary (signal-safe: an Event set)."""
    _PREEMPTION.set()


def preemption_requested() -> bool:
    return _PREEMPTION.is_set()


def clear_preemption() -> None:
    _PREEMPTION.clear()


def active_trainer_count() -> int:
    """How many trainers are inside ``train()`` right now."""
    return sum(1 for _ in _ACTIVE_TRAINERS)


_CKPT_POOL = None


def _checkpoint_writer_pool():
    """One process-wide single-worker pool for async checkpoint writes
    (they are disk-bound, and one thread caps the cost)."""
    global _CKPT_POOL
    if _CKPT_POOL is None:
        import concurrent.futures
        _CKPT_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="zoo-ckpt-writer")
    return _CKPT_POOL


def _sharded_format() -> bool:
    """``ZOO_TPU_SHARDED_CHECKPOINT=1`` selects the per-process sharded
    format (``utils/sharded_checkpoint.py``) over the flat store."""
    return os.environ.get("ZOO_TPU_SHARDED_CHECKPOINT", "0") == "1"


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for training step ``step`` of a run seeded
    ``seed`` (a splitmix64 mix, so neighbouring steps and seeds give
    unrelated streams)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def as_device_tensor(a, device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``device``; float64
    arrives as float32, as ``jnp.asarray`` gives it without x64."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _batch_leaves(batch) -> list:
    """A host (inputs, targets, weights) batch's arrays in order: the
    inputs, the target (or each target), the weights (None kept)."""
    xs, y, w = batch
    ys = list(y) if isinstance(y, (list, tuple)) else [y]
    return list(xs) + ys + [w]


def _batch_of(batch, leaves) -> tuple:
    """``leaves`` (one per :func:`_batch_leaves` leaf of ``batch``) back in
    the batch's structure, as ``put_batch`` returns it."""
    xs, y, _ = batch
    nx = len(xs)
    ny = len(y) if isinstance(y, (list, tuple)) else 1
    ys = list(leaves[nx:nx + ny]) if isinstance(y, (list, tuple)) \
        else leaves[nx]
    return list(leaves[:nx]), ys, leaves[nx + ny]


def stack_host_batches(hosts) -> tuple:
    """k host batches of one structure as one (k, batch, ...) batch."""
    cols = zip(*(_batch_leaves(h) for h in hosts))
    return _batch_of(hosts[0], [None if c[0] is None else np.stack(c)
                                for c in cols])


def _torch_dtype(np_dtype) -> torch.dtype:
    """The tensor dtype a host array of ``np_dtype`` is staged as: its
    own, float64 narrowed to float32 (``as_device_tensor``'s rule)."""
    if np_dtype == np.float64:
        return torch.float32
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _fill_pinned(buf: torch.Tensor, host: np.ndarray) -> None:
    """Copy ``host`` into the pinned ``buf`` (casting float64 down): a
    multithreaded torch copy where numpy lets torch view the array, else
    numpy's (read-only views: arena and mmap pages)."""
    if host.flags.writeable and min(host.strides, default=0) >= 0:
        buf.copy_(torch.from_numpy(host))
    else:
        np.copyto(buf.numpy(), host, casting="same_kind")


class PinnedStager:
    """Host batches onto a CUDA device through pinned buffers on a side
    stream (the device half of ``DeviceStagingIterator`` on the card).

    Each leaf position of a batch (inputs, targets, weights, in order)
    owns a ring of ``depth + 1`` page-locked host buffers. :meth:`put`
    writes every leaf into its ring's next buffer, then on the stager's
    own ``torch.cuda.Stream`` allocates the device tensors, enqueues the
    copies with ``non_blocking=True`` and records one event after them.
    It returns the device batch and that event: the step's stream must
    ``wait_event`` it before reading the batch (:meth:`SPMDTrainer.
    _staged`). Two hazards are closed here:

    - the device tensors are allocated on the side stream and read on
      the compute stream, so each gets ``record_stream(compute)``: the
      caching allocator then does not hand their memory out again until
      the compute stream's work queued so far has finished;
    - a pinned buffer is refilled only after the event of the copy that
      last read it has completed (``Event.synchronize``), so the next
      batch never overwrites bytes still in flight.

    There is no pageable or synchronous path: a CPU device never builds
    a stager (the trainer's ``put_batch`` serves it)."""

    def __init__(self, device, depth: int):
        self.device = torch.device(device)
        self.slots = max(1, int(depth)) + 1
        self.stream = torch.cuda.Stream(device=self.device)
        # position -> [[pinned buffer, event of its last copy], ...]
        self._rings: Dict[int, List[list]] = {}
        self._turn: Dict[int, int] = {}
        #: batches staged so far
        self.batches = 0

    def __deepcopy__(self, memo):
        # the stream, its events and the pinned buffers are this stager's
        # own resources (none can be copied): a copy of a trainer (a
        # deep-copied model) starts with an empty stager of its own
        return PinnedStager(self.device, self.slots - 1)

    def _slot(self, pos: int, shape, dtype) -> list:
        ring = self._rings.setdefault(pos, [])
        i = self._turn.get(pos, 0)
        self._turn[pos] = (i + 1) % self.slots
        if i == len(ring):
            ring.append([None, None])
        slot = ring[i]
        if slot[1] is not None:
            # the copy that last read this buffer must have landed
            slot[1].synchronize()
        if slot[0] is None or tuple(slot[0].shape) != tuple(shape) or \
                slot[0].dtype != dtype:
            # a normal tensor even when made under predict's inference
            # mode: a later fit refills it in place, which an inference
            # tensor refuses outside inference mode
            with torch.inference_mode(False):
                slot[0] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return slot

    def _stage(self, template, columns):
        """``columns[i]`` holds leaf i of each batch to stage (one batch,
        or the k batches of a stacked chunk)."""
        compute = torch.cuda.current_stream(self.device)
        slots, bufs = [], []
        for pos, col in enumerate(columns):
            if col[0] is None:
                bufs.append(None)
                continue
            hosts = [np.asarray(a) for a in col]
            shape = hosts[0].shape if len(hosts) == 1 else \
                (len(hosts),) + hosts[0].shape
            slot = self._slot(pos, shape, _torch_dtype(hosts[0].dtype))
            if len(hosts) == 1:
                _fill_pinned(slot[0], hosts[0])
            else:
                for j, h in enumerate(hosts):
                    _fill_pinned(slot[0][j], h)
            slots.append(slot)
            bufs.append(slot[0])
        leaves = []
        with torch.cuda.stream(self.stream):
            for buf in bufs:
                if buf is None:
                    leaves.append(None)
                    continue
                dev = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=self.device)
                dev.copy_(buf, non_blocking=True)
                dev.record_stream(compute)
                leaves.append(dev)
            event = torch.cuda.Event()
            event.record(self.stream)
        for slot in slots:
            slot[1] = event
        self.batches += 1
        return _batch_of(template, leaves), event

    def put(self, batch):
        """(device batch, copy event) of one host batch."""
        return self._stage(batch, [[a] for a in _batch_leaves(batch)])

    def put_stacked(self, hosts):
        """(device (k, batch, ...) batch, copy event) of k host batches,
        each leaf stacked straight into one pinned buffer and copied
        once."""
        return self._stage(hosts[0], [list(c) for c in zip(
            *(_batch_leaves(h) for h in hosts))])


def _sorted_leaves(tree) -> list:
    """A nested dict's leaves with keys sorted at every level
    (``jax.tree_util.tree_leaves`` of a dict tree)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                _sorted_leaves(tree[k])]
    return [tree]


def _tree_float(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_float(v) for v in x)
    return x.float()


def _cast_floating(x, dtype):
    """``x`` (a tensor, or a list or tuple of them) with every floating
    tensor cast to ``dtype`` (``_cast_tree``)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_floating(v, dtype) for v in x)
    return x.to(dtype) if x.is_floating_point() else x


class GradientClipping:
    """Constant / L2-norm clipping (``setConstantGradientClipping`` /
    ``setGradientClippingByL2Norm``, Topology.scala:261-294)."""

    def __init__(self, min_value=None, max_value=None, l2_norm=None):
        self.min_value = min_value
        self.max_value = max_value
        self.l2_norm = l2_norm

    def apply_with_norm(self, grads: Dict[str, torch.Tensor],
                        precomputed_norm=None):
        """Clip, and return the pre-clip global norm when L2-norm clipping
        computed one (else None). ``precomputed_norm``: the norm to clip
        by (ZeRO's, summed over the ranks' blocks)."""
        gnorm = precomputed_norm
        if self.l2_norm is not None:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(self.l2_norm / (gnorm + 1e-12), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        if self.min_value is not None or self.max_value is not None:
            lo = -np.inf if self.min_value is None else self.min_value
            hi = np.inf if self.max_value is None else self.max_value
            grads = {k: torch.clamp(g, lo, hi) for k, g in grads.items()}
        return grads, gnorm


class SPMDTrainer:
    """Trains ``model`` (a ``KerasNet``) on this rank's device, over the
    context's rank mesh.

    ``loss_fn`` is a ``LossFunction``, ``optimizer`` a ``ZooOptimizer``.
    ``device`` defaults to the context's (``cuda:0`` unless the context
    was made for the CPU). The model's parameters, keyed by their
    ``named_parameters()`` paths (``bert_1.block0.qkv_w``), are the
    param tree; the first path component is the layer name that
    :meth:`set_frozen` masks."""

    # the flat checkpoint store v2 (see the module docstring)
    CKPT_PREFIX = "ckpt-"
    LATEST_FILE = "latest"

    def __init__(self, model, loss_fn, optimizer, metrics=None,
                 ctx: Optional[ZooContext] = None, device=None,
                 clipping: Optional[GradientClipping] = None, seed: int = 0,
                 compute_dtype=None):
        self.ctx = ctx or get_nncontext()
        self.device = torch.device(device) if device is not None else \
            self.ctx.device
        # an explicit per-model dtype wins; None falls back to the config,
        # and only "bfloat16"/"bf16" turn the casts on
        if compute_dtype is None:
            compute_dtype = getattr(self.ctx.config, "compute_dtype", None)
        #: torch.bfloat16, or None for float32
        self.compute_dtype = torch.bfloat16 if str(compute_dtype) in \
            ("bfloat16", "bf16") else None
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.tx = optimizer.transformation()
        self.lr_schedule = optimizer.lr_schedule()
        self.metrics = metrics or []
        self.clipping = clipping or GradientClipping()
        self.seed = seed
        self.opt_state = None
        self.step = 0
        self.epoch = 0
        #: batches of the current epoch consumed: saved in a checkpoint's
        #: meta, and skipped (the epoch order is a function of the seed
        #: and epoch) when training resumes mid-epoch
        self.epoch_batches = 0
        #: the losses of the steps of the last ``train`` call, as floats
        self.step_losses: List[float] = []
        self.frozen_names: frozenset = frozenset()
        self.train_summary = None
        self.val_summary = None
        self.checkpoint_dir: Optional[str] = None
        self.checkpoint_trigger: Optional[ZooTrigger] = None
        #: one dict per save: the step, bytes and seconds by phase
        #: (``wait_s`` for the previous write, ``snapshot_s``,
        #: ``serialize_s``, ``crc32c_s``, ``write_s``; ``stall_s`` is the
        #: loop's whole wait); an async save's write phases appear once it
        #: has landed
        self.checkpoint_stats: List[Dict[str, float]] = []
        #: seconds of the last ``load_checkpoint``, checksums included
        self.last_load_s: Optional[float] = None
        self._last_log_step = 0
        self._last_gnorm = None
        self._losses: List[Tuple[int, torch.Tensor]] = []
        self._ckpt_future = None
        self._snapshot_buffers: List[torch.Tensor] = []
        #: FLOPs of one training step (utils/profiling.FlopCounter),
        #: counted on the first step of a ``train`` with a TrainSummary;
        #: the MFU scalar reads it
        self.flops_per_step: Optional[float] = None
        #: the train program's memory breakdown (utils/memory.py), measured
        #: on its first step
        self.hbm_breakdown: Optional[Dict[str, Any]] = None
        self._mem_accounted: set = set()
        #: throughput and infeed scalars of the last evaluate / predict
        self.last_eval_stats: Optional[Dict[str, float]] = None
        self.last_predict_stats: Optional[Dict[str, float]] = None
        # the training health monitor (pipeline/health.py), built per
        # train() when ZooConfig.health_monitor is on, and its sentinel:
        # a device int64 holding the first non-finite step's count, -1
        self._health = None
        self._first_bad: Optional[torch.Tensor] = None
        # the profiler hook of the running train() (ZooConfig.profile_dir)
        self._profiler: Optional[ProfilerHook] = None
        # the pinned side-stream stager (CUDA devices), built on first use
        self._pinned: Optional[PinnedStager] = None
        #: the rank mesh (None: a world of one)
        self.mesh = getattr(self.ctx, "mesh", None)
        # ZeRO-1 ("off" / "flat" / "gspmd", resolved on first use), the
        # flat layout of this rank's optimizer shards, and gspmd's blocks
        self._zero_mode: Optional[str] = None
        self._zero_layout: Optional[zero.FlatLayout] = None
        self._zero_dims: Optional[zero.DimLayout] = None
        #: {path: spec} of the parameters' layout (None until installed)
        self.param_specs: Optional[Dict[str, tuple]] = None
        #: {path: LeafShard} of the parameters cut over the mesh
        self.shards: Dict[str, sharding.LeafShard] = {}

    def set_frozen(self, names):
        self.frozen_names = frozenset(names or ())

    def _frozen(self, path: str) -> bool:
        return path.split(".", 1)[0] in self.frozen_names

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def ensure_initialized(self):
        self.model.to(self.device)
        self._install_layout()
        if self.opt_state is None:
            with torch.no_grad():
                self.opt_state = self.tx.init(self._opt_params())

    # ------------------------------------------------------------------
    # the parameters' layout over the mesh (parallel/sharding.py)
    # ------------------------------------------------------------------
    def _install_layout(self) -> None:
        """Resolve the parameters' layout (``set_param_sharding``, else
        ``ZooConfig.param_sharding``; JAX ``_place_state``), refuse a
        misconfigured mesh, and cut each parameter laid out over an axis
        longer than one into this rank's block (once)."""
        if self.param_specs is not None:
            return
        fn = None
        if hasattr(self.model, "_resolve_param_sharding_fn"):
            fn = self.model._resolve_param_sharding_fn(
                self.model.graph_function())
        specs = sharding.model_specs(self.model, fn) if fn is not None \
            else {}
        self._validate_parallel_config(specs)
        if self.mesh is not None and specs:
            self.shards = sharding.install_layout(self.model, specs,
                                                  self.mesh)
            if self.shards and getattr(self.optimizer, "clipnorm", None):
                raise ValueError(
                    "a layout over the mesh needs an elementwise "
                    "optimizer: clipnorm takes a global norm of the whole "
                    "gradient; use set_gradient_clipping_by_l2_norm "
                    "instead")
        self.param_specs = specs

    def _validate_parallel_config(self, specs) -> None:
        """The pipe and expert axes must be used by the parameters'
        layout; seq is a library-level axis (ring and Ulysses attention).
        A config that would degrade to replicated compute raises (JAX
        :294-312)."""
        if self.mesh is None:
            return
        if self.mesh.shape["pipe"] > 1 and not any(
                sharding.spec_mentions(s, "pipe") for s in specs.values()):
            raise ValueError(
                "pipeline_parallel > 1 but no parameter is laid out over "
                "the 'pipe' axis — use a pipeline-capable model (e.g. "
                "TransformerLayer/BERT built under this context stacks "
                "its blocks per stage) with set_param_sharding(), or set "
                "pipeline_parallel=1")
        if self.mesh.shape["expert"] > 1 and not any(
                sharding.spec_mentions(s, "expert") for s in specs.values()):
            raise ValueError(
                "expert_parallel > 1 but no parameter is laid out over "
                "the 'expert' axis — add a SparseMoE layer (e.g. "
                "TransformerLayer(moe_experts=...)) with "
                "set_param_sharding(), or set expert_parallel=1")

    def _cut(self, path: str, axis: str) -> bool:
        """Whether parameter ``path`` is cut over ``axis``."""
        shard = self.shards.get(path)
        return shard is not None and axis in shard.axes

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The gradients' global L2 norm over the whole leaves: each
        leaf's squares summed over the axes it is cut over (under gspmd,
        ``data`` too for the leaves whose blocks are cut there)."""
        widened = set() if self._zero_dims is None else \
            set(self._zero_dims.dims)
        buckets: Dict[tuple, torch.Tensor] = {}
        for k, g in grads.items():
            shard = self.shards.get(k)
            axes = set(shard.axes) if shard is not None else set()
            if k in widened:
                axes.add("data")
            key = tuple(a for a in sharding.AXES if a in axes)
            sq = (g.float() * g.float()).sum()
            buckets[key] = buckets[key] + sq if key in buckets else sq
        total = torch.zeros((), device=self.device)
        for axes, sq in buckets.items():
            for axis in axes:
                sq = collectives.all_reduce(sq, self._group(axis))
            total = total + sq
        return torch.sqrt(total)

    # ------------------------------------------------------------------
    # the rank mesh: data parallelism and ZeRO-1
    # ------------------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return 1 if self.mesh is None else self.mesh.shape[axis]

    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def is_rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _group(self, axis: str):
        """The process group of ``axis`` (None over one rank)."""
        return None if self.mesh is None else self.mesh.group(axis)

    def zero_mode(self) -> str:
        """"off" (stage 0, or dp = 1), "flat" (stage 1 on a pure
        data-parallel mesh with every parameter whole: flat optimizer
        shards, reduce-scatter, all-gather) or "gspmd" (stage 1 beside
        another axis, or with a parameter laid out over the mesh: the
        moments of the leaves not laid out over data cut over data along
        :func:`zero.widen_dim`'s dimension), JAX's choice
        (``_zero_mode_resolved``)."""
        if self._zero_mode is not None:
            return self._zero_mode
        stage = int(getattr(self.ctx.config, "zero_stage", 0) or 0)
        if stage not in (0, 1):
            raise ValueError(f"zero_stage must be 0 or 1, got {stage}")
        if stage == 0 or self.axis_size("data") <= 1:
            self._zero_mode = "off"
            return self._zero_mode
        if getattr(self.optimizer, "clipnorm", None):
            raise ValueError(
                "zero_stage=1 needs an elementwise optimizer: clipnorm "
                "takes a global norm of the whole gradient; use "
                "set_gradient_clipping_by_l2_norm instead")
        self._install_layout()
        dp = self.axis_size("data")
        all_repl = all(sharding.spec_is_replicated(s)
                       for s in self.param_specs.values())
        params = self.params()
        if self.world_size() == dp and all_repl:
            self._zero_mode = "flat"
            self._zero_layout = zero.FlatLayout(
                {k: p.shape for k, p in params.items()}, dp)
            return self._zero_mode
        self._zero_mode = "gspmd"
        dims = {}
        for k, p in params.items():
            shape = sharding.full_shape(p)
            d = zero.widen_dim(self.param_specs.get(k, ()), shape, dp)
            if d is not None:
                dims[k] = d
        self._zero_dims = zero.DimLayout(
            {k: p.shape for k, p in params.items()}, dims, dp)
        return self._zero_mode

    def _opt_params(self) -> Dict[str, torch.Tensor]:
        """What the optimizer state mirrors: the parameters, under flat
        ZeRO-1 this rank's flat block of each, under gspmd this rank's
        data block of each leaf it cuts."""
        params = self.params()
        mode = self.zero_mode()
        if mode == "off":
            return params
        rank = self.mesh.index("data")
        if mode == "gspmd":
            return {k: self._zero_dims.own(p.detach(), k, rank)
                    if k in self._zero_dims.dims else p
                    for k, p in params.items()}
        return {k: self._zero_layout.own_block(p.detach(), k, rank)
                for k, p in params.items()}

    def canonical_opt_state(self):
        """The optimizer state in the parameter-shaped (stage 0) form:
        under flat ZeRO-1 an all-gather over the data group, so every
        rank calls it; under gspmd the cut moments all-gathered into the
        parameters' own shapes (blocks, for a parameter laid out over
        the mesh)."""
        mode = self.zero_mode()
        if mode == "off":
            return self.opt_state
        with torch.no_grad():
            if mode == "gspmd":
                layout, group = self._zero_dims, self.mesh.group("data")
                return zero._map_param_dicts(
                    self.opt_state, lambda d: {**d, **layout.gather(
                        {k: d[k] for k in layout.dims}, group)}
                    if layout.dims and set(layout.dims) <= set(d) else d)
            return zero.unshard_opt_state(self.opt_state, self._zero_layout,
                                          self.mesh.group("data"))

    def _rank_block(self, batch: MiniBatch) -> MiniBatch:
        """This rank's contiguous block of a global host batch, as
        ``P("data")`` slices it; the batch is first padded to a multiple
        of dp with zero-weight rows (``_pad_to_dp_multiple``). Seq ranks
        of one data group take the same block."""
        dp = self.axis_size("data")
        n = minibatch_len(batch)
        target = -(-n // dp) * dp
        if target != n:
            batch = pad_minibatch(batch, target)
        lo = self.mesh.index("data") * (target // dp)
        hi = lo + target // dp

        def cut(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return type(a)(cut(v) for v in a)
            return np.asarray(a)[lo:hi]

        xs, y, w = batch
        return MiniBatch(cut(tuple(xs)), cut(y), cut(w))

    def put_batch(self, batch: MiniBatch):
        """A host (inputs, targets, weights) batch as tensors on the
        trainer's device."""
        xs, y, w = batch
        put = lambda a: None if a is None else as_device_tensor(a, self.device)
        ys = [put(t) for t in y] if isinstance(y, (list, tuple)) else put(y)
        return [put(x) for x in xs], ys, put(w)

    def _stager(self) -> Optional[PinnedStager]:
        """The pinned side-stream stager on a CUDA device (rebuilt when
        ``device_ahead`` changes), None on the CPU."""
        if self.device.type != "cuda":
            return None
        depth = max(1, int(getattr(self.ctx.config, "device_ahead", 2)))
        if self._pinned is None or self._pinned.slots != depth + 1:
            self._pinned = PinnedStager(self.device, depth)
        return self._pinned

    def _put_one(self, batch):
        """``DeviceStagingIterator``'s ``put_one``: (device batch, the
        copy's event or None). On the card the pinned side-stream copy;
        on the CPU ``put_batch``."""
        stager = self._stager()
        if stager is None:
            return self.put_batch(batch), None
        return stager.put(batch)

    def _put_stacked(self, hosts):
        """``put_stacked``: k host batches as one (k, batch, ...) device
        batch and its event (the port's loops ask for k = 1, so only the
        staging contract's tests reach it)."""
        stager = self._stager()
        if stager is None:
            return self.put_batch(stack_host_batches(hosts)), None
        return stager.put_stacked(hosts)

    def _staged(self, put):
        """The device batch of a ``_put_one`` result, once the step's
        stream waits for its copy."""
        dev, event = put
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return dev

    def _grad_accum_steps(self) -> int:
        return max(1, int(getattr(self.ctx.config, "grad_accum_steps", 1)
                          or 1))

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def _forward(self, xs, generator, training: bool):
        """The model's outputs on device inputs ``xs``, in the compute
        dtype, as float32. A parameter cut over the mesh enters as its
        layer computes on it (``sharding.use_param``: all-gathered over
        the axes its layer does not compute on as blocks)."""
        if self.compute_dtype is None and not self.shards:
            preds = self.model(list(xs), training=training,
                               generator=generator)
        else:
            dt = self.compute_dtype
            cast = {}
            for k, p in self.model.named_parameters():
                t = sharding.use_param(p) if k in self.shards else p
                cast[k] = t if dt is None else _cast_floating(t, dt)
            xs = xs if dt is None else _cast_floating(list(xs), dt)
            preds = torch.func.functional_call(
                self.model, cast, (list(xs),),
                dict(training=training, generator=generator))
        return _tree_float(preds)

    def _loss_and_preds(self, batch, generator, training: bool):
        xs, y, w = batch
        preds_f = self._forward(xs, generator, training)
        return self.loss_fn(preds_f, y, w), preds_f

    def generator(self, step: int, micro: Optional[int] = None
                  ) -> torch.Generator:
        """The dropout stream of training step ``step`` (of its
        microbatch ``micro`` under gradient accumulation)."""
        seed = step_seed(self.seed, step)
        if micro is not None:
            seed = step_seed(seed, micro)
        if self.axis_size("data") > 1:
            # each data rank draws its own masks (JAX's fold_in of the
            # data axis index)
            seed = step_seed(seed, self.mesh.index("data"))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    @staticmethod
    def _microbatch(batch, i: int, size: int):
        def cut(x):
            if x is None:
                return None
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v) for v in x)
            return x[i * size:(i + 1) * size]

        xs, y, w = batch
        return cut(list(xs)), cut(y), cut(w)

    def loss_and_grads(self, batch, training: bool = True):
        """Forward and backward of this rank's device batch at the current
        step, without a parameter update: the loss, and each parameter's
        gradient left in its ``.grad`` (None where the loss does not reach
        it). A training forward updates the state buffers. The batch runs
        as ``grad_accum_steps`` = k equal microbatches (training only,
        ``_weighted_grad_sums``): each microbatch's weighted-mean loss
        enters the backward scaled by its weight mass over the data
        group's total mass (JAX :544), so ``.grad`` summed over the data
        ranks is the global batch's weighted-mean gradient, and the loss
        returned is the mass-weighted mean over the data group
        (:651-652). Over one rank and one microbatch the scale is exactly
        1 and the loss is the batch's own."""
        params = self.params()
        for p in params.values():
            p.grad = None
        accum = self._grad_accum_steps() if training else 1
        xs, _, w = batch
        n = xs[0].shape[0]
        if n % accum:
            raise ValueError(f"grad_accum_steps={accum} must divide the "
                             f"batch of {n}")
        size = n // accum
        masses = [w[i * size:(i + 1) * size].float().sum() if w is not None
                  else torch.tensor(float(size), device=self.device)
                  for i in range(accum)]
        data = self._group("data")
        with torch.no_grad():
            total = torch.clamp(collectives.all_reduce(
                torch.stack(masses).sum(), data), min=1e-12)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            micro = batch if accum == 1 else self._microbatch(batch, i, size)
            gen = self.generator(self.step, i if accum > 1 else None) \
                if training else None
            loss, _ = self._loss_and_preds(micro, gen, training)
            share = masses[i] / total
            (loss * share).backward()
            loss_sum = loss_sum + loss.detach() * share
        with torch.no_grad():
            return collectives.all_reduce(loss_sum, data)

    def train_step(self, batch) -> torch.Tensor:
        """One optimization step on this rank's device batch
        (``_step_body``): fwd (which updates the state buffers), bwd, the
        gradients summed over the replicas (:meth:`summed_grads`),
        clipping, update, frozen layers left still; under ZeRO-1 the
        update is :meth:`_zero_update`. The state buffers' floating values
        (BatchNorm's moving statistics, each rank's from its own block)
        are then averaged over the data group, as JAX's ZeRO step does.
        Returns the loss on the device (no host sync)."""
        loss, grads = self.summed_grads(batch)
        params = self.params()
        with torch.no_grad():
            mode = self.zero_mode()
            if mode == "flat":
                self._zero_update(loss, grads)
            else:
                layout = self._zero_dims if mode == "gspmd" else None
                gnorm = None
                if self.shards or layout is not None:
                    want = self.clipping.l2_norm is not None or (
                        getattr(self.ctx.config, "health_monitor", False)
                        and getattr(self.ctx.config, "health_grad_sentinel",
                                    False))
                    gnorm = self._global_norm(grads) if want else None
                grads, self._last_gnorm = self.clipping.apply_with_norm(
                    grads, precomputed_norm=gnorm)
                if getattr(self.ctx.config, "health_monitor", False):
                    self._update_sentinel(loss, grads)
                rank = self.mesh.index("data") if layout else 0
                # gspmd: this rank's data block of each leaf it cuts (a
                # view, updated in place, then all-gathered)
                targets = {k: layout.own(p, k, rank)
                           if layout and k in layout.dims else p
                           for k, p in params.items()}
                updates, self.opt_state = self.tx.update(
                    grads, self.opt_state, targets)
                # frozen layers do not move at all: stateful transforms
                # (Adam moments from before the freeze, weight decay)
                # still emit nonzero updates for them, as in the JAX step
                for k, p in targets.items():
                    if not self._frozen(k):
                        p.add_(updates[k].to(p.dtype))
                if layout is not None and layout.dims:
                    full = layout.gather({k: targets[k] for k in
                                          layout.dims}, self._group("data"))
                    for k in layout.dims:
                        if not self._frozen(k):
                            params[k].copy_(full[k])
            self._average_state()
        self.step += 1
        return loss

    def summed_grads(self, batch):
        """Forward and backward of this rank's batch and the gradients
        summed over the replicas, before clipping and the update: (the
        loss, {path: gradient}). Frozen layers' gradients are zero."""
        loss = self.loss_and_grads(batch)
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None and
                     not self._frozen(k) else torch.zeros_like(p)
                     for k, p in self.params().items()}
            return loss, self._sum_grads(grads)

    def _sum_grads(self, grads):
        """The gradients summed over the ranks whose parts make them: the
        data group (each rank's rows), and the seq group, whose ranks each
        computed the same loss and whose sum therefore holds it ``sp``
        times (divided by ``sp``). On a mesh of data and seq ranks alone,
        one all-reduce of one flat buffer over the world. A leaf cut over
        ``data`` (FSDP) was summed by its all-gather's reduce-scatter; the
        model, pipe and expert ranks hold the same gradient of every
        replicated leaf already (``copy_to_region`` /
        ``reduce_from_region``). Under flat ZeRO-1 this rank's flat block
        of each (one reduce-scatter of the packed gradients, JAX's
        ``psum_scatter``), under gspmd this rank's data block of each leaf
        whose moments it cuts. Over one rank the gradients as they
        are."""
        mode = self.zero_mode()
        if mode == "flat":
            layout = self._zero_layout
            return layout.split(collectives.reduce_scatter(
                layout.pack(grads), self._group("data"), dim=0))
        if self.world_size() == 1:
            return grads
        sp = self.axis_size("seq")
        cut = self._zero_dims.dims if mode == "gspmd" else {}
        if cut:
            grads.update(self._zero_dims.split(collectives.reduce_scatter(
                self._zero_dims.pack(grads), self._group("data"), dim=0)))
        rest = [k for k in grads if k not in cut and
                not self._cut(k, "data")]
        dp = self.axis_size("data")
        if not cut and len(rest) == len(grads) and \
                self.world_size() == dp * sp:
            import torch.distributed as dist
            return self._all_reduce_keys(grads, list(grads),
                                         dist.group.WORLD, sp)
        self._all_reduce_keys(grads, rest, self._group("data"), 1)
        if sp > 1:
            self._all_reduce_keys(grads, list(grads), self._group("seq"), sp)
        return grads

    def _all_reduce_keys(self, grads, keys, group, divide: int):
        """Sum ``grads[k]`` for ``keys`` over ``group`` in one all-reduce
        of one flat buffer, divided by ``divide``; in place in
        ``grads``. Nothing over a group of one rank (None)."""
        if not keys or collectives.group_size(group) == 1:
            return grads
        flat = collectives.all_reduce(
            torch.cat([grads[k].reshape(-1) for k in keys]), group)
        if divide > 1:
            flat.div_(divide)
        off = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[off:off + n].view_as(grads[k])
            off += n
        return grads

    def _zero_update(self, loss, g_sh) -> None:
        """ZeRO-1's update (JAX ``_zero_step_body``) from this rank's
        blocks ``g_sh`` of the summed gradients: clipping's norm is the
        sum over the data group of the blocks' squares; the optimizer
        updates this rank's blocks of the parameters and moments; one
        all-gather brings the updated parameters back to every rank."""
        layout, data = self._zero_layout, self._group("data")
        want_norm = self.clipping.l2_norm is not None or (
            getattr(self.ctx.config, "health_monitor", False) and
            getattr(self.ctx.config, "health_grad_sentinel", False))
        gnorm = None
        if want_norm:
            sq = sum((g.float() * g.float()).sum() for g in g_sh.values())
            gnorm = torch.sqrt(collectives.all_reduce(sq, data))
        g_sh, self._last_gnorm = self.clipping.apply_with_norm(
            g_sh, precomputed_norm=gnorm)
        if getattr(self.ctx.config, "health_monitor", False):
            self._update_sentinel(loss, g_sh)
        rank = self.mesh.index("data")
        params = self.params()
        p_sh = {k: layout.own_block(p, k, rank) for k, p in params.items()}
        updates, self.opt_state = self.tx.update(g_sh, self.opt_state, p_sh)
        for k, u in updates.items():
            if not self._frozen(k):
                p_sh[k].add_(u.to(p_sh[k].dtype))
        full = layout.gather(p_sh, data)
        for k, p in params.items():
            if not self._frozen(k):
                p.copy_(full[k])

    def _average_state(self) -> None:
        """Average the floating state buffers over the data group."""
        if self.axis_size("data") <= 1:
            return
        bufs = [b for b in self.model.buffers() if b.is_floating_point()]
        if not bufs:
            return
        flat = collectives.all_reduce(
            torch.cat([b.reshape(-1).float() for b in bufs]),
            self.mesh.group("data")) / self.axis_size("data")
        off = 0
        for b in bufs:
            b.copy_(flat[off:off + b.numel()].view_as(b))
            off += b.numel()

    def _update_sentinel(self, loss, grads):
        """Fold this step's non-finite check into the device sentinel:
        ``~isfinite(loss)``, OR'd with the grad norm's where clipping
        computed it (``health_grad_sentinel`` computes it otherwise). The
        sentinel keeps the first bad step's 1-based count; nothing is read
        on the host here."""
        gnorm = self._last_gnorm
        if gnorm is None and bool(getattr(self.ctx.config,
                                          "health_grad_sentinel", False)):
            gnorm = global_norm(grads)
        bad = ~torch.isfinite(loss)
        if gnorm is not None:
            bad = bad | ~torch.isfinite(gnorm)
        if self._first_bad is None:
            self._first_bad = torch.full((), -1, dtype=torch.int64,
                                         device=self.device)
        self._first_bad = torch.where(bad & (self._first_bad < 0),
                                      self.step + 1, self._first_bad)

    def _read_sentinel(self) -> None:
        """The host read of the sentinel: a latched non-finite goes up the
        health monitor's ladder (event, flight dump, and with
        ``health_halt`` the drain) as the step it happened at."""
        if self._health is None or self._first_bad is None:
            return
        with span("train/health_sync", step=self.step):
            first = int(self._first_bad)
        if first >= 0:
            self._first_bad.fill_(-1)
            self._health.on_nonfinite(first, signal="sentinel")

    def _ckpt_allowed(self) -> bool:
        """Checkpoint writes are refused once the health monitor latched a
        non-finite halt (the sentinel is read first): the live parameters
        are poisoned and must never shadow the last good ``latest``."""
        self._read_sentinel()
        return self._health is None or not self._health.halted

    def _raise_if_halted(self) -> None:
        """Raise :class:`TrainingHalted` once the health monitor latched a
        halt. The live parameters are poisoned: no final checkpoint, and
        ``latest`` keeps the last good step."""
        if self._health is not None and self._health.halted:
            raise TrainingHalted(
                f"health monitor halted training at step "
                f"{self._health.halt_step}"
                + ("" if self.checkpoint_dir is None
                   else f"; restore the last good step from "
                        f"{self.checkpoint_dir}"))

    def _maybe_poison(self, batch):
        """Apply armed ``step:nan@N`` / ``grad:nan@N`` faults
        (utils/faults.py) to the upcoming step, JAX's
        ``_maybe_poison_chunk``: NaN-fill the step's floating inputs, or
        the first floating parameter in the JAX params tree's order. Two
        cheap spec lookups when nothing is armed."""
        if faults.poison_step(self.step, 1) is not None:
            xs, y, w = batch
            batch = ([torch.full_like(x, float("nan"))
                      if x.is_floating_point() else x for x in xs], y, w)
        if faults.poison_grad(self.step, 1):
            params = self.params()
            for k in param_order(self.model):
                if params[k].is_floating_point():
                    with torch.no_grad():
                        params[k].fill_(float("nan"))
                    break
        return batch

    @staticmethod
    def _batch_bytes(batch) -> int:
        """Bytes of a device batch's tensors (what ``put_batch`` moved)."""
        out, stack = 0, [batch]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                out += x.numel() * x.element_size()
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        return out

    def _wants_accounting(self, program: str) -> bool:
        """Measure ``program``'s first step when the accountant is on and
        its numbers have a reader (a TrainSummary for the train breakdown,
        or the telemetry spine's gauges)."""
        if program in self._mem_accounted or \
                not getattr(self.ctx.config, "memory_accounting", True):
            return False
        return telemetry.enabled() or \
            (program == "train" and self.train_summary is not None)

    def _observed(self, program: str, fn, batch):
        """``fn(batch)``; on the program's first call, inside the FLOP
        counter (train with a TrainSummary) and the memory accountant.
        Observability never fails the step: its own errors are logged."""
        count = program == "train" and self.flops_per_step is None and \
            self.train_summary is not None
        account = self._wants_accounting(program)
        if not (count or account):
            return fn(batch)
        if account:
            self._mem_accounted.add(program)
        with contextlib.ExitStack() as stack:
            counter = None
            if count:
                try:
                    counter = stack.enter_context(FlopCounter())
                except Exception:  # noqa: BLE001 - counting is optional
                    logger.debug("FLOP counter unavailable", exc_info=True)
                    self.flops_per_step = 0.0
            acc = stack.enter_context(memory.StepAccountant(
                self.device, exclude=list(self.model.parameters())
                + list(self.model.buffers()))) if account else None
            out = fn(batch)
        if counter is not None:
            self.flops_per_step = float(counter.total)
        if acc is not None:
            self._record_breakdown(program, batch, acc)
        return out

    def _record_breakdown(self, program, batch, acc):
        try:
            order = param_order(self.model)
            train = program == "train"
            groups = memory.opt_state_groups(self.opt_state, order) \
                if train else {}
            bd = memory.program_breakdown(
                memory.params_bytes(self.params()),
                sum(g["bytes"] for g in groups.values()),
                # evaluate and predict run without autograd: nothing is
                # saved, their activations are not measured
                acc.saved_bytes if train else None,
                # the batch moved to the device; train and eval read the
                # loss back (4 bytes), predict its outputs
                self._batch_bytes(batch) + (4 if program != "predict"
                                            else 0),
                acc.step_peak_bytes, acc.allocated_before)
            memory.account_program(program, bd, groups, device=self.device)
            if train:
                self.hbm_breakdown = bd
                logger.info(
                    "train step memory: total %.1f MiB (params %.1f, opt "
                    "%.1f, saved activations %.1f, transfers %.1f)",
                    bd["total_bytes"] / 2**20, bd["params_bytes"] / 2**20,
                    bd["opt_state_bytes"] / 2**20,
                    bd["activations_temp_bytes"] / 2**20,
                    bd["transfers_bytes"] / 2**20)
        except Exception:  # noqa: BLE001 - observability must not kill run
            logger.debug("memory accounting failed for %s", program,
                         exc_info=True)

    # ------------------------------------------------------------------
    # train / evaluate
    # ------------------------------------------------------------------
    def train(self, train_set: FeatureSet, batch_size: int,
              end_trigger: Optional[ZooTrigger] = None,
              checkpoint_trigger: Optional[ZooTrigger] = None,
              validation_set: Optional[FeatureSet] = None,
              validation_trigger: Optional[ZooTrigger] = None,
              max_epoch: Optional[int] = None) -> TrainRecord:
        """Train until ``end_trigger`` (``max_epoch`` or one epoch by
        default), checkpointing on ``checkpoint_trigger`` (or the one
        :attr:`checkpoint_trigger` holds) into :attr:`checkpoint_dir`,
        and validating on ``validation_set`` on ``validation_trigger``
        (each epoch by default)."""
        self.ensure_initialized()
        accum = self._grad_accum_steps()
        if batch_size % accum != 0:
            raise ValueError(
                f"grad_accum_steps={accum} must divide batch_size="
                f"{batch_size}: each batch is split into equal "
                f"microbatches")
        end_trigger = end_trigger or MaxEpoch(max_epoch or 1)
        checkpoint_trigger = checkpoint_trigger or self.checkpoint_trigger
        if checkpoint_trigger is not None:
            if self.checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_trigger set but no checkpoint dir; call "
                    "set_checkpoint(path) first (parity: setCheckpoint)")
        validation_trigger = validation_trigger or (
            EveryEpoch() if validation_set is not None else None)
        self._maybe_auto_resume()
        cfg = self.ctx.config
        if getattr(cfg, "health_monitor", False):
            from .health import HealthMonitor
            self._health = HealthMonitor(
                z_threshold=getattr(cfg, "health_z_threshold", 6.0),
                warmup_windows=getattr(cfg, "health_warmup_windows", 5),
                halt=getattr(cfg, "health_halt", False))
            self._first_bad = None
        self._profiler = ProfilerHook(cfg.profile_dir, cfg.profile_start_step,
                                      cfg.profile_num_steps) \
            if getattr(cfg, "profile_dir", None) else None
        record = TrainRecord(epoch=self.epoch, iteration=self.step)
        self._losses = []
        retries = 0
        max_retries = int(getattr(cfg, "failure_retry_times", 0))
        _ACTIVE_TRAINERS.add(self)
        try:
            while not end_trigger(record):
                try:
                    self._run_epoch(train_set, batch_size, record,
                                    checkpoint_trigger, validation_set,
                                    validation_trigger, end_trigger)
                except TrainingPreempted as e:
                    # a health halt leaves `latest` at the last good step
                    # (the drain's save is refused); clear the drain flag
                    # so a restore-and-resume in this process is not
                    # preempted at once
                    if isinstance(e, TrainingHalted):
                        clear_preemption()
                    self.wait_for_checkpoint()
                    telemetry.dump_flight(
                        f"TrainingPreempted @step {self.step}")
                    raise
                except (RuntimeError, faults.FaultInjected) as e:
                    # an allocation failure gets a memory post-mortem
                    # before the retry policy decides anything
                    memory.maybe_oom_forensics(
                        e, out_dir=getattr(cfg, "trace_dir", None))
                    retries += 1
                    # an in-flight async write may be the checkpoint to
                    # restore: land it first
                    try:
                        self.wait_for_checkpoint()
                    except Exception:  # noqa: BLE001 - the write failed
                        logger.warning("pending checkpoint write failed",
                                       exc_info=True)
                    has_ckpt = self.checkpoint_dir is not None and \
                        self.has_checkpoint(self.checkpoint_dir)
                    if retries > max_retries or not has_ckpt:
                        telemetry.dump_flight(
                            f"unhandled step exception @step {self.step}: "
                            f"{type(e).__name__}: {e}")
                        raise
                    logger.warning("step failed (%s); restoring latest "
                                   "checkpoint (retry %d/%d)", e, retries,
                                   max_retries)
                    self.load_checkpoint(self.checkpoint_dir)
                    record.epoch, record.iteration = self.epoch, self.step
        finally:
            _ACTIVE_TRAINERS.discard(self)
            if self._profiler is not None:
                self._profiler.close()
            self.step_losses = torch.stack(
                [l for _, l in self._losses]).tolist() if self._losses \
                else []
            self._losses = []
        # an async checkpoint still in flight is durable before train()
        # reports completion
        self.wait_for_checkpoint()
        return record

    def _maybe_auto_resume(self):
        """Resume from the latest checkpoint when asked
        (``ZOO_TPU_AUTO_RESUME=1`` or ``ZooConfig.auto_resume``) and the
        trainer has not stepped yet. Off by default: a plain ``fit()``
        into a directory holding old checkpoints stays a fresh run."""
        wants = getattr(self.ctx.config, "auto_resume", False) or \
            os.environ.get("ZOO_TPU_AUTO_RESUME", "0").lower() in (
                "1", "true", "yes", "on")
        if not wants or self.checkpoint_dir is None or self.step != 0:
            return
        if not self.has_checkpoint(self.checkpoint_dir):
            logger.info("auto-resume: no checkpoint in %s yet, fresh start",
                        self.checkpoint_dir)
            return
        self.load_checkpoint(self.checkpoint_dir)
        logger.info("auto-resume: restored step %d epoch %d (+%d batches) "
                    "from %s", self.step, self.epoch, self.epoch_batches,
                    self.checkpoint_dir)

    def _run_epoch(self, train_set, batch_size, record, checkpoint_trigger,
                   validation_set, validation_trigger, end_trigger):
        """One epoch through the staged pipeline (JAX's ``_run_epoch``):
        ``build_host_pipeline`` seeded ``seed + epoch`` and a
        ``DeviceStagingIterator`` over it, both closed when the epoch
        ends, however it ends."""
        stats_fn = getattr(train_set, "stats", None)
        monitor = InfeedMonitor(
            worker_provider=stats_fn().worker_busy_snapshot
            if callable(stats_fn) else None, scope="train")
        it = staging = None
        put_one = self._put_one
        host_batch = batch_size
        cap = None
        if self.world_size() > 1:
            if getattr(train_set, "num_processes", 1) > 1:
                # a dataset partitioned by process_topology(): each rank
                # reads its 1/dp of the global batch from its own part,
                # and every rank stops at the shortest part's last batch
                # (a rank that stepped alone would wait on its peers)
                if self.world_size() != self.axis_size("data"):
                    raise ValueError(
                        "a dataset partitioned by process needs a pure "
                        "data-parallel mesh (seq ranks share their rows)")
                host_batch = batch_size // self.axis_size("data")
                cap = self._fewest_batches(train_set, host_batch)
            else:
                # every rank reads the same global batch and keeps its
                # block of it
                put_one = lambda b: self._put_one(self._rank_block(b))  # noqa: E731
        try:
            it = build_host_pipeline(
                train_set, host_batch, shuffle=True, drop_remainder=True,
                seed=self.seed + record.epoch,
                transform_workers=getattr(self.ctx.config,
                                          "transform_workers", -1),
                prefetch_depth=getattr(self.ctx.config, "prefetch_depth", 2),
                infeed_backend=getattr(self.ctx.config, "infeed_backend",
                                       None))
            # mid-epoch resume: the epoch order is a function of (seed,
            # epoch), so skipping the batches the checkpoint had consumed
            # on the host iterator, before anything is staged, replays
            # the remaining order exactly
            if self.epoch_batches > 0:
                logger.info("resuming epoch %d mid-stream: skipping %d "
                            "consumed batch(es)", record.epoch,
                            self.epoch_batches)
                for _ in range(self.epoch_batches):
                    if next(it, None) is None:
                        break
            staging = DeviceStagingIterator(
                it if cap is None else itertools.islice(
                    it, max(cap - self.epoch_batches, 0)),
                put_one, self._put_stacked,
                depth=getattr(self.ctx.config, "device_ahead", 2),
                monitor=monitor)
            self._epoch_loop(staging, monitor, batch_size, record,
                             checkpoint_trigger, validation_set,
                             validation_trigger, end_trigger)
        finally:
            if staging is not None:
                staging.close()
            if it is not None:
                it.close()

    def _fewest_batches(self, train_set, host_batch: int) -> int:
        """The fewest full batches any rank's part of ``train_set`` holds
        (a MIN all-reduce over the world)."""
        import torch.distributed as dist

        n = torch.tensor([train_set.num_batches(host_batch, True)],
                         device=self.device)
        dist.all_reduce(n, op=dist.ReduceOp.MIN)
        return int(n.item())

    def _epoch_loop(self, staging, monitor, batch_size, record,
                    checkpoint_trigger, validation_set, validation_trigger,
                    end_trigger):
        cfg = self.ctx.config
        log_every = max(1, int(getattr(cfg, "log_every_n_steps", 50)))
        self._last_log_step = min(self._last_log_step, self.step)
        steps_ctr = telemetry.counter("zoo_train_steps_total")
        window_t0 = time.perf_counter()
        window_steps = 0
        n_batches = 0
        last_loss = None
        t0 = time.time()
        while True:
            if preemption_requested():
                telemetry.event("train/preempted", step=self.step)
                self._read_sentinel()
                self._raise_if_halted()
                if self.checkpoint_dir is not None:
                    self.save_checkpoint(self.checkpoint_dir)
                    self.wait_for_checkpoint()
                raise TrainingPreempted(
                    f"preemption notice honoured at step {self.step}"
                    + ("" if self.checkpoint_dir is None
                       else f": checkpoint saved to {self.checkpoint_dir}"))
            # the batch was staged while the previous step computed (the
            # host wait is timed into the monitor)
            chunk = staging.next_chunk(1)
            if chunk is None:
                break
            with span("train/step", step=self.step):
                # chaos harness: armed step:nan@N / grad:nan@N faults
                # poison this step's staged inputs or a parameter, driving
                # a real non-finite through the step for the sentinel
                dev = self._maybe_poison(self._staged(chunk.singles[0]))
                last_loss = self._observed("train", self.train_step, dev)
            self._losses.append((self.step, last_loss))
            self.epoch_batches += 1
            n_batches += 1
            window_steps += 1
            steps_ctr.inc()
            record.iteration = self.step
            record.epoch_finished = False
            # chaos harness: an armed step:raise@N / step:kill@N fires here
            faults.check("step", step=self.step)
            if self._profiler is not None:
                self._profiler.step(self.step)
            if self.step - self._last_log_step >= log_every:
                self._last_log_step = self.step
                now = time.perf_counter()
                self._log_window(record, last_loss, window_steps,
                                 max(now - window_t0, 1e-9), batch_size,
                                 monitor)
                window_t0 = now
                window_steps = 0
            if checkpoint_trigger is not None and checkpoint_trigger(record) \
                    and self._ckpt_allowed():
                self.save_checkpoint(self.checkpoint_dir)
            if validation_trigger is not None and validation_trigger(record):
                self._run_validation(validation_set, batch_size, record)
            if end_trigger is not None and end_trigger(record):
                break  # per-iteration end check (parity: endWhen)
        if last_loss is not None:
            record.loss = float(last_loss)
        # a halt latched here, or at a read after the epoch's last window
        # or save, has no next iteration to honour it: raise now
        self._read_sentinel()
        self._raise_if_halted()
        self.epoch += 1
        self.epoch_batches = 0
        record.epoch = self.epoch
        record.epoch_finished = True
        dur = time.time() - t0
        if self.is_rank0():
            logger.info("epoch %d done: %d iterations in %.1fs (%.1f "
                        "samples/s)", record.epoch, n_batches, dur,
                        n_batches * batch_size / max(dur, 1e-9))
        if validation_trigger is not None and validation_trigger(record):
            self._run_validation(validation_set, batch_size, record)
        if checkpoint_trigger is not None and checkpoint_trigger(record) \
                and self._ckpt_allowed():
            self.save_checkpoint(self.checkpoint_dir)

    def _log_window(self, record, last_loss, steps, wall, batch_size,
                    monitor):
        """The host reads of a logging window — the last step's loss and
        the health sentinel — and the TrainSummary scalars (JAX's
        ``_epoch_loop`` :1384-1459)."""
        cfg = self.ctx.config
        with span("train/device_sync", step=self.step):
            loss_v = float(last_loss)
        self._read_sentinel()
        record.loss = loss_v
        lr = float(self.lr_schedule(self.step))
        with span("train/metric_fetch", step=self.step):
            infeed = monitor.window(steps, wall)
        telemetry.gauge("zoo_train_loss").set(loss_v)
        telemetry.gauge("zoo_train_learning_rate").set(lr)
        gnorm_v = float(self._last_gnorm) if self._last_gnorm is not None \
            and getattr(cfg, "log_grad_norm", False) else None
        if self._health is not None and (
                not self._health.halted
                or self.step <= self._health.halt_step):
            # EWMA z-score spike detection on the window scalars (and a
            # host-side non-finite backstop). A window past a halted
            # run's bad step ran only because the sentinel is read late:
            # it is not observed (JAX stops at the bad step)
            self._health.observe_window(
                self.step, loss=loss_v, grad_norm=gnorm_v,
                step_time_ms=infeed["step_time_ms"])
        if getattr(cfg, "memory_accounting", True):
            # the card's allocator statistics (None on the CPU); latches
            # an OOM-forensics dump past hbm_watermark_fraction
            memory.poll_device_memory(
                [self.device],
                watermark_fraction=getattr(cfg, "hbm_watermark_fraction",
                                           0.0),
                out_dir=getattr(cfg, "trace_dir", None))
        # only rank 0 writes logs and summaries (JAX :1680)
        summary = self.train_summary if self.is_rank0() else None
        if summary is not None:
            summary.add_scalar("Loss", loss_v, self.step)
            summary.add_scalar("LearningRate", lr, self.step)
            if gnorm_v is not None:
                summary.add_scalar("GradNorm", gnorm_v, self.step)
            if self._health is not None:
                summary.add_scalar("HealthState", float(self._health.state),
                                   self.step)
            if self.hbm_breakdown is not None:
                bd = self.hbm_breakdown
                mib = 1.0 / 2**20
                summary.add_scalar("HBMTotalMB", bd["total_bytes"] * mib,
                                   self.step)
                summary.add_scalar("HBMParamsMB", bd["params_bytes"] * mib,
                                   self.step)
                summary.add_scalar("HBMOptStateMB",
                                   bd["opt_state_bytes"] * mib, self.step)
                summary.add_scalar("HBMActivationsMB",
                                   bd["activations_temp_bytes"] * mib,
                                   self.step)
                summary.add_scalar("HBMTransfersMB",
                                   bd["transfers_bytes"] * mib, self.step)
            summary.add_scalar("Throughput", steps * batch_size / wall,
                               self.step)
            summary.add_scalar("StepTimeMs", infeed["step_time_ms"],
                               self.step)
            summary.add_scalar("InfeedWaitMs",
                               infeed["input_wait_ms_per_step"], self.step)
            summary.add_scalar("InputBoundFraction",
                               infeed["input_bound_fraction"], self.step)
            if "infeed_workers" in infeed:
                summary.add_scalar("InfeedWorkers", infeed["infeed_workers"],
                                   self.step)
                summary.add_scalar("InfeedWorkerUtilization",
                                   infeed["infeed_worker_utilization"],
                                   self.step)
            if self.flops_per_step:
                peak = peak_flops(device_kind(self.device))
                if peak:
                    summary.add_scalar(
                        "MFU", self.flops_per_step * steps / wall / peak,
                        self.step)
        if self.is_rank0():
            logger.info("epoch %d step %d loss %.5f", record.epoch,
                        self.step, loss_v)

    def _run_validation(self, validation_set, batch_size, record):
        results = self.evaluate(validation_set, batch_size)
        record.score = next(iter(results.values())) if results else None
        if self.val_summary is not None and self.is_rank0():
            for name, value in results.items():
                self.val_summary.add_scalar(name, value, self.step)
        logger.info("validation @%d: %s", self.step, results)
        return results

    def _inference_pipeline(self, data, batch_size, monitor):
        """The staged pipeline of ``evaluate``/``predict`` (JAX's
        ``_inference_pipeline``): in order, the last batch padded with
        zero-weight rows (each chunk's ``real_counts`` unpads it). Over
        several ranks each data rank stages its block of every batch
        (``_rank_block``, JAX's ``P("data")`` batch sharding)."""
        cfg = self.ctx.config
        it = build_host_pipeline(
            data, batch_size, shuffle=False, drop_remainder=False,
            pad_remainder=True,
            transform_workers=getattr(cfg, "transform_workers", -1),
            prefetch_depth=getattr(cfg, "prefetch_depth", 2))
        put_one = self._put_one
        if self.world_size() > 1:
            put_one = lambda b: self._put_one(self._rank_block(b))  # noqa: E731
        return it, DeviceStagingIterator(
            it, put_one, self._put_stacked,
            depth=getattr(cfg, "device_ahead", 2), monitor=monitor)

    def _emit_inference_stats(self, kind, monitor, n_batches, n_samples,
                              wall_s):
        """The Eval* / Predict* scalars of one run (no fused dispatch in
        the port: ``FusedDispatches`` is 0); Eval* also into the
        ValidationSummary."""
        stats = inference_window(monitor, n_batches, n_samples, wall_s, 0,
                                 kind)
        if kind == "Eval" and self.val_summary is not None and \
                self.is_rank0():
            for name, value in stats.items():
                self.val_summary.add_scalar(name, value, self.step)
        logger.info("%s: %.1f samples/s (%d batches, input-bound %.3f)",
                    kind.lower(), stats[f"{kind}Throughput"], n_batches,
                    stats[f"{kind}InputBoundFraction"])
        return stats

    def evaluate(self, data: FeatureSet, batch_size: int) -> Dict[str, float]:
        """Metric means over ``data``: each batch's (num, den) partial sums
        accumulate on the device and are fetched once. The last batch is
        padded with zero-weight rows, as in the JAX trainer. Over several
        ranks each data rank runs its block of each batch and the partial
        sums are all-reduced over the data group. The run's Eval* scalars
        land in :attr:`last_eval_stats`."""
        self.ensure_initialized()
        acc: Dict[str, Any] = {}
        monitor = InfeedMonitor(scope="eval")
        n_batches = n_samples = 0
        t0 = time.perf_counter()

        def batch_stats(dev):
            _, y, w = dev
            stats = {}
            if y is not None:
                loss, preds = self._loss_and_preds(dev, None, False)
                for m in self.metrics:
                    stats[m.name] = m.batch_stats(preds, y, w)
                wsum = w.sum()
                stats["loss"] = (loss * wsum, wsum)
            return stats

        it, staging = self._inference_pipeline(data, batch_size, monitor)
        try:
            with torch.no_grad():
                while True:
                    chunk = staging.next_chunk(1)
                    if chunk is None:
                        break
                    with span("eval/dispatch"):
                        stats = self._observed(
                            "eval", batch_stats,
                            self._staged(chunk.singles[0]))
                    n_samples += chunk.real_counts[0]
                    n_batches += 1
                    for name, (num, den) in stats.items():
                        if name in acc:
                            acc[name] = (acc[name][0] + num,
                                         acc[name][1] + den)
                        else:
                            acc[name] = (num, den)
        finally:
            staging.close()
            it.close()
        if not acc:
            raise ValueError("evaluate() got an empty dataset or one "
                             "without labels")
        data_group = self._group("data")
        with span("eval/device_sync"):
            host = {k: tuple(collectives.all_reduce(t, data_group).cpu()
                             .numpy() for t in (n, d))
                    for k, (n, d) in acc.items()}
        self.last_eval_stats = self._emit_inference_stats(
            "Eval", monitor, n_batches, n_samples, time.perf_counter() - t0)
        out = {m.name: m.finalize(*host[m.name]) for m in self.metrics}
        num, den = host["loss"]
        out["loss"] = float(num / max(den, 1e-12))
        return out

    def predict(self, data, batch_size: int = 128):
        """The model's outputs over ``data`` (a ``FeatureSet``, or an array
        or list of arrays) as float32 numpy, in batches of
        ``batch_size``: the last batch padded to full size and the padding
        cut off on the device, one host transfer at the end (the JAX
        trainer's ``predict``). Over several ranks each data rank runs its
        block of each batch and the rows are all-gathered over the data
        group, so every rank returns them all, in order. None for an empty
        dataset. The run's Predict* scalars land in
        :attr:`last_predict_stats`."""
        if not isinstance(data, FeatureSet):
            data = ArrayFeatureSet(data)
        self.model.to(self.device)
        self._install_layout()
        data_group = self._group("data")
        chunks: List[Any] = []
        monitor = InfeedMonitor(scope="predict")
        n_samples = 0
        t0 = time.perf_counter()

        def forward(xs):
            return self._forward(xs, None, False)

        it, staging = self._inference_pipeline(data, batch_size, monitor)
        try:
            with torch.inference_mode():
                while True:
                    chunk = staging.next_chunk(1)
                    if chunk is None:
                        break
                    xs, _, _ = self._staged(chunk.singles[0])
                    real = chunk.real_counts[0]
                    n_samples += real
                    with span("predict/dispatch"):
                        out = self._observed("predict", forward, xs)
                    if data_group is not None:
                        out = [collectives.all_gather(o, data_group)
                               for o in out] if isinstance(
                            out, (list, tuple)) else \
                            collectives.all_gather(out, data_group)
                    chunks.append([o[:real] for o in out]
                                  if isinstance(out, (list, tuple))
                                  else out[:real])
        finally:
            staging.close()
            it.close()
        if not chunks:
            return None
        # detached: an output that is a parameter's view (a CRF's
        # transitions, a ParameterLayer) keeps its requires_grad
        if isinstance(chunks[0], list):
            result = [torch.cat([c[i] for c in chunks]).detach().cpu()
                      .numpy() for i in range(len(chunks[0]))]
        else:
            result = torch.cat(chunks).detach().cpu().numpy()
        self.last_predict_stats = self._emit_inference_stats(
            "Predict", monitor, len(chunks), n_samples,
            time.perf_counter() - t0)
        return result

    # ------------------------------------------------------------------
    # checkpoint store (flat v2)
    # ------------------------------------------------------------------
    @staticmethod
    def _store_candidates(directory: str) -> List[Tuple[str, Dict]]:
        """Valid (manifest-bearing) checkpoint dirs, newest first; a dir
        without a manifest is an aborted write and never a candidate."""
        try:
            entries = file_io.listdir(directory)
        except OSError:
            return []
        out = []
        for name in entries:
            if not name.startswith(SPMDTrainer.CKPT_PREFIX):
                continue
            mpath = os.path.join(directory, name, "manifest.json")
            try:
                manifest = json.loads(file_io.read_bytes(mpath).decode())
            except (OSError, ValueError):
                continue
            out.append((name, manifest))
        out.sort(key=lambda t: -int(t[1].get("step", -1)))
        return out

    def has_checkpoint(self, directory: str) -> bool:
        return bool(self._store_candidates(directory)) or \
            file_io.exists(os.path.join(directory, "model.npz")) or \
            self._sharded_available(directory)

    @staticmethod
    def _sharded_available(directory: str) -> bool:
        tag = sharded_checkpoint.read_commit(directory)
        return sharded_checkpoint.exists(directory, "params", tag)

    @staticmethod
    def _write_flat_checkpoint(directory, params_np, state_np, opt_leaves,
                               meta, keep=3, stats=None):
        """Serialize and publish one checkpoint from host snapshots (no
        trainer state touched, so it runs on the writer thread too). The
        files land in ``ckpt-<step>/``; the manifest of checksums is
        written last by tmp + rename, then the ``latest`` pointer: a
        crash at any earlier point leaves this save invisible. ``stats``
        (a dict) receives the bytes and the seconds of each phase."""
        stats = {} if stats is None else stats
        step = int(meta["step"])
        sub = f"{SPMDTrainer.CKPT_PREFIX}{step}"
        base = os.path.join(directory, sub)
        with span("ckpt/write", step=step):
            t0 = time.perf_counter()
            model_data, model_tdef = serialization.pytree_bytes(
                {"params": params_np, "state": state_np})
            optim_data = serialization.leaves_bytes(opt_leaves)
            meta_data, meta_tdef = serialization.pytree_bytes(meta)
            files = (("model.npz", model_data),
                     ("optim.npz", optim_data),
                     ("meta.npz", meta_data),
                     ("model.npz.treedef", model_tdef),
                     ("meta.npz.treedef", meta_tdef))
            t1 = time.perf_counter()
            sums = {fname: {"crc32c": crc32c(data), "size": len(data)}
                    for fname, data in files}
            t2 = time.perf_counter()
            file_io.makedirs(base)
            for fname, data in files:
                faults.checked_write(os.path.join(base, fname), data,
                                     file_io.write_bytes)
            manifest = {"format": "flat-v2", "step": step,
                        "epoch": int(meta["epoch"]), "files": sums}
            file_io.write_bytes_atomic(os.path.join(base, "manifest.json"),
                                       json.dumps(manifest).encode())
            file_io.write_bytes_atomic(
                os.path.join(directory, SPMDTrainer.LATEST_FILE),
                sub.encode())
            t3 = time.perf_counter()
            SPMDTrainer._prune_checkpoints(directory, keep)
        stats.update(bytes=sum(len(d) for _, d in files), serialize_s=t1 - t0,
                     crc32c_s=t2 - t1, write_s=t3 - t2)
        telemetry.counter("zoo_checkpoint_writes_total").inc()
        logger.info("checkpoint saved to %s @step %d", base, step)
        return stats

    @staticmethod
    def _prune_checkpoints(directory: str, keep: int):
        """Keep-last-k retention: drop valid checkpoints beyond the newest
        ``keep``, and aborted (manifest-less) dirs older than the newest
        valid step (never one a writer could still be filling)."""
        if keep <= 0:
            return
        valid = SPMDTrainer._store_candidates(directory)
        if not valid:
            return
        newest_step = int(valid[0][1].get("step", -1))
        doomed = [name for name, _ in valid[keep:]]
        valid_names = {name for name, _ in valid}
        try:
            entries = file_io.listdir(directory)
        except OSError:
            entries = []
        for name in entries:
            if not name.startswith(SPMDTrainer.CKPT_PREFIX) \
                    or name in valid_names:
                continue
            try:
                step = int(name[len(SPMDTrainer.CKPT_PREFIX):])
            except ValueError:
                continue
            if step < newest_step:
                doomed.append(name)
        for name in doomed:
            try:
                file_io.remove_tree(os.path.join(directory, name))
            except OSError:
                logger.debug("retention prune of %s failed", name,
                             exc_info=True)

    @staticmethod
    def _host_rng_capture() -> Dict[str, np.ndarray]:
        """The numpy global RNG (host-side augmentation draws from it), so
        a resumed run continues the same stream."""
        alg, keys, pos, has_gauss, cached = np.random.get_state(
            legacy=True)
        return {"rng_alg": np.asarray(alg),
                "rng_keys": np.asarray(keys),
                "rng_pos": np.asarray(pos),
                "rng_has_gauss": np.asarray(has_gauss),
                "rng_cached": np.asarray(cached)}

    @staticmethod
    def _host_rng_restore(meta) -> None:
        if "rng_keys" not in meta:
            return
        np.random.set_state((str(meta["rng_alg"]),
                             np.asarray(meta["rng_keys"]),
                             int(meta["rng_pos"]),
                             int(meta["rng_has_gauss"]),
                             float(meta["rng_cached"])))

    def _train_position_meta(self) -> Dict[str, np.ndarray]:
        meta = {"step": np.asarray(self.step),
                "epoch": np.asarray(self.epoch),
                "epoch_batches": np.asarray(self.epoch_batches),
                "seed": np.asarray(self.seed)}
        meta.update(self._host_rng_capture())
        return meta

    def _restore_position(self, meta) -> None:
        self.step = int(meta["step"])
        self.epoch = int(meta["epoch"])
        self.epoch_batches = int(meta.get("epoch_batches", 0))
        self._host_rng_restore(meta)
        # the losses of steps past the restored one are undone, and the
        # next summary window starts here
        self._losses = [(s, l) for s, l in self._losses if s <= self.step]
        self._last_log_step = self.step

    def _flat_snapshot(self, opt_state=None):
        """Owned host copies of the trainer state: (params tree, state
        tree, optimizer leaves, meta); ``opt_state`` is the canonical
        optimizer state (the trainer's own by default). On the GPU each
        tensor is copied into a pinned host buffer kept from the last
        save (the previous write has finished with it: ``save_checkpoint``
        waits for it first), and the copies are complete when this
        returns, so the next step's in-place update cannot reach them."""
        params, state = self.model.param_tree(), self.model.state_tree()
        leaves = optimizer_leaves(
            self.opt_state if opt_state is None else opt_state,
            param_order(self.model))
        tensors: List[torch.Tensor] = []

        def collect(tree):
            if isinstance(tree, dict):
                return {k: collect(v) for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                tensors.append(tree)
                return len(tensors) - 1
            return tree

        params_idx, state_idx = collect(params), collect(state)
        leaves_idx = [collect(l) for l in leaves]
        pinned = self.device.type == "cuda"
        bufs = self._snapshot_buffers
        if len(bufs) != len(tensors) or any(
                b.shape != t.shape or b.dtype != t.dtype
                for b, t in zip(bufs, tensors)):
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
                    for t in tensors]
            self._snapshot_buffers = bufs
        with torch.no_grad():
            for b, t in zip(bufs, tensors):
                b.copy_(t.detach(), non_blocking=pinned)
        if pinned:
            torch.cuda.synchronize(self.device)
        host = [b.numpy() for b in bufs]

        def resolve(tree):
            if isinstance(tree, dict):
                return {k: resolve(v) for k, v in tree.items()}
            return host[tree] if isinstance(tree, int) else tree

        opt_np = [host[i] if isinstance(i, int) else i for i in leaves_idx]
        return (resolve(params_idx), resolve(state_idx), opt_np,
                self._train_position_meta())

    def wait_for_checkpoint(self):
        """Join a pending async checkpoint write; re-raises its error."""
        fut, self._ckpt_future = self._ckpt_future, None
        if fut is not None:
            fut.result()

    def save_checkpoint(self, directory: Optional[str] = None):
        """Write the trainer state to ``directory`` (the checkpoint dir by
        default) as ``ckpt-<step>/``; on a background thread when
        ``ZooConfig.async_checkpoint`` is set (the snapshot stays
        synchronous)."""
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise ValueError("no checkpoint dir set")
        self.ensure_initialized()
        t0 = time.perf_counter()
        # one writer at a time per trainer, and the snapshot buffers are
        # the previous write's until it has finished
        self.wait_for_checkpoint()
        if _sharded_format() or self.shards:
            # a layout over the mesh always writes the sharded format:
            # each rank its own blocks, no leaf gathered to save it
            with span("ckpt/write", step=self.step, format="sharded"):
                self._save_checkpoint_sharded(directory)
            telemetry.counter("zoo_checkpoint_writes_total").inc()
            return
        if self.world_size() > 1:
            # every rank gathers the canonical optimizer state (ZeRO's
            # all-gather), rank 0 alone writes, and no rank leaves before
            # the files are committed (JAX :2026)
            opt = self.canonical_opt_state()
            if self.is_rank0():
                faults.begin_save()
                snapshot = self._flat_snapshot(opt)
                stats = {"step": self.step}
                self.checkpoint_stats.append(stats)
                self._write_flat_checkpoint(
                    directory, *snapshot,
                    int(getattr(self.ctx.config, "keep_checkpoints", 3)),
                    stats)
            collectives.barrier()
            return
        faults.begin_save()
        keep = int(getattr(self.ctx.config, "keep_checkpoints", 3))
        t1 = time.perf_counter()
        with span("ckpt/snapshot", step=self.step):
            snapshot = self._flat_snapshot()
        t2 = time.perf_counter()
        stats = {"step": self.step, "wait_s": t1 - t0, "snapshot_s": t2 - t1}
        self.checkpoint_stats.append(stats)
        if getattr(self.ctx.config, "async_checkpoint", False):
            self._ckpt_future = _checkpoint_writer_pool().submit(
                self._write_flat_checkpoint, directory, *snapshot, keep,
                stats)
        else:
            self._write_flat_checkpoint(directory, *snapshot, keep, stats)
        stats["stall_s"] = time.perf_counter() - t0

    def load_checkpoint(self, directory: str):
        """Restore the newest checkpoint of ``directory`` whose files pass
        their checksums (a corrupt one is logged and skipped), or the
        legacy layout of model.npz / optim.npz / meta.npz in the root.
        The tensors land on the trainer's device; a file written by
        another model instance or by the JAX package pairs its layer
        names with this model's (``utils/jax_weights.py``)."""
        t0 = time.perf_counter()
        self.wait_for_checkpoint()
        self.ensure_initialized()
        # the writer (rank 0) must have finished before anyone reads
        collectives.barrier()
        candidates = self._store_candidates(directory)
        if not candidates and self._sharded_available(directory) and \
                not file_io.exists(os.path.join(directory, "model.npz")):
            self._load_checkpoint_sharded(directory)
            self.last_load_s = time.perf_counter() - t0
            return
        if candidates:
            skipped = []
            for name, manifest in candidates:
                try:
                    self._load_flat_from(directory, name, manifest)
                except (ChecksumError, OSError, ValueError) as e:
                    logger.warning("checkpoint %s unusable (%s); falling "
                                   "back to previous", name, e)
                    skipped.append(name)
                    continue
                if skipped:
                    logger.warning("restored %s after skipping corrupt "
                                   "checkpoint(s): %s", name,
                                   ", ".join(skipped))
                logger.info("restored %s from %s @step %d", name, directory,
                            self.step)
                self.last_load_s = time.perf_counter() - t0
                return
            raise ChecksumError(
                f"all {len(candidates)} checkpoint(s) in {directory} "
                f"failed validation: {', '.join(n for n, _ in candidates)}")
        # the legacy layout: the flat files in the directory itself
        blob = serialization.load_pytree(os.path.join(directory,
                                                      "model.npz"))
        opt_path = os.path.join(directory, "optim.npz")
        leaves = serialization.load_leaves(opt_path) \
            if file_io.exists(opt_path) else None
        meta = serialization.load_pytree(os.path.join(directory, "meta.npz"))
        self._apply_loaded(blob, leaves, meta)
        self.last_load_s = time.perf_counter() - t0

    def _load_flat_from(self, directory: str, name: str,
                        manifest: Dict) -> None:
        """Restore from one checkpoint dir, checking every file's bytes
        against the manifest before any trainer state is touched."""
        base = os.path.join(directory, name)
        blobs = {}
        for fname, info in manifest["files"].items():
            data = file_io.read_bytes(os.path.join(base, fname))
            if len(data) != int(info["size"]) \
                    or crc32c(data) != int(info["crc32c"]):
                raise ChecksumError(
                    f"{name}/{fname}: crc32c/size mismatch "
                    f"(expected {info['crc32c']}/{info['size']}, got "
                    f"{crc32c(data)}/{len(data)})")
            blobs[fname] = data
        blob = serialization.pytree_from_bytes(
            blobs["model.npz"], blobs["model.npz.treedef"])
        meta = serialization.pytree_from_bytes(
            blobs["meta.npz"], blobs["meta.npz.treedef"])
        leaves = serialization.leaves_from_bytes(blobs["optim.npz"])
        self._apply_loaded(blob, leaves, meta)

    def _apply_loaded(self, blob, leaves, meta) -> None:
        params, state = blob["params"], blob.get("state") or {}
        # the pairing, the optimizer leaves' count and shapes are checked
        # before anything is copied; the file holds the canonical
        # (parameter-shaped) optimizer state, which ZeRO-1 re-shards onto
        # this run's dp degree
        order = param_order(self.model, names=list(params))
        flat = self.zero_mode() == "flat"
        target = self.opt_state
        if leaves is not None and flat:
            with torch.no_grad():
                target = self.tx.init(self.params())
        if leaves is not None and (self.shards or self._zero_dims):
            # whole leaves from the file: this rank's blocks of them
            paths = optimizer_leaf_params(target, order)
            live = optimizer_leaves(target, order)
            leaves = [leaf if path is None else self._block_of_whole(
                path, np.asarray(leaf), tuple(have.shape))
                for leaf, path, have in zip(leaves, paths, live)]
        if leaves is not None:
            check_optimizer_leaves(target, leaves, order)
        load_jax_params(self.model, params, state)
        if leaves is not None:
            target = load_optimizer_leaves(target, leaves, order)
            self.opt_state = zero.shard_opt_state(
                target, self._zero_layout, self.mesh.group("data")) \
                if flat else target
        self._restore_position(meta)

    # -- the sharded format (utils/sharded_checkpoint.py, JAX :1691) ----
    _SHARDED_GROUPS = ("params", "state", "optim")

    def _regions(self, path: Optional[str], shape) -> Tuple[list, bool]:
        """(this rank's [(region of the whole leaf, slices of its
        tensor)], whether it writes them) for a tensor of ``shape`` that
        mirrors parameter ``path`` (the parameter, or a moment; None for
        a leaf that mirrors none, which rank 0 writes whole). A moment
        gspmd cuts over data takes its data block of the parameter's
        regions."""
        p = self.params().get(path) if path is not None else None
        shard = self.shards.get(path) if path is not None else None
        whole = sharding.full_shape(p) if p is not None else tuple(shape)
        if shard is not None:
            regions = [(list(r), list(sl)) for r, sl in shard.regions()]
            replicas = set(shard.replica_axes())
        else:
            regions = [([(0, d) for d in whole],
                        [slice(0, d) for d in whole])]
            replicas = {a for a in sharding.AXES
                        if self.axis_size(a) > 1}
        dims = self._zero_dims.dims if self._zero_dims is not None else {}
        if path in dims and tuple(shape) != tuple(p.shape):
            w = dims[path]
            b = shape[w]
            c = self.mesh.index("data")
            for region, sl in regions:
                region[w] = (c * b, (c + 1) * b)
                sl[w] = slice(0, b)
            replicas.discard("data")
        writer = all(self.mesh.index(a) == 0 for a in replicas)
        return [(r, tuple(sl)) for r, sl in regions], writer

    def _block_of_whole(self, path, whole: np.ndarray, shape):
        """This rank's tensor of ``shape`` (mirroring ``path``) cut out
        of the whole leaf ``whole``."""
        out = np.empty(shape, whole.dtype)
        for region, sl in self._regions(path, shape)[0]:
            out[sl] = whole[tuple(slice(a, b) for a, b in region)]
        return out

    def _sharded_leaves(self, opt_state):
        """Each group's leaves in the JAX trees' order (dict keys sorted,
        as ``jax.tree_util.tree_leaves`` gives them), each as (tensor or
        value, the parameter path it mirrors or None, the whole leaf's
        shape)."""
        order = param_order(self.model)
        params = self.params()
        groups = {"params": [(params[k], k, sharding.full_shape(params[k]))
                             for k in order]}
        groups["state"] = [(t, None, tuple(t.shape)) for t in
                           _sorted_leaves(self.model.state_tree())]
        optim = []
        for leaf, path in zip(optimizer_leaves(opt_state, order),
                              optimizer_leaf_params(opt_state, order)):
            whole = sharding.full_shape(params[path]) if path is not None \
                else tuple(np.shape(leaf))
            optim.append((leaf, path, whole))
        groups["optim"] = optim
        return groups

    def _save_checkpoint_sharded(self, directory: str) -> None:
        """JAX's ``_save_checkpoint_sharded``: every rank writes its shard
        file of each group (its regions of each leaf laid out over the
        mesh, as the first of the ranks holding a block; the replicated
        leaves out of rank 0), a barrier, then rank 0 writes the
        manifests, the meta, the commit and removes stale files. Every
        file of a save carries its step's tag, so the save becomes
        visible only at the commit. Under flat ZeRO-1 the optimizer state
        is written in its canonical (parameter-shaped) form."""
        opt = self.canonical_opt_state() if self.zero_mode() == "flat" \
            else self.opt_state
        tag = f"s{self.step}"
        faults.begin_save()
        groups = self._sharded_leaves(opt)
        described = {}
        for name in self._SHARDED_GROUPS:
            pieces, descs = [], []
            for li, (leaf, path, whole) in enumerate(groups[name]):
                arr = np.array(leaf.detach().cpu()) if isinstance(
                    leaf, torch.Tensor) else np.asarray(leaf)
                descs.append(_LeafDesc(whole, arr.dtype))
                regions, writer = self._regions(path, arr.shape)
                if writer:
                    pieces += [(li, region, arr[sl])
                               for region, sl in regions]
            described[name] = descs
            sharded_checkpoint.save_shards(directory, name, [], tag=tag,
                                           pieces=pieces)
        # every shard file exists before a manifest names it
        collectives.barrier()
        if self.is_rank0():
            for name in self._SHARDED_GROUPS:
                sharded_checkpoint.write_manifest(directory, name,
                                                  described[name], tag=tag)
            serialization.save_pytree(
                os.path.join(directory, f"meta.{tag}.npz"),
                self._train_position_meta())
            sharded_checkpoint.write_commit(directory, tag)
            sharded_checkpoint.gc_stale(directory,
                                        list(self._SHARDED_GROUPS), tag)
            try:
                entries = file_io.listdir(directory)
            except OSError:
                entries = []
            for fname in entries:
                if fname.startswith("meta.s") and \
                        not fname.startswith(f"meta.{tag}."):
                    try:
                        file_io.remove(os.path.join(directory, fname))
                    except OSError:
                        pass
            logger.info("sharded checkpoint saved to %s @step %d",
                        directory, self.step)
        collectives.barrier()

    def _load_checkpoint_sharded(self, directory: str) -> None:
        """Restore the committed sharded set (a resharding load): each
        leaf's regions this rank holds are assembled from whatever pieces
        the writer's layout saved, never the whole of a leaf laid out
        over the mesh, and copied into this rank's parameters, state
        buffers and optimizer state; under flat ZeRO-1 the canonical
        optimizer state is read whole and re-sharded."""
        tag = sharded_checkpoint.read_commit(directory)
        flat = self.zero_mode() == "flat"
        if flat:
            with torch.no_grad():
                target = self.tx.init(self.params())
        else:
            target = self.opt_state
        groups = self._sharded_leaves(target)
        if not groups["state"] or not sharded_checkpoint.exists(
                directory, "state", tag):
            groups.pop("state")
        loaded = {}
        for name, leaves in groups.items():
            wanted, shapes, dtypes, slices = [], [], [], []
            for leaf, path, whole in leaves:
                shape = tuple(np.shape(leaf))
                regions, _ = self._regions(path, shape)
                wanted.append([r for r, _ in regions])
                slices.append((shape, [sl for _, sl in regions]))
                shapes.append(whole)
                dtypes.append(_np_dtype(leaf))
            got = sharded_checkpoint.load_regions(
                directory, name, wanted, dtypes=dtypes, tag=tag,
                shapes=shapes)
            arrays = []
            for (shape, sls), parts, dt in zip(slices, got, dtypes):
                out = np.empty(shape, dt)
                for sl, part in zip(sls, parts):
                    out[sl] = part
                arrays.append(out)
            loaded[name] = arrays
        with torch.no_grad():
            for (p, _, _), arr in zip(groups["params"], loaded["params"]):
                p.copy_(torch.from_numpy(arr).to(device=p.device,
                                                 dtype=p.dtype))
            for (t, _, _), arr in zip(groups.get("state", ()),
                                      loaded.get("state", ())):
                t.copy_(torch.from_numpy(arr).to(device=t.device,
                                                 dtype=t.dtype))
        order = param_order(self.model)
        target = load_optimizer_leaves(target, loaded["optim"], order)
        self.opt_state = zero.shard_opt_state(
            target, self._zero_layout, self.mesh.group("data")) \
            if flat else target
        meta_name = "meta.npz" if tag is None else f"meta.{tag}.npz"
        meta = serialization.load_pytree(os.path.join(directory, meta_name))
        self._restore_position(meta)


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype of a tensor or a value."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


class _LeafDesc:
    """A leaf's whole shape and dtype, what a manifest records (rank 0
    holds only its block of a leaf laid out over the mesh)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
