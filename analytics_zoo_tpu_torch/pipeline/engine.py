"""Training engine on one device.

Counterpart of ``analytics_zoo_tpu/pipeline/engine.py`` (``SPMDTrainer``
:180, ``GradientClipping`` :147). The JAX trainer compiles one XLA program
per step over a device mesh; this one runs the step eagerly on one
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

Not ported: the sharded checkpoint format (``ZOO_TPU_SHARDED_CHECKPOINT``
raises, ROADMAP A12), the fused k-step dispatch (A2/A15), the health
monitor and the HBM, infeed and MFU scalars (A11/A13), ZeRO (A12).
"""

from __future__ import annotations

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
from ..utils import faults, file_io, serialization, telemetry
from ..utils.crc32c import crc32c
from ..utils.jax_weights import (check_optimizer_leaves, load_jax_params,
                                 load_optimizer_leaves, optimizer_leaves,
                                 param_order)
from ..utils.telemetry import span
from .api.keras.optimizers import global_norm

logger = logging.getLogger("analytics_zoo_tpu_torch.engine")

_MASK64 = (1 << 64) - 1


class TrainingPreempted(RuntimeError):
    """Raised out of ``train()`` after a preemption notice: the loop
    saved a final checkpoint (when it has a checkpoint directory) at the
    step boundary. Never retried by the failure-retry policy."""


class TrainingHalted(TrainingPreempted):
    """The JAX trainer's health-monitor halt; the port has no health
    monitor yet (ROADMAP A13), so nothing raises it."""


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


def _refuse_sharded() -> None:
    if os.environ.get("ZOO_TPU_SHARDED_CHECKPOINT", "0") == "1":
        raise NotImplementedError(
            "ZOO_TPU_SHARDED_CHECKPOINT=1: the sharded (per-process) "
            "checkpoint format is not ported yet; it arrives with the "
            "multi-GPU modes (ROADMAP A12)")


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

    def apply_with_norm(self, grads: Dict[str, torch.Tensor]):
        """Clip, and return the pre-clip global norm when L2-norm clipping
        computed one (else None)."""
        gnorm = None
        if self.l2_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.l2_norm / (gnorm + 1e-12), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        if self.min_value is not None or self.max_value is not None:
            lo = -np.inf if self.min_value is None else self.min_value
            hi = np.inf if self.max_value is None else self.max_value
            grads = {k: torch.clamp(g, lo, hi) for k, g in grads.items()}
        return grads, gnorm


class SPMDTrainer:
    """Trains ``model`` (a ``KerasNet``) on one device.

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
        if self.opt_state is None:
            with torch.no_grad():
                self.opt_state = self.tx.init(self.params())

    def put_batch(self, batch: MiniBatch):
        """A host (inputs, targets, weights) batch as tensors on the
        trainer's device."""
        xs, y, w = batch
        put = lambda a: None if a is None else as_device_tensor(a, self.device)
        ys = [put(t) for t in y] if isinstance(y, (list, tuple)) else put(y)
        return [put(x) for x in xs], ys, put(w)

    def _grad_accum_steps(self) -> int:
        return max(1, int(getattr(self.ctx.config, "grad_accum_steps", 1)
                          or 1))

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def _forward(self, xs, generator, training: bool):
        """The model's outputs on device inputs ``xs``, in the compute
        dtype, as float32."""
        if self.compute_dtype is None:
            preds = self.model(list(xs), training=training,
                               generator=generator)
        else:
            cast = {k: _cast_floating(p, self.compute_dtype)
                    for k, p in self.model.named_parameters()}
            preds = torch.func.functional_call(
                self.model, cast,
                (_cast_floating(list(xs), self.compute_dtype),),
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
        """Forward and backward of one device batch at the current step,
        without a parameter update: the loss, and each parameter's
        gradient left in its ``.grad`` (None where the loss does not reach
        it). A training forward updates the state buffers. With
        ``grad_accum_steps`` = k > 1 (training only) the batch runs as k
        equal microbatches (``_weighted_grad_sums``): each weighted-mean
        loss enters the backward scaled by its microbatch's weight mass
        over the batch's, so ``.grad`` sums to the batch's weighted-mean
        gradient, and the loss returned is the mass-weighted mean."""
        params = self.params()
        for p in params.values():
            p.grad = None
        accum = self._grad_accum_steps() if training else 1
        if accum == 1:
            gen = self.generator(self.step) if training else None
            loss, _ = self._loss_and_preds(batch, gen, training)
            loss.backward()
            return loss.detach()
        xs, _, w = batch
        n = xs[0].shape[0]
        if n % accum:
            raise ValueError(f"grad_accum_steps={accum} must divide the "
                             f"batch of {n}")
        size = n // accum
        masses = [w[i * size:(i + 1) * size].float().sum() if w is not None
                  else torch.tensor(float(size), device=self.device)
                  for i in range(accum)]
        total = torch.clamp(torch.stack(masses).sum(), min=1e-12)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            micro = self._microbatch(batch, i, size)
            loss, _ = self._loss_and_preds(micro, self.generator(self.step, i),
                                           True)
            (loss * (masses[i] / total)).backward()
            loss_sum = loss_sum + loss.detach() * masses[i]
        return loss_sum / total

    def train_step(self, batch) -> torch.Tensor:
        """One optimization step on a device batch (``_step_body``): fwd
        (which updates the state buffers), bwd, frozen masks, clipping,
        update. Returns the loss on the device (no host sync)."""
        loss = self.loss_and_grads(batch)
        params = self.params()
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None and
                     not self._frozen(k) else torch.zeros_like(p)
                     for k, p in params.items()}
            grads, self._last_gnorm = self.clipping.apply_with_norm(grads)
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     params)
            # frozen layers do not move at all: stateful transforms (Adam
            # moments from before the freeze, weight decay) still emit
            # nonzero updates for them, as in the JAX step
            for k, p in params.items():
                if not self._frozen(k):
                    p.add_(updates[k].to(p.dtype))
        self.step += 1
        return loss

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
            _refuse_sharded()
            if self.checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_trigger set but no checkpoint dir; call "
                    "set_checkpoint(path) first (parity: setCheckpoint)")
        validation_trigger = validation_trigger or (
            EveryEpoch() if validation_set is not None else None)
        self._maybe_auto_resume()
        record = TrainRecord(epoch=self.epoch, iteration=self.step)
        self._losses = []
        retries = 0
        max_retries = int(getattr(self.ctx.config, "failure_retry_times", 0))
        _ACTIVE_TRAINERS.add(self)
        try:
            while not end_trigger(record):
                try:
                    self._run_epoch(train_set, batch_size, record,
                                    checkpoint_trigger, validation_set,
                                    validation_trigger, end_trigger)
                except TrainingPreempted:
                    self.wait_for_checkpoint()
                    telemetry.dump_flight(
                        f"TrainingPreempted @step {self.step}")
                    raise
                except (RuntimeError, faults.FaultInjected) as e:
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
        it = iter(train_set.batches(batch_size, shuffle=True,
                                    drop_remainder=True,
                                    seed=self.seed + record.epoch))
        # mid-epoch resume: the epoch order is a function of (seed,
        # epoch), so skipping the batches the checkpoint had consumed
        # replays the remaining order exactly
        if self.epoch_batches > 0:
            logger.info("resuming epoch %d mid-stream: skipping %d "
                        "consumed batch(es)", record.epoch,
                        self.epoch_batches)
            for _ in range(self.epoch_batches):
                if next(it, None) is None:
                    break
        log_every = max(1, int(getattr(self.ctx.config, "log_every_n_steps",
                                       50)))
        self._last_log_step = min(self._last_log_step, self.step)
        window_t0 = time.perf_counter()
        window_steps = 0
        n_batches = 0
        last_loss = None
        t0 = time.time()
        while True:
            if preemption_requested():
                telemetry.event("train/preempted", step=self.step)
                if self.checkpoint_dir is not None:
                    self.save_checkpoint(self.checkpoint_dir)
                    self.wait_for_checkpoint()
                raise TrainingPreempted(
                    f"preemption notice honoured at step {self.step}"
                    + ("" if self.checkpoint_dir is None
                       else f": checkpoint saved to {self.checkpoint_dir}"))
            batch = next(it, None)
            if batch is None:
                break
            with span("train/step", step=self.step):
                last_loss = self.train_step(self.put_batch(batch))
            self._losses.append((self.step, last_loss))
            self.epoch_batches += 1
            n_batches += 1
            window_steps += 1
            record.iteration = self.step
            record.epoch_finished = False
            # chaos harness: an armed step:raise@N / step:kill@N fires here
            faults.check("step", step=self.step)
            if self.step - self._last_log_step >= log_every:
                self._last_log_step = self.step
                now = time.perf_counter()
                self._log_window(record, last_loss, window_steps,
                                 max(now - window_t0, 1e-9), batch_size)
                window_t0 = now
                window_steps = 0
            if checkpoint_trigger is not None and checkpoint_trigger(record):
                self.save_checkpoint(self.checkpoint_dir)
            if validation_trigger is not None and validation_trigger(record):
                self._run_validation(validation_set, batch_size, record)
            if end_trigger is not None and end_trigger(record):
                break  # per-iteration end check (parity: endWhen)
        if last_loss is not None:
            record.loss = float(last_loss)
        self.epoch += 1
        self.epoch_batches = 0
        record.epoch = self.epoch
        record.epoch_finished = True
        dur = time.time() - t0
        logger.info("epoch %d done: %d iterations in %.1fs (%.1f samples/s)",
                    record.epoch, n_batches, dur,
                    n_batches * batch_size / max(dur, 1e-9))
        if validation_trigger is not None and validation_trigger(record):
            self._run_validation(validation_set, batch_size, record)
        if checkpoint_trigger is not None and checkpoint_trigger(record):
            self.save_checkpoint(self.checkpoint_dir)

    def _log_window(self, record, last_loss, steps, wall, batch_size):
        """The one host read of a logging window: the last step's loss,
        and the TrainSummary scalars (JAX's ``_epoch_loop`` :1384-1459)."""
        with span("train/device_sync", step=self.step):
            loss_v = float(last_loss)
        record.loss = loss_v
        lr = float(self.lr_schedule(self.step))
        telemetry.gauge("zoo_train_loss").set(loss_v)
        telemetry.gauge("zoo_train_learning_rate").set(lr)
        summary = self.train_summary
        if summary is not None:
            summary.add_scalar("Loss", loss_v, self.step)
            summary.add_scalar("LearningRate", lr, self.step)
            if self._last_gnorm is not None and \
                    getattr(self.ctx.config, "log_grad_norm", False):
                summary.add_scalar("GradNorm", float(self._last_gnorm),
                                   self.step)
            summary.add_scalar("Throughput", steps * batch_size / wall,
                               self.step)
            summary.add_scalar("StepTimeMs", 1e3 * wall / steps, self.step)
        logger.info("epoch %d step %d loss %.5f", record.epoch, self.step,
                    loss_v)

    def _run_validation(self, validation_set, batch_size, record):
        results = self.evaluate(validation_set, batch_size)
        record.score = next(iter(results.values())) if results else None
        if self.val_summary is not None:
            for name, value in results.items():
                self.val_summary.add_scalar(name, value, self.step)
        logger.info("validation @%d: %s", self.step, results)
        return results

    def evaluate(self, data: FeatureSet, batch_size: int) -> Dict[str, float]:
        """Metric means over ``data``: each batch's (num, den) partial sums
        accumulate on the device and are fetched once. The last batch is
        padded with zero-weight rows, as in the JAX trainer."""
        self.ensure_initialized()
        acc: Dict[str, Any] = {}
        with torch.no_grad():
            for batch in data.batches(batch_size, shuffle=False,
                                      drop_remainder=False,
                                      pad_remainder=True):
                dev = self.put_batch(batch)
                _, y, w = dev
                stats = {}
                if y is not None:
                    loss, preds = self._loss_and_preds(dev, None, False)
                    for m in self.metrics:
                        stats[m.name] = m.batch_stats(preds, y, w)
                    wsum = w.sum()
                    stats["loss"] = (loss * wsum, wsum)
                for name, (num, den) in stats.items():
                    if name in acc:
                        acc[name] = (acc[name][0] + num, acc[name][1] + den)
                    else:
                        acc[name] = (num, den)
        if not acc:
            raise ValueError("evaluate() got an empty dataset or one "
                             "without labels")
        host = {k: (n.cpu().numpy(), d.cpu().numpy())
                for k, (n, d) in acc.items()}
        out = {m.name: m.finalize(*host[m.name]) for m in self.metrics}
        num, den = host["loss"]
        out["loss"] = float(num / max(den, 1e-12))
        return out

    def predict(self, data, batch_size: int = 128):
        """The model's outputs over ``data`` (a ``FeatureSet``, or an array
        or list of arrays) as float32 numpy, in batches of
        ``batch_size``: the last batch padded to full size and the padding
        cut off on the device, one host transfer at the end (the JAX
        trainer's ``predict``). None for an empty dataset."""
        if not isinstance(data, FeatureSet):
            data = ArrayFeatureSet(data)
        self.model.to(self.device)
        remaining = data.size()
        chunks: List[Any] = []
        with torch.inference_mode():
            for xs, _, _ in data.batches(batch_size, shuffle=False,
                                         drop_remainder=False,
                                         pad_remainder=True):
                real = min(batch_size, remaining)
                remaining -= real
                xs = [as_device_tensor(x, self.device) for x in xs]
                out = self._forward(xs, None, False)
                chunks.append([o[:real] for o in out]
                              if isinstance(out, (list, tuple))
                              else out[:real])
        if not chunks:
            return None
        if isinstance(chunks[0], list):
            return [torch.cat([c[i] for c in chunks]).cpu().numpy()
                    for i in range(len(chunks[0]))]
        return torch.cat(chunks).cpu().numpy()

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
            file_io.exists(os.path.join(directory, "model.npz"))

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

    def _flat_snapshot(self):
        """Owned host copies of the trainer state: (params tree, state
        tree, optimizer leaves, meta). On the GPU each tensor is copied
        into a pinned host buffer kept from the last save (the previous
        write has finished with it: ``save_checkpoint`` waits for it
        first), and the copies are complete when this returns, so the
        next step's in-place update cannot reach them."""
        params, state = self.model.param_tree(), self.model.state_tree()
        leaves = optimizer_leaves(self.opt_state, param_order(self.model))
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
        _refuse_sharded()
        self.ensure_initialized()
        t0 = time.perf_counter()
        # one writer at a time per trainer, and the snapshot buffers are
        # the previous write's until it has finished
        self.wait_for_checkpoint()
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
        candidates = self._store_candidates(directory)
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
        # before anything is copied
        order = param_order(self.model, names=list(params))
        if leaves is not None:
            check_optimizer_leaves(self.opt_state, leaves, order)
        load_jax_params(self.model, params, state)
        if leaves is not None:
            self.opt_state = load_optimizer_leaves(self.opt_state, leaves,
                                                   order)
        self._restore_position(meta)
