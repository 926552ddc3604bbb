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
place, once a step: the state a step commits with its update, as JAX's
``_step_body`` returns it. ``evaluate`` and ``predict`` run with
``training=False`` and only read them.

The training stream: each step draws its dropout from a
``torch.Generator`` on the device seeded from ``(seed, step)``, the
counterpart of ``fold_in(key(seed), step)``. The stream differs from
JAX's by design; the epoch order (``seed + epoch`` shuffles) is the same.

Not ported yet: gradient accumulation (``train`` refuses
``ZooConfig.grad_accum_steps > 1``), checkpoints (``fit`` refuses a
checkpoint trigger), the fused k-step dispatch, the health monitor, ZeRO
and auto-resume.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common.nncontext import ZooContext, get_nncontext
from ..common.zoo_trigger import EveryEpoch, MaxEpoch, TrainRecord, \
    ZooTrigger
from ..feature.feature_set import ArrayFeatureSet, FeatureSet, MiniBatch
from .api.keras.optimizers import global_norm

logger = logging.getLogger("analytics_zoo_tpu_torch.engine")

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for training step ``step`` of a run seeded
    ``seed`` (a splitmix64 mix, so neighbouring steps and seeds give
    unrelated streams)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def as_device_tensor(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; float64 arrives as float32,
    as ``jnp.asarray`` gives it without x64."""
    t = torch.as_tensor(np.asarray(a))
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
        self.tx = optimizer.transformation()
        self.metrics = metrics or []
        self.clipping = clipping or GradientClipping()
        self.seed = seed
        self.opt_state = None
        self.step = 0
        self.epoch = 0
        #: the losses of the steps of the last ``train`` call, as floats
        self.step_losses: List[float] = []
        self.frozen_names: frozenset = frozenset()

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

    def generator(self, step: int) -> torch.Generator:
        """The dropout stream of training step ``step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        return gen

    def loss_and_grads(self, batch, training: bool = True):
        """Forward and backward of one device batch at the current step,
        without a parameter update: the loss, and each parameter's
        gradient left in its ``.grad`` (None where the loss does not reach
        it). A training forward updates the state buffers."""
        params = self.params()
        for p in params.values():
            p.grad = None
        gen = self.generator(self.step) if training else None
        loss, _ = self._loss_and_preds(batch, gen, training)
        loss.backward()
        return loss.detach()

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
            grads, _ = self.clipping.apply_with_norm(grads)
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
              validation_set: Optional[FeatureSet] = None) -> TrainRecord:
        """Train until ``end_trigger`` (one epoch by default), validating
        on ``validation_set`` after each epoch."""
        if self._grad_accum_steps() > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet; gradient "
                "accumulation arrives with a later engine slice of the port")
        self.ensure_initialized()
        end_trigger = end_trigger or MaxEpoch(1)
        validation_trigger = EveryEpoch() if validation_set is not None \
            else None
        record = TrainRecord(epoch=self.epoch, iteration=self.step)
        losses: List[torch.Tensor] = []
        while not end_trigger(record):
            self._run_epoch(train_set, batch_size, record, end_trigger,
                            validation_set, validation_trigger, losses)
        self.step_losses = torch.stack(losses).tolist() if losses else []
        return record

    def _run_epoch(self, train_set, batch_size, record, end_trigger,
                   validation_set, validation_trigger, losses):
        n_batches = 0
        for batch in train_set.batches(batch_size, shuffle=True,
                                       drop_remainder=True,
                                       seed=self.seed + record.epoch):
            losses.append(self.train_step(self.put_batch(batch)))
            n_batches += 1
            record.iteration = self.step
            record.epoch_finished = False
            if validation_trigger is not None and validation_trigger(record):
                self._run_validation(validation_set, batch_size, record)
            if end_trigger(record):
                break  # per-iteration end check (parity: endWhen)
        if n_batches:
            record.loss = float(losses[-1])
        self.epoch += 1
        record.epoch = self.epoch
        record.epoch_finished = True
        logger.info("epoch %d done: %d iterations, loss %.5f", record.epoch,
                    n_batches, record.loss)
        if validation_trigger is not None and validation_trigger(record):
            self._run_validation(validation_set, batch_size, record)

    def _run_validation(self, validation_set, batch_size, record):
        results = self.evaluate(validation_set, batch_size)
        record.score = next(iter(results.values())) if results else None
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
