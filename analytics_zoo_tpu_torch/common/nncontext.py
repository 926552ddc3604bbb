"""Runtime context: config and the device the entry points run on.

Counterpart of ``analytics_zoo_tpu/common/nncontext.py``. The JAX context
builds a device mesh over every visible chip; this one holds one
``torch.device``. ``init_nncontext()`` with no device selects ``cuda:0``
and raises when no CUDA device is present — it never falls back to the
CPU; a caller that wants the CPU asks for it (``device="cpu"``). The
mesh, multi-process initialisation and compile cache arrive with later
slices. A context whose config asks for telemetry arms the telemetry
spine (``_maybe_enable_telemetry``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")

_global_context = None


@dataclasses.dataclass
class ZooConfig:
    """Typed config with env-var overrides (prefix ``ZOO_TPU_``, shared
    with the JAX package so one environment configures both). Only the
    fields the ported path reads."""

    # parallel degrees; the port runs on one device, so anything above 1
    # reaches a NotImplementedError in the layer that would need it
    data_parallel: int = 1
    sequence_parallel: int = 1
    pipeline_parallel: int = 1
    # seed for weights a model draws when it is built
    seed: int = 42
    # host data pipeline (feature/host_pipeline.py): transformed batches
    # the prefetch thread keeps queued on the host
    prefetch_depth: int = 2
    # ordered transform-pool workers running the Preprocessing chain for
    # several batches concurrently (MTSampleToMiniBatch parity). 0 = serial
    # in the prefetch thread; -1 (default) auto-sizes the pool from the
    # host core count (feature.host_pipeline.resolve_transform_workers;
    # env ZOO_TPU_TRANSFORM_WORKERS)
    transform_workers: int = -1
    # infeed transform backend: "thread" | "process" | "auto" (env:
    # ZOO_TPU_INFEED_BACKEND). "process" ships the Preprocessing chain to
    # a spawn pool returning batches through shared-memory rings
    # (ZOO_TPU_INFEED_SLOT_BYTES a slot, ZOO_TPU_INFEED_SLOTS slots a
    # worker); "auto" picks process only for chains declaring
    # cpu_bound=True on a multi-core host
    # (feature.host_pipeline.resolve_infeed_backend)
    infeed_backend: str = "auto"
    # batches kept already staged on the device ahead of the step: on the
    # card each is copied from a pinned buffer on a side stream (a ring of
    # device_ahead + 1 pinned buffers per batch leaf), so the copy of
    # batch N+1 overlaps the compute of batch N
    device_ahead: int = 2
    # microbatches per optimizer step: each batch is split into this many
    # equal microbatches, their gradients summed weighted by each one's
    # sample-weight mass before the one update (peak activation memory is
    # one microbatch's). Must divide batch_size. 1 = off.
    grad_accum_steps: int = 1
    # failed steps ``train`` restores the latest checkpoint for and goes on
    # (reference: bigdl.failure.retryTimes, Topology.scala:1172)
    failure_retry_times: int = 5
    checkpoint_dir: Optional[str] = None
    # steps per summary window: the loss is read on the host, and the
    # TensorBoard scalars written, once a window
    log_every_n_steps: int = 50
    # the GradNorm scalar, logged only where L2-norm clipping computes the
    # norm anyway (never an extra reduce)
    log_grad_norm: bool = False
    # write checkpoints on a background thread: the snapshot to host
    # memory stays synchronous, serialisation, checksums and file IO move
    # off the training loop
    async_checkpoint: bool = False
    # keep-last-k retention of the checkpoint store (ckpt-<step>/ under
    # the checkpoint directory); <= 0 keeps every checkpoint
    keep_checkpoints: int = 3
    # resume from the latest checkpoint of the checkpoint directory at the
    # start of ``train`` (also ZOO_TPU_AUTO_RESUME); off, a ``fit`` into a
    # directory of old checkpoints starts afresh
    auto_resume: bool = False
    # the dtype of a model's forward and backward when the model sets none
    # (``KerasNet.set_compute_dtype``): "bfloat16" (or "bf16") casts the
    # floating parameters and inputs inside the step; the parameters and
    # the optimizer state stay float32
    compute_dtype: str = "float32"
    # profiling: when set, a torch.profiler trace of profile_num_steps
    # steps after profile_start_step, written as Chrome-trace JSON there
    # (utils/profiling.ProfilerHook)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # the telemetry spine (utils/telemetry.py): span tracer, metrics
    # registry, flight recorder. Off by default
    telemetry: bool = False
    # with telemetry on: trace-<pid>.json and a periodic metrics-<pid>.json
    # land here; fault-path flight dumps and OOM forensics go to
    # <trace_dir>/debug/
    trace_dir: Optional[str] = None
    # the training health monitor (pipeline/health.py): a NaN/Inf sentinel
    # on the loss (and the grad norm when L2 clipping computes it) kept on
    # the device and read at each logging window and before every
    # checkpoint save, and EWMA z-score spike detection a window
    health_monitor: bool = False
    # escalate a latched non-finite to halt through the preemption drain
    # (no final save: `latest` keeps the last good step)
    health_halt: bool = False
    # |z| above this many moving standard deviations flags a spike on
    # loss / grad_norm / step_time_ms
    health_z_threshold: float = 6.0
    # logging windows observed before spike detection arms
    health_warmup_windows: int = 5
    # a grad-norm sentinel even without L2-norm clipping (one more
    # global-norm reduction a step)
    health_grad_sentinel: bool = False
    # the device-memory accountant (utils/memory.py): the first step of
    # each program measured (parameters, optimizer state, saved
    # activations, transfers, the allocator's step peak on CUDA), and the
    # card's allocator statistics polled each logging window
    memory_accounting: bool = True
    # share of the card's memory at which the allocated bytes latch one
    # OOM-forensics dump; 0 disables it
    hbm_watermark_fraction: float = 0.92

    @classmethod
    def from_env(cls, **overrides):
        """The config with each ``ZOO_TPU_<FIELD>`` variable parsed by the
        field's type: int, float, bool (1/true/yes/on, 0/false/no/off) or
        str."""
        cfg = cls(**overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get("ZOO_TPU_" + f.name.upper())
            if env is None:
                continue
            try:
                setattr(cfg, f.name, _parse(f.type, env))
            except ValueError as e:
                raise ValueError(f"bad value for ZOO_TPU_{f.name.upper()}: "
                                 f"{env!r}") from e
        return cfg


def _parse(field_type, env: str):
    """``env`` as a value of the dataclass field type ``field_type`` (a
    type or, under postponed annotations, its name)."""
    if field_type in ("int", int):
        return int(env)
    if field_type in ("float", float):
        return float(env)
    if field_type in ("bool", bool):
        low = env.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {env!r}")
    return env


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_nncontext(): no CUDA device is visible. The port runs "
                "on the GPU unless asked otherwise; pass device='cpu' to "
                "run on the CPU.")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is visible")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


class ZooContext:
    """Holds the config and the ``torch.device``. One per process."""

    def __init__(self, config: Optional[ZooConfig] = None, device=None):
        self.config = config or ZooConfig.from_env()
        self.device = _resolve_device(device)
        _maybe_enable_telemetry(self.config)
        logger.info("ZooContext: device %s", self.device)


def _maybe_enable_telemetry(cfg: ZooConfig):
    """Arm the telemetry spine from ``ZooConfig.telemetry`` /
    ``trace_dir`` (env: ``ZOO_TPU_TELEMETRY`` / ``ZOO_TPU_TRACE_DIR``).
    Only ever turns telemetry ON: an environment-enabled run is not
    switched off by the default config."""
    from ..utils import telemetry

    if not (cfg.telemetry or telemetry.enabled()):
        return
    rank = os.environ.get("ZOO_TPU_PROCESS_ID", "0")
    telemetry.configure(enabled=True, trace_dir=cfg.trace_dir,
                        service=f"train-worker-{rank}")


def init_nncontext(conf=None, cluster_mode: str = "local", device=None,
                   **kwargs) -> ZooContext:
    """Initialize (or fetch) the global context.

    Mirrors ``init_nncontext`` (pyzoo/zoo/common/nncontext.py:23);
    ``cluster_mode`` is accepted for API parity. ``device`` None selects
    ``cuda:0`` and raises without a CUDA device."""
    global _global_context
    if _global_context is None:
        if isinstance(conf, ZooConfig):
            cfg = conf
        elif isinstance(conf, dict):
            cfg = ZooConfig.from_env(**conf)
        else:
            cfg = ZooConfig.from_env(**kwargs)
        _global_context = ZooContext(cfg, device=device)
    return _global_context


def get_nncontext() -> ZooContext:
    return init_nncontext()


def set_nncontext(ctx: Optional[ZooContext]):
    global _global_context
    _global_context = ctx
