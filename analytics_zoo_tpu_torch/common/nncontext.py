"""Runtime context: config, the rank's device and the rank mesh.

Counterpart of ``analytics_zoo_tpu/common/nncontext.py``. The JAX context
builds a device mesh over every visible chip of a multi-controller
runtime; here each process is one rank holding one ``torch.device``, and
the mesh is a mesh of ranks (``parallel/mesh.py``) with one process group
per slice of each axis.

``init_nncontext()`` first joins ``torch.distributed`` when the launcher's
environment contract is set (``_maybe_init_distributed``:
``ZOO_TPU_COORDINATOR`` host:port, ``ZOO_TPU_NUM_PROCESSES`` the world
size, ``ZOO_TPU_PROCESS_ID`` the rank; a partial or inconsistent contract
raises, as in JAX). A rank's device is ``cuda:{local_rank %
device_count}``; with no device and no card it raises, never falling back
to the CPU; a caller that wants the CPU asks for it (``device="cpu"``).
The backend follows one rule, recorded on the context (``backend``):
NCCL when every rank of the host has a card of its own, gloo on the CPU
and gloo when ranks share a card (NCCL refuses two ranks on one GPU).
Without the contract the context is one rank of a world of one, with no
process group.

The mesh has JAX's five axes in JAX's order, ``(data, pipe, seq, expert,
model)`` (JAX :227-260): tensor (``model_parallel``), pipeline
(``pipeline_parallel``), sequence and expert parallelism above 1 take
their ranks from the world, and ``data_parallel`` -1 fills the rest. A
mesh that does not cover the world raises JAX's message. The batch is
split over ``data`` only (JAX's ``batch_sharding``): the pipe, seq,
expert and model ranks of one data group read the same rows. The
parameters' layout over the mesh (``param_sharding``) is the trainer's
(``parallel/sharding.py``). The compile cache has no counterpart. A
context whose config asks for telemetry arms the telemetry spine
(``_maybe_enable_telemetry``).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
from typing import Optional

import torch

from ..parallel.mesh import RankMesh, make_mesh

logger = logging.getLogger("analytics_zoo_tpu_torch")

_global_context = None


@dataclasses.dataclass
class ZooConfig:
    """Typed config with env-var overrides (prefix ``ZOO_TPU_``, shared
    with the JAX package so one environment configures both). Only the
    fields the ported path reads."""

    # rank-mesh axis sizes; -1 means "fill with the remaining ranks"
    data_parallel: int = -1
    model_parallel: int = 1
    sequence_parallel: int = 1
    pipeline_parallel: int = 1
    expert_parallel: int = 1
    # long-context strategy when sequence_parallel > 1: "auto" picks
    # ulysses (two all-to-alls around full-L flash attention on H/sp
    # heads) when the head count divides the seq axis, else ring (K/V
    # chunks rotating by ppermute, O(L/sp) score memory, any head count);
    # "ring" / "ulysses" force the choice
    sequence_parallel_mode: str = "auto"
    # parameter layout applied when a model has no explicit
    # set_param_sharding(): "auto" installs the annotation-driven layout
    # (parallel.sharding DEFAULT_RULES) whenever the mesh has a non-data
    # axis > 1, so tp/pp/ep run from Model.fit; "fsdp" also shards the
    # embed/in/out-annotated parameters over the data axis (each rank
    # holds 1/dp of them and of their optimizer state; the forward
    # all-gathers them at use); "default" forces the annotation layout
    # even on a pure-dp mesh; "none" keeps every parameter whole
    param_sharding: str = "auto"
    # GPipe microbatches per step when pipeline_parallel > 1 (0 = one per
    # pipe stage)
    pipeline_microbatches: int = 0
    # ZeRO optimizer-state partitioning over the data axis. 0: every rank
    # holds the full optimizer state and the gradients are all-reduced.
    # 1: each rank holds 1/dp of it. On a pure data-parallel mesh with
    # every parameter whole ("flat"): flattened, padded to a multiple of
    # dp, gradients reduce-scattered, each rank updating its shard, the
    # parameters all-gathered (parallel/zero.py). Beside another axis or a
    # sharded parameter ("gspmd"): the moments of the parameters not laid
    # out over data are cut over data along their first divisible
    # dimension. Needs an elementwise optimizer (all built-in ones are);
    # at dp = 1 it is off
    zero_stage: int = 0
    # seed for weights a model draws when it is built
    seed: int = 42
    # backward remat policy of the flash-attention kernel route
    # (ops/attention.py _flash_remat_policy): "" = the default
    # ("save-lse-recompute-probs": the backward kernels rebuild the
    # probabilities from the saved lse, O(L) memory); "full" /
    # "full-residual" = autograd through the reference attention (O(Lq·Lk)
    # probabilities, no backward kernels). Env: ZOO_TPU_FLASH_REMAT
    flash_remat: str = ""
    # NNFrames ingest: when the processed samples of a frame would exceed
    # this many bytes, NNEstimator.fit spills them to sharded .npz files
    # and streams them (ShardedFileFeatureSet) instead of holding the
    # whole dataset resident (reference: NNEstimator.scala:382 getDataSet
    # caching tiers)
    nnframes_spill_bytes: int = 2_000_000_000
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


def _local_rank() -> int:
    """This process's rank among the ranks of its host: every rank the
    launcher starts runs on one host, so it is the rank itself."""
    return int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_nncontext(): no CUDA device is visible. The port runs "
                "on the GPU unless asked otherwise; pass device='cpu' to "
                "run on the CPU.")
        return torch.device("cuda",
                            _local_rank() % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is visible")
        if dev.index is None:
            dev = torch.device("cuda",
                               _local_rank() % torch.cuda.device_count())
    return dev


#: bound of every collective and of the rendezvous: a rank that waits
#: this long for its peers belongs to a dead gang
DIST_TIMEOUT_S = 600


def choose_backend(device: torch.device, world: int) -> str:
    """The process-group backend for ``world`` ranks on one host with
    ``device``: NCCL when every rank has a card of its own, gloo on the
    CPU and when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


class ZooContext:
    """Holds the config, this rank's ``torch.device`` and the rank mesh.
    One per process."""

    def __init__(self, config: Optional[ZooConfig] = None, device=None):
        import torch.distributed as dist

        self.config = config or ZooConfig.from_env()
        self.device = _resolve_device(device)
        joined = dist.is_available() and dist.is_initialized()
        #: this process's rank and the world size
        self.process_index = dist.get_rank() if joined else 0
        self.num_processes = dist.get_world_size() if joined else 1
        #: the process-group backend ("nccl" or "gloo"), None alone
        self.backend = dist.get_backend() if joined else None
        cfg = self.config
        self.mesh: RankMesh = make_mesh(
            data=cfg.data_parallel,
            pipe=max(int(cfg.pipeline_parallel), 1),
            seq=max(int(cfg.sequence_parallel), 1),
            expert=max(int(cfg.expert_parallel), 1),
            model=max(int(cfg.model_parallel), 1))
        _maybe_enable_telemetry(self.config)
        logger.info("ZooContext: rank %d/%d on %s, mesh %s, backend %s",
                    self.process_index, self.num_processes, self.device,
                    self.mesh.shape, self.backend)

    @property
    def num_devices(self) -> int:
        """Devices of the mesh: one a rank."""
        return self.num_processes


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
    ``cluster_mode`` is accepted for API parity. Under the launcher's
    environment contract it first joins ``torch.distributed``
    (:func:`_maybe_init_distributed`). ``device`` None selects
    ``cuda:{local_rank % device_count}`` and raises without a CUDA
    device."""
    global _global_context
    if _global_context is None:
        if isinstance(conf, ZooConfig):
            cfg = conf
        elif isinstance(conf, dict):
            cfg = ZooConfig.from_env(**conf)
        else:
            cfg = ZooConfig.from_env(**kwargs)
        _maybe_init_distributed(device)
        _global_context = ZooContext(cfg, device=device)
    return _global_context


def get_nncontext() -> ZooContext:
    return init_nncontext()


def set_nncontext(ctx: Optional[ZooContext]):
    global _global_context
    _global_context = ctx


def _maybe_init_distributed(device=None) -> None:
    """Join ``torch.distributed`` when launched under
    ``analytics_zoo_tpu_torch.launcher`` (or any launcher that sets the
    ``ZOO_TPU_*`` topology contract), JAX's ``_maybe_init_distributed``
    on ``torch.distributed``. A partial contract is a config error, not a
    single-process run: an incomplete or inconsistent environment raises.
    The rendezvous is ``tcp://<ZOO_TPU_COORDINATOR>``; the backend is
    :func:`choose_backend`'s for this rank's device."""
    import torch.distributed as dist

    coord = os.environ.get("ZOO_TPU_COORDINATOR")
    nproc_env = os.environ.get("ZOO_TPU_NUM_PROCESSES")
    pid_env = os.environ.get("ZOO_TPU_PROCESS_ID")
    if not coord:
        if nproc_env is not None or pid_env is not None:
            raise RuntimeError(
                "partial distributed env: ZOO_TPU_NUM_PROCESSES/"
                "ZOO_TPU_PROCESS_ID are set but ZOO_TPU_COORDINATOR is "
                "not. Set all three (host:port, world size, rank) or "
                "none — `zoo-launch --hosts N train.py` does this for "
                "you.")
        return
    missing = [name for name, val in
               (("ZOO_TPU_NUM_PROCESSES", nproc_env),
                ("ZOO_TPU_PROCESS_ID", pid_env)) if val is None]
    if missing:
        raise RuntimeError(
            f"partial distributed env: ZOO_TPU_COORDINATOR={coord!r} but "
            f"{' and '.join(missing)} missing. Set all three or none — "
            f"`zoo-launch --hosts N train.py` does this for you.")
    try:
        num_processes = int(nproc_env)
        process_id = int(pid_env)
    except ValueError as e:
        raise RuntimeError(
            f"bad distributed env: ZOO_TPU_NUM_PROCESSES={nproc_env!r} / "
            f"ZOO_TPU_PROCESS_ID={pid_env!r} must be integers") from e
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise RuntimeError(
            f"inconsistent distributed env: ZOO_TPU_PROCESS_ID="
            f"{process_id} must be in [0, ZOO_TPU_NUM_PROCESSES="
            f"{num_processes})")
    if dist.is_initialized():
        return  # init_process_group is once a process
    dev = _resolve_device(device)
    backend = choose_backend(dev, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    # torn down before the interpreter's own teardown: a gloo group left
    # to its destructor at exit can abort the process (SIGABRT) after the
    # script has finished
    atexit.register(_destroy_process_group)
    logger.info("joined distributed topology: rank %d/%d via %s (%s on "
                "%s)", process_id, num_processes, coord, backend, dev)


def _destroy_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
