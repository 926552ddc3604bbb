"""Device-memory accountant.

Counterpart of ``analytics_zoo_tpu/utils/memory.py``. Two views of the
card's memory, both fed into the telemetry spine (:mod:`utils.telemetry`)
so ``train_cli top``, ``metrics-<pid>.json`` and the flight recorder see
the same numbers:

* **Per program, measured:** JAX reads an AOT-compiled program's
  ``memory_analysis()``; PyTorch has no such program, so the trainer
  measures the first step of each program (train, eval, predict) inside a
  :class:`StepAccountant`: the parameters' and the optimizer state's
  bytes (the state's leaves in optax's order, :func:`opt_state_groups`),
  the bytes of the tensors saved for backward (an identity
  ``saved_tensors_hooks``, each storage once, the parameters' own left
  out), the bytes the step's batch moves to the device plus the loss read
  back, and on a CUDA device the allocator's peak over the step above
  what was allocated before it. :func:`account_program` publishes the
  breakdown as ``zoo_hbm_program_*`` gauges and keeps it for forensics.
* **Per device, live:** :func:`poll_device_memory` reads
  ``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` into
  ``zoo_hbm_*`` watermark gauges (None on the CPU), and latches one
  OOM-forensics dump when the allocated share of the card crosses
  ``ZooConfig.hbm_watermark_fraction``.

When an allocation fails (``torch.cuda.OutOfMemoryError``),
:func:`maybe_oom_forensics` writes the post-mortem: the per-program
breakdowns, the card's current statistics and ``torch.cuda.memory_summary()``
(where JAX keeps each program's HLO tail, under the same ``hlo_tail``
key), next to the flight-recorder dump under ``<trace_dir>/debug/``.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, Optional, Sequence

from . import telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch.memory")

# last-known per-program breakdowns / memory summaries / device
# watermarks, composed into the OOM forensics payload
_LOCK = threading.Lock()
_DUMP_SEQ = itertools.count()
_PROGRAMS: Dict[str, Dict[str, Any]] = {}
_SUMMARIES: Dict[str, str] = {}
_LAST_DEVICE: Dict[str, Any] = {}
_WATERMARK_LATCHED = False

# keep only the tail of a memory summary (the allocator's table)
SUMMARY_TAIL_BYTES = 65536

_OOM_MARKERS = ("resource_exhausted", "out of memory", "oom",
                "exceeds the memory", "allocating")


def _leaf_bytes(leaf) -> int:
    """Bytes of one tensor, array or count leaf (a Python int is a count
    that optax keeps as a 0-d int32)."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, (int, np.integer)):
        return 4
    return int(np.asarray(leaf).nbytes)


def params_bytes(params) -> int:
    """Bytes of a parameter dict (``named_parameters()``) or list."""
    values = params.values() if isinstance(params, dict) else params
    return sum(_leaf_bytes(t) for t in values)


def opt_state_groups(opt_state, order: Sequence[str]
                     ) -> Dict[str, Dict[str, int]]:
    """Optimizer-state bytes by parameter group, the JAX accountant's
    breakout: a leaf that mirrors a parameter is attributed to the
    parameter's layer (the first component of its path, the JAX params
    tree's leading key), every other leaf (step counts) to ``_other``.
    ``order`` is ``jax_weights.param_order``'s; ``per_device_bytes``
    equals ``bytes`` (one device). The walk is
    ``jax_weights.optimizer_leaves``'s."""
    groups: Dict[str, Dict[str, int]] = {}
    param_set = set(order)

    def add(group, leaf):
        g = groups.setdefault(group, {"bytes": 0, "per_device_bytes": 0})
        n = _leaf_bytes(leaf)
        g["bytes"] += n
        g["per_device_bytes"] += n

    def walk(state):
        if state is None:
            return
        if isinstance(state, (list, tuple)):
            for s in state:
                walk(s)
        elif isinstance(state, dict):
            if state and all(k in param_set for k in state):
                for k in order:
                    if k in state:
                        add(k.split(".", 1)[0], state[k])
            else:
                for v in state.values():
                    walk(v)
        else:
            add("_other", state)

    walk(opt_state)
    return groups


class StepAccountant:
    """``with StepAccountant(device, exclude=tensors) as acc: <a step>``
    then ``acc.saved_bytes`` and ``acc.step_peak_bytes``.

    ``saved_bytes``: the bytes of the storages of the tensors saved for
    backward during the block (``torch.autograd.graph.saved_tensors_hooks``
    with identity pack and unpack, so nothing changes), each storage
    counted once and the storages of ``exclude`` (the parameters and
    state buffers, counted elsewhere) left out. The hook also sees the
    tensors a hand-written kernel's ``save_for_backward`` keeps.

    ``step_peak_bytes`` (CUDA only, else None): the allocator's peak over
    the block minus what was allocated when it began. The device's peak
    counter belongs to the caller and is never reset, so the block's peak
    is known only when the block raised it: when the block stayed under an
    earlier high-water mark, ``step_peak_bytes`` is None (not measured)."""

    def __init__(self, device, exclude: Iterable = ()):
        import torch

        self.device = torch.device(device)
        self._exclude = {self._key(t) for t in exclude}
        self._seen: Dict[tuple, int] = {}
        self.saved_bytes = 0
        self.step_peak_bytes: Optional[int] = None
        self.allocated_before: Optional[int] = None
        self._peak_before: Optional[int] = None
        self._hooks = None

    @staticmethod
    def _key(t):
        st = t.untyped_storage()
        return (t.device.type, t.device.index, st.data_ptr(), st.nbytes())

    def _pack(self, t):
        try:
            key = self._key(t)
            if key not in self._exclude and key not in self._seen:
                self._seen[key] = key[3]
        except Exception:  # noqa: BLE001 - a storage-less tensor: skip
            pass
        return t

    @staticmethod
    def _unpack(t):
        return t

    def __enter__(self):
        import torch

        if self.device.type == "cuda":
            self._peak_before = torch.cuda.max_memory_allocated(self.device)
            self.allocated_before = torch.cuda.memory_allocated(self.device)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self._hooks.__exit__(*exc)
        self.saved_bytes = sum(self._seen.values())
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            if peak > self._peak_before:
                self.step_peak_bytes = peak - self.allocated_before
        return False


def program_breakdown(params_b: int, opt_b: int, saved_b: Optional[int],
                      transfers_b: int,
                      step_peak_b: Optional[int] = None,
                      allocated_before_b: Optional[int] = None
                      ) -> Dict[str, Optional[int]]:
    """One program's breakdown under the JAX accountant's keys.
    ``total_bytes`` is the allocator's peak over the step (what was
    allocated before it plus its peak above that) where the step's peak
    was measured, and the sum of the measured parts otherwise.
    ``saved_b`` is None where the saved activations were not measured
    (evaluate and predict run without autograd and save nothing)."""
    if step_peak_b is not None and allocated_before_b is not None:
        total = allocated_before_b + step_peak_b
    else:
        total = params_b + opt_b + (saved_b or 0) + transfers_b
    return {
        "params_bytes": params_b,
        "opt_state_bytes": opt_b,
        "opt_state_per_device_bytes": opt_b,
        "activations_temp_bytes": saved_b,
        "transfers_bytes": transfers_b,
        "step_peak_bytes": step_peak_b,
        "total_bytes": total,
    }


def account_program(program: str, bd: Dict[str, Any],
                    groups: Optional[Dict[str, Dict[str, int]]] = None,
                    device=None) -> Dict[str, Any]:
    """Record one program's breakdown: gauges and forensics state.
    ``program`` is a label value ("train"/"eval"/"predict"), never part of
    a metric name. On a CUDA ``device`` the allocator's summary is kept
    for the post-mortem."""
    groups = groups or {}
    with _LOCK:
        _PROGRAMS[program] = dict(bd, opt_state_groups={
            g: dict(v) for g, v in groups.items()})
    telemetry.gauge("zoo_hbm_program_total_bytes",
                    program=program).set(bd["total_bytes"])
    telemetry.gauge("zoo_hbm_program_params_bytes",
                    program=program).set(bd["params_bytes"])
    telemetry.gauge("zoo_hbm_program_opt_state_bytes",
                    program=program).set(bd["opt_state_bytes"])
    telemetry.gauge("zoo_hbm_program_opt_state_per_device_bytes",
                    program=program).set(bd["opt_state_per_device_bytes"])
    for group, gb in groups.items():
        telemetry.gauge("zoo_hbm_program_opt_state_group_bytes",
                        program=program, group=group).set(gb["bytes"])
        telemetry.gauge(
            "zoo_hbm_program_opt_state_group_per_device_bytes",
            program=program, group=group).set(gb["per_device_bytes"])
    if bd["activations_temp_bytes"] is not None:
        telemetry.gauge("zoo_hbm_program_temp_bytes",
                        program=program).set(bd["activations_temp_bytes"])
    telemetry.gauge("zoo_hbm_program_transfer_bytes",
                    program=program).set(bd["transfers_bytes"])
    if bd.get("step_peak_bytes") is not None:
        telemetry.gauge("zoo_hbm_program_step_peak_bytes",
                        program=program).set(bd["step_peak_bytes"])
    telemetry.event("memory/program_accounted", program=program,
                    total_bytes=bd["total_bytes"],
                    temp_bytes=bd["activations_temp_bytes"])
    if device is not None and _is_cuda(device):
        record_summary(program, _cuda_summary(device))
    return bd


def record_summary(program: str, text: str) -> None:
    """Keep the tail of an allocator summary for the OOM post-mortem."""
    if not text:
        return
    with _LOCK:
        _SUMMARIES[program] = text[-SUMMARY_TAIL_BYTES:]


def program_breakdowns() -> Dict[str, Dict[str, Any]]:
    with _LOCK:
        return {k: dict(v) for k, v in _PROGRAMS.items()}


def _is_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def _cuda_summary(device) -> str:
    import torch

    try:
        return torch.cuda.memory_summary(device)
    except Exception:  # noqa: BLE001 - a summary is best-effort
        return ""


def _read_device(device) -> Dict[str, Any]:
    """One CUDA device's allocator statistics and the card's memory."""
    import torch

    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return {"device": str(torch.device(device).index or 0),
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               in_use)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_free": int(free), "bytes_limit": int(total),
            "num_alloc_retries": int(stats.get("num_alloc_retries", 0)),
            "num_ooms": int(stats.get("num_ooms", 0))}


def poll_device_memory(devices: Optional[Sequence] = None,
                       watermark_fraction: float = 0.0,
                       out_dir: Optional[str] = None) -> \
        Optional[Dict[str, Any]]:
    """Read the CUDA devices' allocator statistics into ``zoo_hbm_*``
    gauges; never None when a CUDA device is among ``devices`` (all
    visible cards by default), None without one (the CPU).

    When ``watermark_fraction`` > 0 and a device's allocated bytes cross
    that share of its memory, an OOM-forensics dump is written ONCE
    (latched for the process), so a run drifting toward OOM leaves
    evidence before the allocator fails."""
    global _WATERMARK_LATCHED
    import torch

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    per_device = []
    worst = 0.0
    for d in devices:
        if not _is_cuda(d):
            continue
        row = _read_device(d)
        dev = row["device"]
        telemetry.gauge("zoo_hbm_bytes_in_use", device=dev).set(
            row["bytes_in_use"])
        telemetry.gauge("zoo_hbm_peak_bytes", device=dev).set(
            row["peak_bytes_in_use"])
        telemetry.gauge("zoo_hbm_bytes_reserved", device=dev).set(
            row["bytes_reserved"])
        if row["bytes_limit"]:
            telemetry.gauge("zoo_hbm_bytes_limit", device=dev).set(
                row["bytes_limit"])
            worst = max(worst, row["bytes_in_use"] / row["bytes_limit"])
        per_device.append(row)
    if not per_device:
        return None
    snapshot = {"per_device": per_device, "watermark_fraction": worst,
                "ts": time.time()}
    with _LOCK:
        _LAST_DEVICE.clear()
        _LAST_DEVICE.update(snapshot)
    telemetry.gauge("zoo_hbm_watermark_fraction").set(worst)
    if watermark_fraction > 0 and worst >= watermark_fraction \
            and not _WATERMARK_LATCHED:
        _WATERMARK_LATCHED = True
        telemetry.event("memory/watermark_crossed", fraction=worst,
                        threshold=watermark_fraction)
        oom_forensics(
            f"HBM watermark {worst:.3f} >= {watermark_fraction:.3f}",
            out_dir=out_dir)
    return snapshot


def _looks_like_oom(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in _OOM_MARKERS)


def maybe_oom_forensics(exc: BaseException,
                        out_dir: Optional[str] = None) -> Optional[str]:
    """If ``exc`` is an allocation failure (``torch.cuda.OutOfMemoryError``
    or a message that says so), write the OOM post-mortem and return its
    path; otherwise do nothing."""
    import torch

    if not (isinstance(exc, torch.cuda.OutOfMemoryError)
            or _looks_like_oom(exc)):
        return None
    return oom_forensics(f"allocation failed: {type(exc).__name__}: {exc}",
                         out_dir=out_dir)


def _current_devices():
    """Every initialised CUDA device's statistics now (not latched),
    and the allocator summaries, for a post-mortem."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}, {}
    rows, summaries = [], {}
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        rows.append(_read_device(dev))
        summaries[f"cuda:{i}"] = _cuda_summary(dev)[-SUMMARY_TAIL_BYTES:]
    return {"per_device": rows, "ts": time.time()}, summaries


def oom_forensics(reason: str, out_dir: Optional[str] = None) -> \
        Optional[str]:
    """Write the memory post-mortem — the per-program breakdowns, the
    card's statistics now (the last poll's on the CPU) and the allocator
    summaries (the JAX payload's ``hlo_tail`` key) — plus the standard
    flight-recorder dump. Never raises."""
    try:
        telemetry.event("memory/oom_forensics", reason=reason)
        telemetry.dump_flight(f"memory: {reason}", out_dir=out_dir)
        base = out_dir or os.environ.get("ZOO_TPU_TRACE_DIR")
        if base is None:
            return None
        debug = os.path.join(base, "debug")
        os.makedirs(debug, exist_ok=True)
        # the sequence number keeps two dumps of one millisecond apart
        path = os.path.join(
            debug, f"oom-{os.getpid()}-{int(time.time() * 1000)}-"
            f"{next(_DUMP_SEQ)}.json")
        now, summaries = _current_devices()
        with _LOCK:
            payload = {
                "reason": reason,
                "ts": time.time(),
                "programs": {k: dict(v) for k, v in _PROGRAMS.items()},
                "device_memory": now or dict(_LAST_DEVICE),
                "hlo_tail": dict(_SUMMARIES, **summaries),
            }
        telemetry._atomic_write_json(path, payload)
        logger.error("OOM forensics written to %s (%s)", path, reason)
        return path
    except Exception:  # noqa: BLE001 - forensics must not mask the OOM
        logger.debug("oom forensics failed", exc_info=True)
        return None


def reset_for_tests() -> None:
    global _WATERMARK_LATCHED
    with _LOCK:
        _PROGRAMS.clear()
        _SUMMARIES.clear()
        _LAST_DEVICE.clear()
    _WATERMARK_LATCHED = False
