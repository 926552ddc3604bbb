"""Profiling and timing utilities.

Counterpart of ``analytics_zoo_tpu/utils/profiling.py``:

* :class:`Ewma`, :class:`EwmaStd`, :class:`InfeedMonitor` and
  :func:`inference_window` are copies (standard library only).
* :func:`device_sync` — a real barrier on a tensor's device
  (``torch.cuda.synchronize``), not a host transfer.
* :func:`peak_flops` — the card's public dense bf16 peak, looked up by
  substring of ``torch.cuda.get_device_name``, for the MFU scalar.
* :class:`ProfilerHook` — a ``torch.profiler`` trace of a step window
  when ``ZooConfig.profile_dir`` is set, written as Chrome-trace JSON.
* :class:`FlopCounter` — the FLOPs of one training step, the
  counterpart of the JAX trainer's ``_maybe_record_flops`` (XLA's
  ``cost_analysis()``): PyTorch's ``FlopCounterMode`` counts the
  dispatched matmuls and convolutions, and each hand-written kernel's
  wrapper adds its own analytic count through :func:`kernel_flops`
  (the kernels launch through ctypes, which a dispatch mode never sees).

The JAX module's HLO accountant (``hlo_accountant`` / ``account_step``)
has no HLO to walk here and is not ported (ROADMAP A13).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from . import telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch.profiling")

# the card's peak dense bf16 matmul FLOP/s by lower-cased
# torch.cuda.get_device_name substring, first match wins. Public spec
# sheets (NVIDIA H100 data sheet, dense, no sparsity), not measurements:
# SXM at its 700 W limit, PCIe at 350 W
PEAK_BF16 = [
    ("h100 pcie", 756e12),
    ("h100 sxm", 989.4e12),
    ("h100 80gb hbm3", 989.4e12),
]


def peak_flops(device_kind: str):
    """Peak bf16 matmul FLOP/s for a device name
    (``torch.cuda.get_device_name``), None when the table has no entry;
    ``ZOO_TPU_PEAK_FLOPS`` overrides (for other cards, and for the CPU in
    tests). :data:`PEAK_BF16` holds public spec-sheet figures, not
    measurements."""
    env = os.environ.get("ZOO_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    dk = (device_kind or "").lower()
    for key, val in PEAK_BF16:
        if key in dk:
            return val
    return None


def device_kind(device) -> str:
    """The name :func:`peak_flops` looks up: the CUDA card's name, else
    the device type ("cpu")."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_sync(tree):
    """Block until every kernel queued on the device of the first tensor
    in ``tree`` (a tensor, or a list, tuple or dict of them) has run. On
    a CPU tensor the work is already done."""
    import torch

    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))


class Ewma:
    """Exponentially-weighted moving average of a scalar observation
    stream.  ``value`` is ``None`` until the first observation, so
    consumers can distinguish "no estimate yet" from a zero estimate
    (the serving admission controller admits everything until the first
    batch has been measured).  Thread-safe."""

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.value = None
        self._lock = threading.Lock()

    def update(self, x: float) -> float:
        with self._lock:
            x = float(x)
            if self.value is None:
                self.value = x
            else:
                self.value += self.alpha * (x - self.value)
            return self.value


class EwmaStd:
    """Exponential moving mean *and* variance of a scalar stream
    (West-style incremental moments), for z-score spike detection on
    loss / grad-norm / step-time (pipeline/health.py).

    ``zscore(x)`` answers "how many moving standard deviations is ``x``
    from the moving mean", using the estimate BEFORE ``x`` is folded in
    — an outlier must be scored against history, not against itself.
    Returns 0.0 until ``min_samples`` observations have landed (cold
    stream: no meaningful deviation estimate yet).  Thread-safe."""

    def __init__(self, alpha: float = 0.1, min_samples: int = 5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.mean = None
        self.var = 0.0
        self.n = 0
        self._lock = threading.Lock()

    def zscore(self, x: float) -> float:
        with self._lock:
            if self.mean is None or self.n < self.min_samples:
                return 0.0
            # floor the deviation estimate: a perfectly flat warmup
            # (var→0) must not turn an epsilon wobble into a huge z
            std = max(self.var, 1e-12) ** 0.5
            std = max(std, 1e-6 * max(abs(self.mean), 1.0))
            return (float(x) - self.mean) / std

    def update(self, x: float) -> float:
        with self._lock:
            x = float(x)
            self.n += 1
            if self.mean is None:
                self.mean = x
                self.var = 0.0
            else:
                delta = x - self.mean
                incr = self.alpha * delta
                self.mean += incr
                self.var = (1.0 - self.alpha) * (self.var + delta * incr)
            return self.mean


class InfeedMonitor:
    """Accumulates host-input wait time and reduces it per logging window.

    The training loop calls :meth:`input_wait` around every blocking
    fetch from the host pipeline; the train loop calls :meth:`window` once
    per logging window to obtain averaged scalars and reset the
    accumulator. ``input_bound_fraction`` is the share of wall time the
    step loop spent waiting on input — near 0 means compute-bound, near 1
    means the accelerator is starved and more transform workers / a cache
    tier / a wider prefetch would pay off.

    ``worker_provider`` (optional) is a zero-arg callable returning
    cumulative busy seconds per transform worker (the transform pool's
    ``TransformStats.worker_busy_snapshot``); :meth:`window` diffs
    consecutive snapshots so the scalars also say *how hard the
    decode pool itself is working* — a starved step loop with idle
    workers means the bottleneck is upstream (disk, hand-off), while
    saturated workers mean the pool needs more processes.

    The wait time itself lives in the telemetry registry
    (``zoo_infeed_wait_seconds_total{scope=...}`` plus a latency
    histogram) — this class is a *windowing view* over that counter,
    and TrainSummary scalars are derived from it, so infeed wait exists
    exactly once.
    """

    def __init__(self, worker_provider=None, scope: str = "default"):
        self._lock = threading.Lock()
        self.scope = scope
        self._ctr = telemetry.counter("zoo_infeed_wait_seconds_total",
                                      scope=scope)
        self._hist = telemetry.histogram("zoo_infeed_wait_seconds",
                                         scope=scope)
        self._base = self._ctr.value   # counter survives across monitors
        self._last = self._base
        self._worker_provider = worker_provider
        self._worker_prev: dict = {}

    def input_wait(self, seconds: float):
        self._ctr.inc(seconds)
        self._hist.observe(seconds)

    @property
    def total_wait(self) -> float:
        """Wait accumulated over this monitor's lifetime (seconds)."""
        return self._ctr.value - self._base

    def window(self, steps: int, wall_s: float):
        """Scalars for a window of ``steps`` steps over ``wall_s`` seconds;
        resets the window accumulator."""
        with self._lock:
            cur = self._ctr.value
            wait, self._last = cur - self._last, cur
        steps = max(int(steps), 1)
        wall_s = max(wall_s, 1e-9)
        out = {
            "input_wait_ms_per_step": wait / steps * 1e3,
            "step_time_ms": wall_s / steps * 1e3,
            "input_bound_fraction": min(1.0, wait / wall_s),
        }
        if self._worker_provider is not None:
            try:
                snap = dict(self._worker_provider())
            except Exception:  # noqa: BLE001 - telemetry must not kill train
                logger.debug("infeed worker snapshot failed", exc_info=True)
                snap = {}
            if snap:
                busy = [max(0.0, snap[w] - self._worker_prev.get(w, 0.0))
                        for w in snap]
                self._worker_prev = snap
                out["infeed_workers"] = float(len(snap))
                out["infeed_worker_utilization"] = min(
                    1.0, sum(busy) / (len(busy) * wall_s))
        for key, metric in (
                ("input_bound_fraction", "zoo_input_bound_fraction"),
                ("step_time_ms", "zoo_step_time_ms"),
                ("infeed_worker_utilization",
                 "zoo_infeed_worker_utilization")):
            if key in out:
                telemetry.gauge(metric, scope=self.scope).set(out[key])
        return out


def inference_window(monitor: "InfeedMonitor", n_batches: int,
                     n_samples: int, wall_s: float,
                     fused_dispatches: int, prefix: str):
    """Throughput + infeed scalars for one evaluate()/predict() run
    (``prefix`` = "Eval" | "Predict"); the eval-side telemetry mirror of
    the train loop's per-window scalars. Consumes (and resets) the
    monitor's current window."""
    scalars = monitor.window(n_batches, wall_s)
    wall_s = max(wall_s, 1e-9)
    return {
        f"{prefix}Throughput": n_samples / wall_s,
        f"{prefix}BatchesPerSec": n_batches / wall_s,
        f"{prefix}InfeedWaitMs": scalars["input_wait_ms_per_step"],
        f"{prefix}InputBoundFraction": scalars["input_bound_fraction"],
        f"{prefix}FusedDispatches": float(fused_dispatches),
    }


class ProfilerHook:
    """A ``torch.profiler`` trace over a configured step window.

    :meth:`step` is called with the count of completed steps: the trace
    starts once it reaches ``start_step`` (so it covers the steps after
    it) and stops once it reaches ``start_step + num_steps``; a hook that
    first sees a count past the window traces nothing (a later ``fit``
    of a trainer that has passed it). The CPU and,
    where a card is visible, CUDA activities are recorded; the card is
    synchronised once before the trace stops, so the window's kernels are
    in it. The trace lands in ``profile_dir`` as
    ``trace-torch-profiler-<pid>-<ms>.json`` (Chrome-trace JSON, which
    ``utils/trace_merge.py`` merges with the telemetry traces).
    """

    def __init__(self, profile_dir, start_step, num_steps):
        self.profile_dir = profile_dir
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self.active = False
        self.done = False
        self.path: Optional[str] = None
        self._prof = None

    def step(self, step: int):
        if self.done:
            return
        if not self.active and step >= self.stop_step:
            self.done = True
            return
        if not self.active and step >= self.start_step:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                self._prof = profile(activities=acts)
                self._prof.start()
                self.active = True
                logger.info("profiler trace started -> %s", self.profile_dir)
            except Exception as e:  # noqa: BLE001 - tracing may be refused
                logger.warning("profiler unavailable: %s", e)
                self.done = True
                return
        if self.active and step >= self.stop_step:
            self.close()

    def close(self):
        if self.active:
            try:
                import torch

                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self._prof.stop()
                os.makedirs(self.profile_dir, exist_ok=True)
                path = os.path.join(
                    self.profile_dir, f"trace-torch-profiler-{os.getpid()}-"
                                      f"{int(time.time() * 1e3)}.json")
                self._prof.export_chrome_trace(path)
                self.path = path
                logger.info("profiler trace written to %s", path)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler stop failed: %s", e)
            self.active = False
            self._prof = None
        self.done = True


# -- the step FLOP counter ---------------------------------------------------

_COUNTER: Optional["FlopCounter"] = None


class _NoKernelFlops:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_KERNEL_FLOPS = _NoKernelFlops()


class _KernelFlops:
    """Adds a kernel's analytic FLOPs to the active counter and hides the
    work inside (the plain version on a CPU tensor) from its dispatch
    mode, so the card and the CPU count the same."""

    __slots__ = ("counter", "flops", "_off")

    def __init__(self, counter, flops):
        self.counter, self.flops = counter, int(flops)

    def __enter__(self):
        from torch.utils._python_dispatch import _disable_current_modes

        self.counter.kernel_flops += self.flops
        self._off = _disable_current_modes()
        self._off.__enter__()
        return self

    def __exit__(self, *exc):
        return self._off.__exit__(*exc)


def kernel_flops(flops: int):
    """``with kernel_flops(n):`` around a hand-written kernel's work (its
    launch on the card, its plain version on the CPU): when a
    :class:`FlopCounter` is counting, ``n`` is added to it and the
    dispatched ops inside are not counted; otherwise a shared no-op.

    Model FLOPs, bench.py's convention: the flash forward counts
    4·B·H·Lq·Lk·d, its two backward kernels 8·B·H·Lq·Lk·d together (the
    recomputed logits are not counted), dropout+add+layer-norm 0."""
    counter = _COUNTER
    if counter is None:
        return _NO_KERNEL_FLOPS
    return _KernelFlops(counter, flops)


class FlopCounter:
    """``with FlopCounter() as fc: <one forward and backward>`` then
    ``fc.total``: the matmul and convolution FLOPs PyTorch's
    ``FlopCounterMode`` sees dispatched, plus the hand-written kernels'
    analytic counts (:func:`kernel_flops`). One counter at a time."""

    def __init__(self):
        self.kernel_flops = 0
        self.dispatched_flops = 0
        self._mode = None

    def __enter__(self):
        global _COUNTER
        from torch.utils.flop_counter import FlopCounterMode

        if _COUNTER is not None:
            raise RuntimeError("a FlopCounter is already counting")
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        _COUNTER = self
        return self

    def __exit__(self, *exc):
        global _COUNTER
        _COUNTER = None
        try:
            return self._mode.__exit__(*exc)
        finally:
            self.dispatched_flops = int(self._mode.get_total_flops())

    @property
    def total(self) -> int:
        return self.dispatched_flops + self.kernel_flops
