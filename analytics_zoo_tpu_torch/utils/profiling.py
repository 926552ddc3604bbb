"""Profiling utilities.

Counterpart of ``analytics_zoo_tpu/utils/profiling.py``. Only
:class:`Ewma` comes over, a copy: the serving admission controller's
service-time estimates. The rest of that module (device sync, peak FLOP/s,
the profiler hook, infeed monitors) imports JAX and waits for the
observability slice of the port.
"""

from __future__ import annotations

import threading


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
