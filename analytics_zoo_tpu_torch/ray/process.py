"""Worker-process lifecycle: orphan reaping and shutdown hooks.

Counterpart of ``analytics_zoo_tpu/ray/process.py``. Reference behaviors
rebuilt (not copied): ``JVMGuard.registerPids``
(pyzoo/zoo/ray/util/raycontext.py:32-51) registers ray pids with the Spark
executor JVM so they die with it, and ``ProcessMonitor``
(pyzoo/zoo/ray/util/process.py:152) shell-execs and monitors nodes. There
is no JVM to guard with, so the same guarantees are provided directly:

* **parent-death watch**: every worker runs a daemon thread that polls its
  parent pid; if the parent dies (worker orphaned → ppid reparented), the
  worker ``os._exit``s. This is the JVMGuard equivalent.
* **shutdown hook**: the context registers ``atexit``/signal hooks that
  SIGTERM-then-SIGKILL the whole worker set, the ProcessMonitor equivalent.
"""

from __future__ import annotations

import atexit
import logging
import os
import signal
import threading
import time
from typing import List

logger = logging.getLogger("analytics_zoo_tpu_torch.ray")


class ProcessGuard:
    """Runs inside a worker: exit hard when the parent process disappears."""

    def __init__(self, parent_pid: int, poll_interval: float = 1.0):
        self.parent_pid = parent_pid
        self.poll_interval = poll_interval
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="zoo-process-guard")

    def start(self):
        self._thread.start()
        return self

    def _parent_alive(self) -> bool:
        try:
            os.kill(self.parent_pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def _watch(self):
        while True:
            if not self._parent_alive() or os.getppid() == 1:
                # orphaned: mirror JVMGuard's kill-on-executor-death
                os._exit(113)
            time.sleep(self.poll_interval)


class ProcessMonitor:
    """Driver-side registry of worker processes with atexit cleanup."""

    def __init__(self):
        self.procs: List = []
        atexit.register(self.shutdown)

    def register(self, proc):
        self.procs.append(proc)

    def alive(self) -> List:
        return [p for p in self.procs if p.is_alive()]

    def shutdown(self, timeout: float = 5.0):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.time() + timeout
        for p in self.procs:
            remain = max(0.0, deadline - time.time())
            p.join(remain)
        for p in self.procs:
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        self.procs = []
