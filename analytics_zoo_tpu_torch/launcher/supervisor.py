"""Process-supervision primitives of the serving fleet.

Counterpart of ``analytics_zoo_tpu/launcher/supervisor.py``, copied: the
launcher's spawn, log fan-in and teardown mechanics, which the serving
fleet (``serving/fleet.py``) reuses with a lifecycle of its own
(long-running workers that get *restarted* rather than a batch job that
runs to completion):

- :func:`inject_pythonpath` — child processes import the same package
  tree the supervisor runs from, regardless of cwd or pip state;
- :func:`spawn_supervised` — Popen with merged stdout/stderr and a
  daemon pump thread fanning lines into one stream under a shared lock,
  each line prefixed ``[tag]`` so interleaved workers stay readable;
- :class:`Respawner` — the bounded respawn-on-death decision;
- :func:`terminate_all` — SIGTERM everything still alive (children run
  their teardown handlers), escalate to SIGKILL after a grace period.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from typing import Dict, IO, List, NamedTuple, Optional, Sequence


def inject_pythonpath(env: Dict[str, str]) -> Dict[str, str]:
    """Prepend the package root to ``env``'s PYTHONPATH (deduplicated,
    order-preserving) so spawned workers resolve
    ``analytics_zoo_tpu_torch`` identically to the supervisor."""
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parts = [pkg_root] + [p for p in
                          env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


def pump_lines(tag: str, pipe: IO[str], stream, lock: threading.Lock,
               prefix: bool = True):
    """Fan one child's merged stdout/stderr into ``stream``, one line at
    a time under ``lock`` so workers never interleave mid-line."""
    head = f"[{tag}] "
    for line in iter(pipe.readline, ""):
        with lock:
            stream.write((head if prefix else "") + line)
            stream.flush()
    pipe.close()


class SupervisedProc(NamedTuple):
    """One supervised child: the Popen handle plus its log pump."""

    proc: subprocess.Popen
    pump: threading.Thread
    tag: str


def spawn_supervised(cmd: Sequence[str], env: Dict[str, str], tag: str,
                     stream, lock: threading.Lock,
                     prefix: bool = True,
                     cwd: Optional[str] = None) -> SupervisedProc:
    """Start ``cmd`` with merged stdout/stderr pumped into ``stream``
    line-by-line under ``lock``, each line tagged ``[tag]``."""
    p = subprocess.Popen(list(cmd), env=env, cwd=cwd,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, bufsize=1)
    t = threading.Thread(target=pump_lines,
                         args=(tag, p.stdout, stream, lock, prefix),
                         daemon=True, name=f"pump-{tag}")
    t.start()
    return SupervisedProc(p, t, tag)


class Respawner:
    """Bounded respawn-on-death policy.

    The supervision loops that restart dead children (the serving fleet,
    and the JAX package's process-based infeed pool) all need the same
    decision: *is one more restart of this child allowed, or has it died
    often enough that the failure is structural and should surface?*
    This class is only that decision — it spawns nothing itself, so it
    works for ``subprocess.Popen`` fleets and ``multiprocessing``
    workers alike.

    A restart budget is per-child (``tag``), with an optional global
    cap across all children. Exceeding either raises ``RuntimeError``
    with the death history, which is exactly the prompt-error-surfacing
    contract the infeed iterators follow.
    """

    def __init__(self, max_per_child: int = 3,
                 max_total: Optional[int] = None):
        self.max_per_child = max_per_child
        self.max_total = max_total
        self._per_child: Dict[str, int] = {}
        self._total = 0
        self._lock = threading.Lock()

    @property
    def total_respawns(self) -> int:
        return self._total

    def note_death(self, tag: str, detail: str = "") -> None:
        """Record a child death and authorise one respawn of it, or
        raise ``RuntimeError`` when the budget is exhausted."""
        with self._lock:
            n = self._per_child.get(tag, 0) + 1
            self._per_child[tag] = n
            self._total += 1
            if n > self.max_per_child:
                raise RuntimeError(
                    f"worker {tag!r} died {n} times "
                    f"(> {self.max_per_child} respawns allowed)"
                    + (f": {detail}" if detail else ""))
            if self.max_total is not None and self._total > self.max_total:
                raise RuntimeError(
                    f"{self._total} worker deaths across the pool "
                    f"(> {self.max_total} total respawns allowed)"
                    + (f": {detail}" if detail else ""))


def terminate_all(procs: Sequence[subprocess.Popen], grace_s: float):
    """SIGTERM everything still alive (workers run their teardown
    handlers), escalate to SIGKILL after ``grace_s``."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        try:
            p.send_signal(signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + grace_s
    for p in live:
        try:
            p.wait(timeout=max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            try:
                p.kill()
                p.wait(timeout=5.0)
            except OSError:
                pass


__all__: List[str] = ["inject_pythonpath", "pump_lines", "spawn_supervised",
                      "SupervisedProc", "Respawner", "terminate_all"]
