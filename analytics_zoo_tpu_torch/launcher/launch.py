"""Multi-process job launcher: spawn, propagate env, fan in logs, supervise.

Counterpart of ``analytics_zoo_tpu/launcher/launch.py``, built on the
port's ``launcher/supervisor.py``. Local multi-process (one worker per
``--hosts`` slot on this machine: ranks on the CPU with gloo, one rank a
card with NCCL, or ranks sharing a card with gloo, as
``common/nncontext.choose_backend`` decides); the ``--hosts-file`` surface
is parsed so remote placement can slot in without changing the contract.

Env contract handed to every worker (consumed by
``common/nncontext._maybe_init_distributed``):

- ``ZOO_TPU_COORDINATOR``   host:port of process 0's coordination service
- ``ZOO_TPU_NUM_PROCESSES`` world size
- ``ZOO_TPU_PROCESS_ID``    this worker's rank

Failure policy (``on_failure``):

- ``kill-all`` (default): first nonzero exit terminates the remaining
  workers (SIGTERM, then SIGKILL after ``grace_s``) — fail fast, the
  collective is dead anyway once one member is gone;
- ``report``: let the surviving workers run to completion and report the
  failure at the end.
- ``restart``: SPMD is all-or-nothing — any worker death tears down the
  whole gang (as kill-all) and relaunches it, up to ``max_restarts``
  times with exponential backoff starting at ``restart_backoff_s``.
  Restarted gangs get ``ZOO_TPU_AUTO_RESUME=1`` so training resumes from
  the ``latest`` checkpoint (see docs/fault-tolerance.md); each attempt
  picks a fresh coordinator port (the dead gang's port may linger in
  TIME_WAIT).

Either way :func:`launch` returns the **first nonzero exit code** (0 when
every worker succeeded, possibly after restarts).
"""

from __future__ import annotations

import logging
import os
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, IO, List, NamedTuple, Optional, Sequence

from ..utils import telemetry
from .supervisor import (inject_pythonpath, pump_lines, spawn_supervised,
                         terminate_all)

logger = logging.getLogger("analytics_zoo_tpu_torch.launcher")


class LaunchError(RuntimeError):
    """Launcher-level misconfiguration (bad hosts file, no workers...)."""


class HostSpec(NamedTuple):
    """One placement row: hostname + number of worker slots on it."""

    host: str
    slots: int


_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def parse_hosts_file(path: str) -> List[HostSpec]:
    """Parse an MPI-style hosts file: ``host [slots]`` per line, ``#``
    comments. Only localhost rows are launchable today; remote rows
    parse fine but :func:`launch` rejects them with a clear error so the
    file format is already the forward-compatible surface."""
    specs: List[HostSpec] = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) > 2:
                raise LaunchError(
                    f"{path}:{lineno}: expected 'host [slots]', got "
                    f"{raw.strip()!r}")
            slots = 1
            if len(parts) == 2:
                try:
                    slots = int(parts[1])
                except ValueError as e:
                    raise LaunchError(
                        f"{path}:{lineno}: bad slot count "
                        f"{parts[1]!r}") from e
                if slots < 1:
                    raise LaunchError(
                        f"{path}:{lineno}: slots must be >= 1")
            specs.append(HostSpec(parts[0], slots))
    if not specs:
        raise LaunchError(f"hosts file {path} has no host entries")
    return specs


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pump(pid: int, pipe: IO[str], stream, lock: threading.Lock,
          prefix: bool):
    """Fan one worker's merged output into ``stream`` (supervisor seam)."""
    pump_lines(f"worker-{pid}", pipe, stream, lock, prefix)


def _worker_env(base: Dict[str, str], coordinator: str, num_processes: int,
                process_id: int, extra: Optional[Dict[str, str]]) -> dict:
    # workers must import the same package tree the supervisor runs from,
    # regardless of their cwd (the repo may not be pip-installed)
    env = inject_pythonpath(dict(base))
    if extra:
        env.update({str(k): str(v) for k, v in extra.items()})
    env["ZOO_TPU_COORDINATOR"] = coordinator
    env["ZOO_TPU_NUM_PROCESSES"] = str(num_processes)
    env["ZOO_TPU_PROCESS_ID"] = str(process_id)
    return env


def launch(script_argv: Sequence[str], num_hosts: Optional[int] = None,
           hosts_file: Optional[str] = None,
           env: Optional[Dict[str, str]] = None,
           on_failure: str = "kill-all",
           coordinator_port: Optional[int] = None,
           grace_s: float = 10.0, stream=None, prefix: bool = True,
           python: Optional[str] = None, max_restarts: int = 3,
           restart_backoff_s: float = 1.0,
           trace_dir: Optional[str] = None) -> int:
    """Run ``script_argv`` (a train script + its args) as a multi-process
    job. See module docstring for the env contract and failure policy.
    Returns the first nonzero worker exit code, or 0.

    ``trace_dir`` turns on telemetry for the launcher *and* (via the
    exported ``ZOO_TPU_TELEMETRY`` / ``ZOO_TPU_TRACE_DIR`` env) every
    worker: each process writes its own ``trace-<pid>.json`` +
    ``metrics-<pid>.json`` there, and the launcher records gang
    lifecycle events (spawn, exit, restart, drain)."""
    if trace_dir is not None:
        telemetry.configure(enabled=True, trace_dir=trace_dir,
                            service="launcher")
    if on_failure not in ("kill-all", "report", "restart"):
        raise LaunchError(
            f"on_failure must be 'kill-all', 'report' or 'restart', got "
            f"{on_failure!r}")
    if not script_argv:
        raise LaunchError("no train script given")
    if hosts_file is not None:
        specs = parse_hosts_file(hosts_file)
        remote = [s.host for s in specs if s.host not in _LOCAL_HOSTS]
        if remote:
            raise LaunchError(
                f"remote hosts not supported yet (only localhost rows "
                f"launch; got {remote}); run zoo-launch on each host with "
                f"ZOO_TPU_COORDINATOR pointing at host 0, or use "
                f"--hosts N for local multi-process")
        world = sum(s.slots for s in specs)
        if num_hosts is not None and num_hosts != world:
            raise LaunchError(
                f"--hosts {num_hosts} disagrees with hosts file "
                f"({world} slots)")
    else:
        world = num_hosts if num_hosts is not None else 1
    if world < 1:
        raise LaunchError(f"need >= 1 worker, got {world}")
    stream = stream if stream is not None else sys.stdout
    python = python or sys.executable
    base_env = dict(os.environ)

    cmd_tail = [os.fspath(a) for a in script_argv]
    lock = threading.Lock()
    attempt = 0
    while True:
        port = coordinator_port or _free_port()
        coordinator = f"127.0.0.1:{port}"
        extra_env = dict(env or {})
        if on_failure == "restart":
            # every attempt (the first included) resumes from `latest`
            # when one exists: under the restart policy the launcher —
            # not the script — owns the job's lifecycle, so a relaunch
            # of the whole zoo-launch process must also pick up where
            # the checkpoint left off. Explicit user env wins.
            extra_env.setdefault("ZOO_TPU_AUTO_RESUME", "1")
        logger.info("zoo-launch: %d worker(s), coordinator %s, "
                    "on-failure=%s%s: %s", world, coordinator, on_failure,
                    f" (attempt {attempt + 1})" if attempt else "",
                    " ".join(shlex.quote(c) for c in cmd_tail))
        telemetry.event("launch/gang_start", world=world,
                        attempt=attempt + 1, coordinator=coordinator)
        first_rc, failed_pid = _run_gang(
            cmd_tail, world, coordinator, base_env, extra_env, on_failure,
            grace_s, stream, lock, prefix, python)
        if first_rc == 0:
            telemetry.event("launch/job_complete", world=world,
                            attempts=attempt + 1)
            with lock:
                stream.write(f"[zoo-launch] job complete: {world} "
                             f"worker(s) exited 0\n")
                stream.flush()
            return 0
        if on_failure != "restart" or attempt >= max_restarts:
            telemetry.event("launch/job_failed", rc=first_rc,
                            failed_worker=failed_pid,
                            attempts=attempt + 1)
            if on_failure == "restart":
                with lock:
                    stream.write(
                        f"[zoo-launch] restarts exhausted "
                        f"({max_restarts}): giving up with rc="
                        f"{first_rc}\n")
                    stream.flush()
            return first_rc
        attempt += 1
        delay = restart_backoff_s * (2 ** (attempt - 1))
        telemetry.event("launch/gang_restart", rc=first_rc,
                        failed_worker=failed_pid, attempt=attempt,
                        delay_s=delay)
        with lock:
            stream.write(
                f"[zoo-launch] worker-{failed_pid} rc={first_rc}: "
                f"restarting gang (attempt {attempt}/{max_restarts}) "
                f"in {delay:.1f}s\n")
            stream.flush()
        time.sleep(delay)


def _run_gang(cmd_tail: List[str], world: int, coordinator: str,
              base_env: Dict[str, str], env: Optional[Dict[str, str]],
              on_failure: str, grace_s: float, stream, lock, prefix: bool,
              python: str):
    """Spawn one gang of ``world`` workers and supervise it to completion.
    Returns ``(first_rc, failed_pid)``. Under kill-all AND restart, the
    first death terminates the survivors (SPMD: the collective is dead
    once one member is gone)."""
    procs: List[subprocess.Popen] = []
    pumps: List[threading.Thread] = []
    try:
        for pid in range(world):
            sp = spawn_supervised(
                [python, "-m", "analytics_zoo_tpu_torch.launcher.worker",
                 *cmd_tail],
                env=_worker_env(base_env, coordinator, world, pid, env),
                tag=f"worker-{pid}", stream=stream, lock=lock,
                prefix=prefix)
            procs.append(sp.proc)
            pumps.append(sp.pump)
            telemetry.event("launch/worker_spawn", worker=pid,
                            os_pid=sp.proc.pid)
    except BaseException:
        _terminate_all(procs, grace_s)
        raise

    first_rc = 0
    failed_pid: Optional[int] = None
    killed = False
    pending = set(range(world))
    while pending:
        for pid in sorted(pending):
            rc = procs[pid].poll()
            if rc is None:
                continue
            pending.discard(pid)
            telemetry.event("launch/worker_exit", worker=pid, rc=rc)
            if rc != 0:
                with lock:
                    stream.write(
                        f"[zoo-launch] worker-{pid} exited rc={rc}\n")
                    stream.flush()
                if first_rc == 0:
                    first_rc, failed_pid = rc, pid
                if on_failure in ("kill-all", "restart") and not killed \
                        and pending:
                    telemetry.event("launch/terminate_survivors",
                                    n=len(pending), failed_worker=pid)
                    with lock:
                        stream.write(
                            f"[zoo-launch] on-failure={on_failure}: "
                            f"terminating {len(pending)} remaining "
                            f"worker(s)\n")
                        stream.flush()
                    _terminate_all([procs[q] for q in pending], grace_s)
                    killed = True
        if pending:
            time.sleep(0.05)
    for t in pumps:
        t.join(timeout=5.0)
    rcs = [p.returncode for p in procs]
    if first_rc != 0:
        with lock:
            stream.write(
                f"[zoo-launch] job FAILED: first failure worker-"
                f"{failed_pid} rc={first_rc}; exit codes {rcs}\n")
            stream.flush()
    return first_rc, failed_pid


def _terminate_all(procs: Sequence[subprocess.Popen], grace_s: float):
    """SIGTERM then SIGKILL after ``grace_s`` (supervisor seam)."""
    terminate_all(procs, grace_s)
