"""Fault injection for the chaos harness.

Counterpart of ``analytics_zoo_tpu/utils/faults.py``, copied: the same
``ZOO_TPU_FAULT`` specs and ``ZOO_TPU_FAULT_STATE`` markers, so one
environment arms both packages. The port's trainer reads the ``step``
and ``ckpt-write`` sites and the ``step:nan`` / ``grad:nan`` poison sites
(``SPMDTrainer._maybe_poison``, caught by the health monitor's
sentinel), and :mod:`file_io` the ``file-io`` one.

Faults are armed from the environment so the *production* code path is
exercised unmodified — the hooks below are permanent, tiny, and inert
unless ``ZOO_TPU_FAULT`` is set:

    ZOO_TPU_FAULT=<site>:<action>@<arg>[;<site>:<action>@<arg>...]

Sites and the specs they accept:

``step:kill@N``
    SIGKILL this process the first time the training step counter
    reaches ``N`` (fires at-or-after ``N`` so multi-step dispatch
    cannot jump over it). One-shot.
``ckpt-write:kill@K`` / ``ckpt-write:raise@K``
    During the ``K``-th checkpoint save of this job, crash *mid-file*:
    a truncated prefix of the second file is written, then the process
    is SIGKILLed (``kill``) or an :class:`FaultInjected` OSError is
    raised (``raise``). Proves partial writes are never visible to
    restore. One-shot.
``file-io:transient@N``
    The first ``N`` ``file_io`` byte reads/writes raise
    :class:`TransientFault` (an ``OSError``), exercising the bounded
    retry in :mod:`utils.file_io`.
``step:nan@N`` / ``grad:nan@N``
    Poison the training inputs (``step``) or one parameter leaf
    (``grad``) with NaN for the dispatch that covers step ``N`` (fires
    at-or-after ``N``; inside a fused k-step dispatch exactly the
    covered step's slice is poisoned). The NaN then flows through the
    REAL compiled step — loss (and grad norm) go non-finite on device —
    so the health monitor's detect→dump→halt ladder
    (:mod:`pipeline.health`) is exercised end-to-end. One-shot.
``infeed-worker:kill@N``
    SIGKILL an infeed transform worker (ProcessTransformPool) the first
    time its per-process item counter reaches ``N`` — mid-epoch, after
    some batches have already shipped. The pool's workers race for a
    single exclusive marker so exactly one worker dies, and the
    respawned replacement never re-fires. Requires
    ``ZOO_TPU_FAULT_STATE`` (the workers are separate processes; the
    marker is the only shared state).

One-shot faults must not re-fire after a gang restart (the relaunched
worker reaches step ``N`` again and would die forever). Point
``ZOO_TPU_FAULT_STATE`` at a directory shared across restarts: a fault
that fires drops a marker file there and later processes skip it.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ENV_SPEC = "ZOO_TPU_FAULT"
ENV_STATE = "ZOO_TPU_FAULT_STATE"


class FaultInjected(OSError):
    """Raised by an armed ``raise``-action fault (deliberate failure)."""


class TransientFault(OSError):
    """A retryable injected IO error (``file-io:transient@N``)."""


@dataclass
class _Spec:
    site: str
    action: str
    arg: int
    raw: str
    fired: bool = False
    io_count: int = 0
    save_index: int = 0
    writes_in_save: int = 0


_LOCK = threading.Lock()
_CACHE: Dict[str, object] = {"env": None, "specs": []}


def _parse(env: str) -> List[_Spec]:
    specs = []
    for part in env.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            site, rest = part.split(":", 1)
            action, arg = rest.split("@", 1)
            specs.append(_Spec(site=site.strip(), action=action.strip(),
                               arg=int(arg), raw=part))
        except ValueError:
            raise ValueError(
                f"bad {ENV_SPEC} spec {part!r}: expected "
                "<site>:<action>@<int> (e.g. step:kill@5)")
    return specs


def _specs() -> List[_Spec]:
    env = os.environ.get(ENV_SPEC, "")
    with _LOCK:
        if env != _CACHE["env"]:
            _CACHE["env"] = env
            _CACHE["specs"] = _parse(env) if env else []
        return list(_CACHE["specs"])  # type: ignore[arg-type]


def reset() -> None:
    """Drop parsed-spec state (tests re-arm via monkeypatched env)."""
    with _LOCK:
        _CACHE["env"] = None
        _CACHE["specs"] = []


def _marker_path(spec: _Spec) -> Optional[str]:
    state = os.environ.get(ENV_STATE)
    if not state:
        return None
    safe = spec.raw.replace(":", "_").replace("@", "_").replace("/", "_")
    return os.path.join(state, f"fired.{safe}")


def _already_fired(spec: _Spec) -> bool:
    if spec.fired:
        return True
    marker = _marker_path(spec)
    return marker is not None and os.path.exists(marker)


def _record_fired(spec: _Spec) -> None:
    spec.fired = True
    marker = _marker_path(spec)
    if marker is not None:
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with open(marker, "w") as f:
            f.write("1")


def _claim_exclusive(spec: _Spec) -> bool:
    """Atomically claim a one-shot fault across *processes*.

    Returns True for exactly one caller (exclusive marker create); every
    other process — including respawned replacements of the victim —
    loses the race and skips the fault. Without ``ZOO_TPU_FAULT_STATE``
    there is no cross-process state, so the claim degrades to
    per-process one-shot (a respawned worker would fire again).
    """
    marker = _marker_path(spec)
    if marker is None:
        if spec.fired:
            return False
        spec.fired = True
        return True
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(str(os.getpid()))
    spec.fired = True
    return True


# literal event name per site: telemetry names must never be built by
# interpolation (scripts/lint-telemetry enforces this repo-wide — a
# cardinality-bounded name set is what makes the trace queryable)
_FLIGHT_EVENTS = {
    "step": "fault/step",
    "grad": "fault/grad",
    "ckpt-write": "fault/ckpt-write",
    "file-io": "fault/file-io",
    "infeed-worker": "fault/infeed-worker",
}


def _flight(spec: _Spec, detail: str, **args) -> None:
    """Leave post-mortem evidence before a fatal fault fires: an instant
    event naming the site, then the flight-recorder dump
    (``debug/flight-<pid>-<ts>.json`` — last-N spans + metrics). No-op
    when telemetry is disabled; never masks the fault itself."""
    try:
        from . import telemetry
        name = _FLIGHT_EVENTS.get(spec.site, "fault/other")
        telemetry.event(name, site=spec.site, action=spec.action,
                        arg=spec.arg, **args)
        telemetry.dump_flight(f"ZOO_TPU_FAULT {spec.raw}: {detail}")
    except Exception:  # noqa: BLE001 - the fault must still fire
        pass


def _die(spec: _Spec, detail: str) -> None:
    # SIGKILL: no handlers, no atexit, no flush — the honest crash.
    sys.stderr.write(f"[faults] firing {spec.raw}: {detail}\n")
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def check(site: str, step: Optional[int] = None) -> None:
    """Hook for point sites (``step``, ``file-io``). Cheap when unarmed."""
    for spec in _specs():
        if spec.site != site:
            continue
        if site == "step":
            if spec.action == "nan":
                continue  # armed via poison_step(), not the post-hook
            if step is not None and step >= spec.arg \
                    and not _already_fired(spec):
                _record_fired(spec)
                _flight(spec, f"step {step} >= {spec.arg}", step=step)
                if spec.action == "kill":
                    _die(spec, f"step {step} >= {spec.arg}")
                raise FaultInjected(f"injected failure at step {step} "
                                    f"({spec.raw})")
        elif site == "infeed-worker":
            if step is not None and step >= spec.arg \
                    and not _already_fired(spec) and _claim_exclusive(spec):
                _flight(spec, f"infeed item {step} >= {spec.arg}",
                        item=step)
                if spec.action == "kill":
                    _die(spec, f"infeed item {step} >= {spec.arg}")
                raise FaultInjected(f"injected infeed failure at item "
                                    f"{step} ({spec.raw})")
        elif site == "file-io":
            if spec.action == "transient":
                with _LOCK:
                    spec.io_count += 1
                    n = spec.io_count
                if n <= spec.arg:
                    # transient faults are retried, not fatal: event
                    # only, no flight dump
                    try:
                        from . import telemetry
                        telemetry.event("fault/file-io", action="transient",
                                        n=n, arg=spec.arg)
                    except Exception:  # noqa: BLE001
                        pass
                    raise TransientFault(
                        f"injected transient IO error {n}/{spec.arg} "
                        f"({spec.raw})")


def _nan_target(site: str, step_before: int, n_steps: int) -> Optional[int]:
    """Shared arming logic for the ``nan`` poison sites: if a
    ``<site>:nan@N`` spec covers the dispatch spanning steps
    ``(step_before, step_before + n_steps]``, claim it one-shot and
    return the 0-based slice index to poison, else ``None``."""
    for spec in _specs():
        if spec.site != site or spec.action != "nan":
            continue
        if step_before + n_steps < spec.arg or _already_fired(spec):
            continue
        _record_fired(spec)
        rel = min(max(spec.arg - step_before - 1, 0), n_steps - 1)
        _flight(spec, f"poisoning {site} for step "
                      f"{step_before + rel + 1}", step=step_before + rel + 1)
        return rel
    return None


def poison_step(step_before: int, n_steps: int) -> Optional[int]:
    """``step:nan@N``: which slice of the upcoming dispatch's inputs to
    NaN-poison (0-based, ``None`` when unarmed). The engine applies the
    poison to the batch so the compiled step computes a real NaN loss."""
    return _nan_target("step", step_before, n_steps)


def poison_grad(step_before: int, n_steps: int) -> bool:
    """``grad:nan@N``: True when the upcoming dispatch should run with a
    NaN-poisoned parameter leaf (drives grad norm — and loss — non-finite
    through the real backward pass)."""
    return _nan_target("grad", step_before, n_steps) is not None


def begin_save() -> None:
    """Mark the start of a checkpoint save (counts ``ckpt-write`` args)."""
    for spec in _specs():
        if spec.site == "ckpt-write":
            spec.save_index += 1
            spec.writes_in_save = 0


def checked_write(path: str, data: bytes,
                  writer: Callable[[str, bytes], None]) -> None:
    """Write one checkpoint file, honouring an armed ``ckpt-write`` fault:
    on fire, a truncated prefix is written in place of the file, then the
    process dies (``kill``) or :class:`FaultInjected` is raised."""
    for spec in _specs():
        if spec.site != "ckpt-write" or _already_fired(spec):
            continue
        spec.writes_in_save += 1
        # crash on the 2nd file of the target save: mid-checkpoint, with
        # at least one complete-looking file already on disk
        if spec.save_index == spec.arg and spec.writes_in_save == 2:
            _record_fired(spec)
            writer(path, data[: max(1, len(data) // 2)])
            _flight(spec, f"mid-write of {path}", path=path)
            if spec.action == "kill":
                _die(spec, f"mid-write of {path}")
            raise FaultInjected(
                f"injected crash mid-write of {path} ({spec.raw})")
    writer(path, data)
