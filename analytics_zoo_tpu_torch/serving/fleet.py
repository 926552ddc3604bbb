"""ServingFleet: N supervised serving worker processes over one queue.

Counterpart of ``analytics_zoo_tpu/serving/fleet.py``, copied. What
differs is the device: the fleet starts every worker with ``--device``
(``cuda`` unless the caller asks for the CPU), and a worker that finds
no CUDA device raises instead of serving on the CPU. Workers are
spawned with ``subprocess``, so none inherits a CUDA context.

The reference scales Cluster Serving by running multiple Flink task
replicas behind Redis pub/sub; here the fleet manager composes the
pieces this repo already has:

- **supervision** comes from the launcher seam
  (:mod:`analytics_zoo_tpu_torch.launcher.supervisor`): each worker is a
  subprocess with env propagation, ``[fleet-N]``-tagged log fan-in into
  one stream, and SIGTERM→SIGKILL teardown;
- **work partitioning** is the queue backend's delivery contract: the
  file transport's atomic rename *claim* hands each record to exactly
  one worker process (queue_backend.py), so no record is double-served
  — workers share ``data.src`` and nothing else on the hot path;
- **control plane**: all workers recover the same registry manifest;
  worker 0 owns the file-RPC :class:`RegistryControlServer` (and the
  manifest writes), workers >0 follow the manifest by mtime
  (fleet_worker.py);
- **health**: every worker heartbeats an atomic JSON file under
  ``<workdir>/health/`` (pid, records served, shed count).  The
  supervise loop restarts a worker whose process died *or* whose
  heartbeat went stale past ``health_timeout`` (after a startup grace
  for interpreter + torch import and the model's load).

``zoo-serving status`` renders :func:`fleet_status` rows from the same
health files, so fleet observability needs no RPC into the workers.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..launcher.supervisor import (SupervisedProc, inject_pythonpath,
                                   spawn_supervised, terminate_all)
from ..utils import file_io, telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.fleet")

HEALTH_DIR = "health"
SUPERVISOR_FILE = "supervisor.json"
AUTOSCALE_FILE = "autoscale.json"
BACKOFF_CAP_S = 30.0


def health_path(workdir: str, worker_id: int) -> str:
    return os.path.join(workdir, HEALTH_DIR, f"worker-{worker_id}.json")


def supervisor_path(workdir: str) -> str:
    return os.path.join(workdir, HEALTH_DIR, SUPERVISOR_FILE)


def read_supervisor_state(workdir: str) -> Dict[str, dict]:
    """Per-worker restart bookkeeping the supervise loop persists
    (restarts, backoff_until, crash_looped) — keyed by worker id string."""
    try:
        with open(supervisor_path(workdir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def autoscale_path(workdir: str) -> str:
    return os.path.join(workdir, HEALTH_DIR, AUTOSCALE_FILE)


def read_autoscale_trace(workdir: str) -> List[dict]:
    """The supervisor's autoscale event trace (scale_up / scale_down
    rows with backlog, predicted wait, and worker ids) — bench legs and
    `zoo-serving status` read this."""
    try:
        with open(autoscale_path(workdir)) as f:
            return json.load(f).get("events", [])
    except (OSError, ValueError):
        return []


def write_health(workdir: str, worker_id: int, payload: dict):
    """Atomic heartbeat write (rename) — readers never see a torn file."""
    payload = dict(payload, worker_id=worker_id, ts=time.time())
    file_io.write_bytes_atomic(health_path(workdir, worker_id),
                               json.dumps(payload).encode())


def read_health(workdir: str, worker_id: int) -> Optional[dict]:
    try:
        with open(health_path(workdir, worker_id)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


#: heartbeat / stats-file age past which a *live* worker is flagged
#: stale by :func:`fleet_status` (the supervisor may not have acted yet
#: — e.g. it is down, or the worker wedged inside its health_timeout)
STALE_AFTER_S = 10.0


def _file_age_s(path: str, now: float) -> Optional[float]:
    try:
        return round(now - os.path.getmtime(path), 2)
    except OSError:
        return None


def fleet_status(workdir: str,
                 stale_after_s: float = STALE_AFTER_S) -> List[dict]:
    """Per-worker status rows from the health files: worker id, pid,
    heartbeat age, liveness (signal-0 probe), records served, shed count.
    Works from any process — `zoo-serving status` renders these.

    A row is flagged ``stale`` when the worker looks alive but its
    heartbeat or stats dump has not been refreshed within
    ``stale_after_s`` — the wedged-but-not-dead case the supervisor's
    own health_timeout may not have caught yet."""
    hdir = os.path.join(workdir, HEALTH_DIR)
    rows = []
    try:
        names = sorted(n for n in os.listdir(hdir)
                       if n.startswith("worker-") and n.endswith(".json"))
    except FileNotFoundError:
        return rows
    sup = read_supervisor_state(workdir)
    now = time.time()
    seen = set()
    for name in names:
        try:
            with open(os.path.join(hdir, name)) as f:
                h = json.load(f)
        except (OSError, ValueError):
            continue
        pid = h.get("pid")
        alive = False
        if pid:
            try:
                os.kill(int(pid), 0)
                alive = True
            except (OSError, ValueError):
                alive = False
        wid = h.get("worker_id")
        seen.add(str(wid))
        s = sup.get(str(wid), {})
        health_age = round(now - h.get("ts", 0.0), 2)
        stats_age = _file_age_s(
            os.path.join(workdir, f"stats-worker-{wid}.json"), now)
        stale = alive and (
            health_age > stale_after_s or
            (stats_age is not None and stats_age > stale_after_s))
        rows.append({
            "worker_id": wid,
            "pid": pid,
            "alive": alive,
            "health_age_s": health_age,
            "stats_age_s": stats_age,
            "stale": stale,
            "records_served": h.get("records_served", 0),
            "shed": h.get("shed", 0),
            "restarts": s.get("restarts", h.get("restarts", 0)),
            "backoff_until": s.get("backoff_until", 0.0),
            "crash_looped": s.get("crash_looped", False),
            "flight_dump": h.get("flight_dump") or s.get("flight_dump"),
        })
    # workers the supervisor is tracking that never (re)wrote a
    # heartbeat — dead in backoff, or crash-looped before first beat
    for wid, s in sorted(sup.items(), key=lambda kv: kv[0]):
        if wid in seen:
            continue
        rows.append({
            "worker_id": int(wid), "pid": None, "alive": False,
            "health_age_s": None, "stats_age_s": None, "stale": False,
            "records_served": 0, "shed": 0,
            "restarts": s.get("restarts", 0),
            "backoff_until": s.get("backoff_until", 0.0),
            "crash_looped": s.get("crash_looped", False),
            "flight_dump": s.get("flight_dump"),
        })
    rows.sort(key=lambda r: (r["worker_id"] is None, r["worker_id"]))
    return rows


def fleet_metrics(workdir: str) -> dict:
    """Merge per-worker telemetry snapshots (``metrics-worker-N.json``,
    written by each worker's metrics exporter when telemetry is on) into
    one fleet view: counters and gauges are summed by (name, labels) —
    fleet totals — while each worker's full snapshot rides along with
    its age. ``zoo-serving status`` renders this next to the health rows;
    missing/unreadable files are skipped (telemetry may be off)."""
    now = time.time()
    workers: List[dict] = []
    merged: Dict[tuple, float] = {}
    try:
        names = sorted(n for n in os.listdir(workdir)
                       if n.startswith("metrics-worker-")
                       and n.endswith(".json"))
    except FileNotFoundError:
        names = []
    for name in names:
        try:
            with open(os.path.join(workdir, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        wid = name[len("metrics-worker-"):-len(".json")]
        metrics = snap.get("metrics", [])
        workers.append({"worker_id": wid,
                        "service": snap.get("service", ""),
                        "age_s": round(now - snap.get("ts", 0.0), 2),
                        "metrics": metrics})
        for m in metrics:
            if m.get("type") not in ("counter", "gauge"):
                continue
            key = (m.get("name"),
                   tuple(sorted((m.get("labels") or {}).items())))
            merged[key] = merged.get(key, 0.0) + float(m.get("value", 0.0))
    return {"workers": workers,
            "merged": [{"name": k[0], "labels": dict(k[1]), "value": v}
                       for k, v in sorted(merged.items())]}


class ServingFleet:
    """Spawn, heartbeat-watch, and restart N serving workers.

    ``config_path`` is the standard serving ``config.yaml`` (all workers
    share it; ``data.src`` must be a cross-process transport —
    ``file:<dir>`` or redis).  Worker count and health knobs default to
    the config's ``params.workers`` / ``params.health_*``.  ``device``
    is the torch device every worker serves on (``cuda`` or ``cpu``).
    """

    def __init__(self, config_path: str, workdir: str,
                 workers: Optional[int] = None,
                 health_interval: Optional[float] = None,
                 health_timeout: Optional[float] = None,
                 grace_s: float = 5.0, startup_grace_s: float = 60.0,
                 max_restarts: Optional[int] = None,
                 restart_backoff_s: Optional[float] = None,
                 healthy_reset_s: float = 60.0,
                 stream=None, env: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 autoscale_interval: Optional[float] = None,
                 device: str = "cuda"):
        from .admission import BacklogAutoscaler
        from .cluster_serving import ClusterServingHelper

        self.config_path = os.path.abspath(config_path)
        self.workdir = os.path.abspath(workdir)
        helper = ClusterServingHelper(config_path=self.config_path)
        self.helper = helper
        self.workers = int(workers if workers is not None
                           else helper.workers)
        if self.workers < 1:
            raise ValueError(f"need >= 1 worker, got {self.workers}")
        # backlog-driven autoscaling band (docs/serving-network.md):
        # active when min < max; the initial worker count is clamped
        # into the band and then floats with load
        self.min_workers = int(min_workers if min_workers is not None
                               else helper.min_workers)
        self.max_workers = int(max_workers if max_workers is not None
                               else helper.max_workers)
        self.max_workers = max(self.max_workers, self.min_workers)
        self.workers = min(max(self.workers, self.min_workers),
                           self.max_workers)
        self.autoscale_interval = float(
            autoscale_interval if autoscale_interval is not None
            else helper.autoscale_interval)
        self.autoscaler = None
        if self.max_workers > self.min_workers:
            self.autoscaler = BacklogAutoscaler(
                self.min_workers, self.max_workers,
                target_ms=helper.autoscale_target_ms,
                scale_up_fraction=helper.scale_up_fraction,
                idle_s=helper.scale_down_idle_s,
                cooldown_s=helper.autoscale_cooldown_s)
        self._backlog_q = None       # lazy supervisor-side queue handle
        self._next_autoscale = 0.0
        self._draining: Dict[int, float] = {}   # wid -> SIGTERM ts
        self.autoscale_events: List[dict] = []
        self.health_interval = float(
            health_interval if health_interval is not None
            else helper.health_interval)
        self.health_timeout = float(
            health_timeout if health_timeout is not None
            else helper.health_timeout)
        self.grace_s = float(grace_s)
        self.startup_grace_s = float(startup_grace_s)
        # crash-loop protection: give up on a worker after max_restarts
        # consecutive restarts (counter resets after healthy_reset_s of
        # uptime); each restart waits restart_backoff_s * 2^(n-1), capped
        # at BACKOFF_CAP_S, so a fast-dying worker cannot spin the host
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else helper.max_restarts)
        self.restart_backoff_s = float(
            restart_backoff_s if restart_backoff_s is not None
            else helper.restart_backoff_s)
        self.healthy_reset_s = float(healthy_reset_s)
        self.stream = stream if stream is not None else sys.stdout
        self.env = dict(env or {})
        self.python = python or sys.executable
        self.device = str(device)
        self._lock = threading.Lock()
        self._procs: Dict[int, SupervisedProc] = {}
        self._spawned_at: Dict[int, float] = {}
        self._active: set = set(range(self.workers))   # wids desired now
        self.restarts: Dict[int, int] = {}
        self.backoff_until: Dict[int, float] = {}
        self.crash_looped: set = set()
        self.flight_dumps: Dict[int, str] = {}
        self._stop = threading.Event()
        os.makedirs(os.path.join(self.workdir, HEALTH_DIR), exist_ok=True)

    # -- lifecycle ------------------------------------------------------
    def _worker_env(self, worker_id: int) -> dict:
        env = inject_pythonpath(dict(os.environ))
        env.update(self.env)
        env["ZOO_SERVING_WORKER_ID"] = str(worker_id)
        env["ZOO_SERVING_FLEET_SIZE"] = str(self.workers)
        env["ZOO_SERVING_WORKER_RESTARTS"] = str(
            self.restarts.get(worker_id, 0))
        return env

    def _spawn(self, worker_id: int):
        # drop the previous heartbeat so a freshly restarted worker is
        # not judged by its predecessor's stale file
        try:
            os.remove(health_path(self.workdir, worker_id))
        except OSError:
            pass
        cmd = [self.python, "-m",
               "analytics_zoo_tpu_torch.serving.fleet_worker",
               "--config", self.config_path, "--workdir", self.workdir,
               "--worker-id", str(worker_id), "--device", self.device]
        sp = spawn_supervised(cmd, env=self._worker_env(worker_id),
                              tag=f"fleet-{worker_id}", stream=self.stream,
                              lock=self._lock, prefix=True)
        self._procs[worker_id] = sp
        self._spawned_at[worker_id] = time.time()
        logger.info("fleet: worker-%d spawned (pid %d)", worker_id,
                    sp.proc.pid)

    def start(self) -> "ServingFleet":
        self._stop.clear()
        self._active = set(range(self.workers))
        for wid in sorted(self._active):
            self._spawn(wid)
        return self

    def _write_supervisor_state(self):
        state = {}
        for wid in set(self.restarts) | set(self.backoff_until) | \
                self.crash_looped:
            state[str(wid)] = {
                "restarts": self.restarts.get(wid, 0),
                "backoff_until": self.backoff_until.get(wid, 0.0),
                "crash_looped": wid in self.crash_looped,
            }
            if wid in self.flight_dumps:
                state[str(wid)]["flight_dump"] = self.flight_dumps[wid]
        file_io.write_bytes_atomic(supervisor_path(self.workdir),
                                   json.dumps(state).encode())

    def poll_once(self) -> List[int]:
        """One supervision pass: restart workers whose process exited or
        whose heartbeat is stale — with per-worker exponential backoff
        and a crash-loop cap.  Returns the worker ids respawned."""
        restarted = []
        now = time.time()
        # reap scaled-down workers: SIGTERM'd workers drain their
        # pipeline and exit — their death is the *goal*, not a crash
        for wid, since in list(self._draining.items()):
            sp = self._procs.get(wid)
            if sp is None:
                self._draining.pop(wid, None)
                continue
            if sp.proc.poll() is not None:
                del self._procs[wid]
                self._draining.pop(wid, None)
                self._forget_worker(wid)
                with self._lock:
                    self.stream.write(
                        f"[fleet] worker-{wid} drained and stopped "
                        f"(scale down)\n")
                    self.stream.flush()
            elif now - since > max(self.grace_s, 10.0):
                terminate_all([sp.proc], grace_s=0.0)   # drain overdue
        # phase 2 of a restart: respawn workers whose backoff elapsed
        for wid, until in list(self.backoff_until.items()):
            if self._stop.is_set() or wid in self._procs or \
                    wid not in self._active:
                continue
            if now >= until:
                del self.backoff_until[wid]
                self._spawn(wid)
                restarted.append(wid)
        if restarted:
            self._write_supervisor_state()
        for wid, sp in list(self._procs.items()):
            if wid in self._draining:
                continue
            rc = sp.proc.poll()
            stale = False
            if rc is None:
                h = read_health(self.workdir, wid)
                age = now - h["ts"] if h else now - self._spawned_at[wid]
                grace = (self.startup_grace_s if h is None
                         else self.health_timeout)
                stale = age > max(grace, self.health_timeout)
            if rc is None and not stale:
                continue
            if self._stop.is_set():
                continue
            reason = (f"exited rc={rc}" if rc is not None
                      else "heartbeat stale")
            if now - self._spawned_at.get(wid, now) >= self.healthy_reset_s:
                # a long-healthy worker dying is not a crash loop
                self.restarts[wid] = 0
            self.restarts[wid] = self.restarts.get(wid, 0) + 1
            if rc is None:
                terminate_all([sp.proc], self.grace_s)
            del self._procs[wid]
            if self.restarts[wid] > self.max_restarts:
                self.crash_looped.add(wid)
                # post-mortem: dump the supervisor's own flight recorder
                # (it saw every restart event) and stamp the path into
                # supervisor.json so `zoo-serving status` can point at it
                telemetry.event("fleet/crash_loop", worker_id=wid,
                                restarts=self.restarts[wid], reason=reason)
                dump = telemetry.dump_flight(
                    f"fleet worker-{wid} crash loop ({reason})")
                if dump:
                    self.flight_dumps[wid] = dump
                with self._lock:
                    self.stream.write(
                        f"[fleet] worker-{wid} {reason}; crash loop "
                        f"(> {self.max_restarts} restarts), giving up"
                        + (f" (flight recorder: {dump})" if dump else "")
                        + "\n")
                    self.stream.flush()
                self._write_supervisor_state()
                continue
            delay = min(BACKOFF_CAP_S,
                        self.restart_backoff_s *
                        (2 ** (self.restarts[wid] - 1)))
            self.backoff_until[wid] = now + delay
            with self._lock:
                self.stream.write(
                    f"[fleet] worker-{wid} {reason}; restarting "
                    f"(restart #{self.restarts[wid]}) in {delay:.1f}s\n")
                self.stream.flush()
            self._write_supervisor_state()
        return restarted

    # -- backlog-driven autoscaling (docs/serving-network.md) -----------
    def _forget_worker(self, wid: int):
        """Scale-down bookkeeping: drop every trace of a retired worker
        so status/supervisor state don't show ghost rows."""
        self.restarts.pop(wid, None)
        self.backoff_until.pop(wid, None)
        self.crash_looped.discard(wid)
        self.flight_dumps.pop(wid, None)
        try:
            os.remove(health_path(self.workdir, wid))
        except OSError:
            pass
        # routed records parked on the retired worker's private generate
        # substream go back to the shared any-claim stream — placement
        # must never strand work (serving/routing.py)
        src = self.helper.src or ""
        if src.startswith("file:"):
            from .routing import sweep_substream

            try:
                n = sweep_substream(src[len("file:"):], wid)
                if n:
                    with self._lock:
                        self.stream.write(
                            f"[fleet] worker-{wid} substream swept: "
                            f"{n} routed record(s) back on the shared "
                            f"stream\n")
                        self.stream.flush()
            except OSError:
                pass
        self._write_supervisor_state()

    def _queue_backlog(self) -> Optional[int]:
        """stream_len() through a supervisor-side handle on the shared
        transport; None when the transport is unreadable from here
        (inproc/redis src, or the broker is down this tick)."""
        if self._backlog_q is None:
            src = self.helper.src or ""
            # shard:// sums stream_len across every healthy shard
            # (ShardedStreamQueue.stream_len), so scale-up sizing sees
            # the whole fabric's backlog, not one broker's
            if not (src.startswith("file:") or src.startswith("socket://")
                    or src.startswith("shard://")):
                return None
            from .queue_backend import get_queue_backend

            self._backlog_q = get_queue_backend(src)
        try:
            return int(self._backlog_q.stream_len())
        except Exception:  # noqa: BLE001 - broker briefly unreachable
            return None

    def _ewma_estimates(self) -> tuple:
        """(record_ms, batch_ms): mean of the positive EWMA service
        estimates the workers publish in their heartbeats."""
        rec, bat = [], []
        for wid in list(self._active):
            adm = (read_health(self.workdir, wid) or {}).get(
                "admission") or {}
            r = float(adm.get("est_record_ms") or 0.0)
            b = float(adm.get("est_batch_ms") or 0.0)
            if r > 0:
                rec.append(r)
            if b > 0:
                bat.append(b)
        return (sum(rec) / len(rec) if rec else 0.0,
                sum(bat) / len(bat) if bat else 0.0)

    def _generate_load(self) -> tuple:
        """(gen_steps, token_ms): queued decode-step backlog summed over
        the workers' heartbeat routing reports, and the mean positive
        EWMA per-token cost — the generate-aware inputs the autoscaler
        weighs so one queued 512-token essay no longer sizes like one
        predict record (docs/serving-generate.md#fleet-routing)."""
        steps = 0.0
        toks = []
        for wid in list(self._active):
            h = read_health(self.workdir, wid) or {}
            routing = h.get("routing") or {}
            steps += float(routing.get("queued_steps") or 0.0)
            t = float((h.get("admission") or {}).get(
                "est_token_ms") or 0.0)
            if t > 0:
                toks.append(t)
        return steps, (sum(toks) / len(toks) if toks else 0.0)

    def _routed_backlog(self) -> int:
        """Unclaimed records parked on per-worker generate substreams —
        invisible to the shared stream's ``stream_len`` but real
        backlog for scale-up sizing."""
        src = self.helper.src or ""
        if not src.startswith("file:"):
            return 0
        from .routing import substream_backlog

        return substream_backlog(src[len("file:"):])

    def _note_autoscale(self, action: str, wids: List[int], reason: str,
                        backlog: int, wait_ms: float):
        event = {"ts": time.time(), "action": action, "workers": wids,
                 "active": len(self._active), "backlog": backlog,
                 "predicted_wait_ms": round(wait_ms, 1), "reason": reason}
        self.autoscale_events.append(event)
        # literal names only (scripts/lint-telemetry): the action rides
        # as an arg, not in the event name
        telemetry.event("fleet/autoscale", **{k: v for k, v in
                                              event.items() if k != "ts"})
        telemetry.gauge("zoo_fleet_workers").set(len(self._active))
        file_io.write_bytes_atomic(
            autoscale_path(self.workdir),
            json.dumps({"min_workers": self.min_workers,
                        "max_workers": self.max_workers,
                        "active": len(self._active),
                        "events": self.autoscale_events}).encode())
        with self._lock:
            self.stream.write(
                f"[fleet] {action} -> {len(self._active)} workers "
                f"({'+' if action == 'scale_up' else '-'}"
                f"{wids}): {reason}\n")
            self.stream.flush()

    def autoscale_once(self, now: Optional[float] = None) -> bool:
        """One autoscale decision tick (no-op unless min < max): poll
        the shared stream's backlog + the workers' EWMA estimates, and
        grow/shrink toward the policy's desired count.  Scale-down is
        drain-before-kill: the retiring worker gets SIGTERM, finishes
        its in-flight records, and only then is reaped (poll_once).
        Returns True when the fleet changed size."""
        if self.autoscaler is None or self._stop.is_set():
            return False
        now = time.time() if now is None else now
        if now < self._next_autoscale:
            return False
        self._next_autoscale = now + self.autoscale_interval
        backlog = self._queue_backlog()
        if backlog is None:
            return False
        backlog += self._routed_backlog()
        record_ms, batch_ms = self._ewma_estimates()
        gen_steps, token_ms = self._generate_load()
        current = len(self._active)
        desired, reason = self.autoscaler.desired(
            backlog, record_ms, batch_ms, current, now,
            gen_steps=gen_steps, token_ms=token_ms)
        if reason is None or desired == current:
            return False
        wait_ms = self.autoscaler.predicted_wait_ms(
            backlog, record_ms, batch_ms, current,
            gen_steps=gen_steps, token_ms=token_ms)
        if desired > current:
            added = []
            for wid in range(self.max_workers):
                if len(self._active) >= desired:
                    break
                if wid in self._active or wid in self._draining:
                    continue
                self._active.add(wid)
                self.restarts.pop(wid, None)
                self.backoff_until.pop(wid, None)
                self.crash_looped.discard(wid)
                self._spawn(wid)
                added.append(wid)
            if added:
                self._note_autoscale("scale_up", added, reason,
                                     backlog, wait_ms)
            return bool(added)
        removed = []
        for wid in sorted(self._active, reverse=True):
            if len(self._active) <= desired:
                break
            self._active.discard(wid)
            sp = self._procs.get(wid)
            if sp is not None and sp.proc.poll() is None:
                self._draining[wid] = now
                try:
                    sp.proc.terminate()   # SIGTERM: drain, then exit
                except OSError:
                    pass
            else:
                # dead / in backoff: nothing in flight to drain
                if sp is not None:
                    self._procs.pop(wid, None)
                self._forget_worker(wid)
            removed.append(wid)
        if removed:
            self._note_autoscale("scale_down", removed, reason,
                                 backlog, wait_ms)
        return bool(removed)

    def supervise(self, poll_s: float = 0.25):
        """Block supervising until :meth:`stop` (or KeyboardInterrupt)."""
        try:
            while not self._stop.is_set():
                self.poll_once()
                self.autoscale_once()
                if self._stop.wait(poll_s):
                    break
        finally:
            self.shutdown()

    def wait_healthy(self, timeout: float = 60.0) -> bool:
        """Block until every worker has written a heartbeat (i.e. its
        serve loop is up), or ``timeout`` elapses."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(read_health(self.workdir, w) is not None
                   for w in sorted(self._active)):
                return True
            time.sleep(0.05)
        return False

    def stop(self):
        self._stop.set()

    def shutdown(self):
        """SIGTERM every worker (they drain their pipelines), SIGKILL
        stragglers after the grace period."""
        self._stop.set()
        terminate_all([sp.proc for sp in self._procs.values()],
                      self.grace_s)
        for sp in self._procs.values():
            sp.pump.join(timeout=5.0)

    # -- observability --------------------------------------------------
    def status(self) -> List[dict]:
        return fleet_status(self.workdir)

    def metrics(self) -> dict:
        return fleet_metrics(self.workdir)

    def worker_stats(self) -> List[dict]:
        """Per-worker pipeline_stats() snapshots (from each worker's
        stats-worker-N.json dump); missing/unreadable files are skipped."""
        out = []
        for wid in range(max(self.workers, self.max_workers)):
            path = os.path.join(self.workdir, f"stats-worker-{wid}.json")
            try:
                with open(path) as f:
                    out.append(dict(json.load(f), worker_id=wid))
            except (OSError, ValueError):
                continue
        return out
