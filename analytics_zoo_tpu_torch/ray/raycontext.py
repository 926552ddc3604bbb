"""RayContext: the distributed-task runtime (RayOnSpark equivalent).

Counterpart of ``analytics_zoo_tpu/ray/raycontext.py``. Reference:
``pyzoo/zoo/ray/util/raycontext.py:192`` boots a Ray cluster inside a
Spark app: partition 0 runs ``ray start --head``, the other barrier tasks
run raylets, the driver joins via ``ray.init(redis_address)``, and
JVMGuard ties process lifetimes to the executors (:32-51, :155-189).

Here the runtime is:

* a **per-host worker pool** of spawned Python processes fed by a work
  queue (the raylet equivalent), sized like the reference (``num_nodes``
  x ``cores_per_node``). Workers are spawned, never forked: CUDA cannot be
  used in a forked child;
* a **device per worker**: ``platform`` None (the default) puts every
  worker on the card (``cuda``; several workers share one card), ``"cpu"``
  on the CPU, ``"cuda:N"`` on card N. Each worker passes that device to
  ``init_nncontext(device=...)`` before it takes a task, so a task's
  models and tensors land there;
* a **driver API** in the Ray style: ``ctx.remote(fn)`` ->
  ``handle.remote(*args)`` -> ``ObjectRef`` -> ``ctx.get(ref)``. Tasks and
  results travel as cloudpickle blobs where cloudpickle can be imported,
  so closures ship to workers; without it (the card's machine has none)
  they travel through the standard ``pickle``, which takes module-level
  functions and classes and refuses a lambda or closure with a
  ``TypeError`` naming cloudpickle;
* **lifecycle guards** (process.py): a parent-death watch in every worker
  and an atexit/SIGTERM sweep in the driver, replacing JVMGuard and
  ProcessMonitor.

AutoML (``analytics_zoo_tpu_torch.automl``) schedules its trials on this
runtime.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

from .process import ProcessGuard, ProcessMonitor

logger = logging.getLogger("analytics_zoo_tpu_torch.ray")

_global_ray_context: Optional["RayContext"] = None


class _StdPickle:
    """The standard ``pickle`` behind cloudpickle's two calls."""

    @staticmethod
    def dumps(obj) -> bytes:
        try:
            return pickle.dumps(obj)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"cannot ship {obj!r} to a worker with the standard pickle "
                f"({e}): a lambda, closure or locally defined object needs "
                f"cloudpickle, which is not installed; use a module-level "
                f"function or class") from e

    loads = staticmethod(pickle.loads)


def _serializer():
    """cloudpickle where it can be imported, else :class:`_StdPickle`."""
    try:
        import cloudpickle
    except ImportError:
        return _StdPickle
    return cloudpickle


def _worker_device(platform: Optional[str]) -> str:
    """The torch device a worker of ``platform`` runs on: None, ``"cuda"``
    or ``"gpu"`` -> the card, ``"cpu"`` -> the CPU, ``"cuda:N"`` as it
    is."""
    if platform is None or platform in ("cuda", "gpu"):
        return "cuda"
    if platform == "cpu" or platform.startswith("cuda:"):
        return platform
    raise ValueError(f"unknown worker platform {platform!r} (None or "
                     f"'cuda' for the card, 'cpu', or 'cuda:N')")


def _init_worker(parent_pid, platform, env):
    """A worker's start: the parent-death guard, the caller's environment,
    then the device (``init_nncontext(device=...)``)."""
    ProcessGuard(parent_pid).start()
    if env:
        os.environ.update(env)
    from ..common import nncontext
    nncontext.init_nncontext(device=_worker_device(platform))


def get_ray_context() -> Optional["RayContext"]:
    return _global_ray_context


class ObjectRef:
    """Future handle for a submitted task (ray.ObjectRef equivalent)."""

    __slots__ = ("task_id",)

    def __init__(self, task_id: str):
        self.task_id = task_id

    def __repr__(self):
        return f"ObjectRef({self.task_id[:8]})"


class RemoteFunction:
    """``ctx.remote(fn)`` wrapper: ``.remote(*args)`` submits a task."""

    def __init__(self, ctx: "RayContext", fn: Callable,
                 num_returns: int = 1):
        if num_returns != 1:
            raise NotImplementedError(
                "num_returns != 1 is not supported; return a tuple and "
                "index it after get()")
        self._ctx = ctx
        self._fn = fn

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._ctx._submit(self._fn, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError("Remote functions must be invoked with .remote()")


class ActorMethod:
    """Bound remote method: ``handle.incr.remote(1) -> ObjectRef``."""

    __slots__ = ("_handle", "_name")

    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._handle._ctx._submit_actor(
            self._handle._actor_id, self._name, args, kwargs)


class ActorHandle:
    """Stateful remote object (ray actor parity). Method calls execute
    serially in the actor's dedicated process, preserving state."""

    def __init__(self, ctx: "RayContext", actor_id: str):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):  # handles are not transferable between hosts
        raise TypeError("ActorHandle cannot be serialized")


class ActorClass:
    """``ctx.remote(SomeClass)`` wrapper: ``SomeClass.remote(*args)``
    constructs the actor in its own worker process."""

    def __init__(self, ctx: "RayContext", cls: type):
        self._ctx = ctx
        self._cls = cls

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._ctx._create_actor(self._cls, args, kwargs)


def _actor_main(parent_pid, cls_blob, init_blob, ready_id, task_q,
                result_q, platform, env):
    cloudpickle = _serializer()
    try:
        _init_worker(parent_pid, platform, env)
        cls = cloudpickle.loads(cls_blob)
        args, kwargs = cloudpickle.loads(init_blob)
        instance = cls(*args, **kwargs)
        result_q.put((ready_id, True, cloudpickle.dumps(None)))
    except BaseException as e:  # noqa: BLE001
        result_q.put((ready_id, False,
                      f"{type(e).__name__}: {e}\n"
                      f"{traceback.format_exc()}"))
        return
    while True:
        item = task_q.get()
        if item is None:
            break
        task_id, method, args_blob = item
        try:
            args, kwargs = cloudpickle.loads(args_blob)
            result = getattr(instance, method)(*args, **kwargs)
            result_q.put((task_id, True, cloudpickle.dumps(result)))
        except BaseException as e:  # noqa: BLE001
            result_q.put((task_id, False,
                          f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}"))


class RemoteTaskError(RuntimeError):
    """A task raised in the worker; carries the remote traceback."""


class WorkerLostError(RemoteTaskError):
    """The worker executing a task died (SIGKILL/OOM) before finishing.

    Distinct from :class:`RemoteTaskError` so callers can tell "the task
    raised" (retrying is pointless) from "the task's process was killed
    under it" (requeueing is safe) — the AutoML executor requeues lost
    trial segments exactly once on this type."""


#: sentinel ``ok`` value on the result queue: "worker <pid> picked up
#: task <id>" — lets the driver attribute in-flight tasks to pids so a
#: SIGKILLed worker's task can be resolved as lost instead of hanging.
_STARTED = "__started__"


def _worker_main(worker_id: int, parent_pid: int, task_q, result_q,
                 platform: Optional[str], env: Optional[Dict[str, str]]):
    _init_worker(parent_pid, platform, env)
    cloudpickle = _serializer()

    while True:
        item = task_q.get()
        if item is None:
            break
        task_id, fn_blob, args_blob = item
        # claim marker BEFORE executing: if this process is killed
        # mid-task, the driver's liveness sweep knows which task died
        # with it (and resolves its ref as WorkerLostError)
        result_q.put((task_id, _STARTED, os.getpid()))
        try:
            fn = cloudpickle.loads(fn_blob)
            args, kwargs = cloudpickle.loads(args_blob)
            result = fn(*args, **kwargs)
            result_q.put((task_id, True,
                          cloudpickle.dumps(result)))
        except BaseException as e:  # noqa: BLE001 - report, don't die
            result_q.put((task_id, False,
                          f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}"))


class RayContext:
    """Boot and drive the per-host worker pool.

    Parameters mirror the reference's surface where they make sense:
    ``num_ray_nodes`` x ``ray_node_cpu_cores`` sizes the pool (reference:
    executors x cores); ``platform`` is the workers' device (None: the
    card; tests pass ``"cpu"``).
    """

    def __init__(self, num_ray_nodes: int = 2, ray_node_cpu_cores: int = 1,
                 platform: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 object_store_memory: Optional[int] = None,
                 listen: Optional[tuple] = None,
                 authkey: Optional[bytes] = None, **_compat):
        self.num_workers = max(1, num_ray_nodes * ray_node_cpu_cores)
        _worker_device(platform)   # an unknown platform raises here
        self.platform = platform
        self.env = dict(env or {})
        # cross-host: listen=("0.0.0.0", port) accepts worker hosts
        # (ray/cluster.py; reference raylets joining the head). The
        # authkey is generated per cluster when not supplied — read it
        # from .cluster_authkey and pass it to worker hosts.
        self._listen = listen
        self.cluster_authkey = authkey
        self._cluster = None
        self.stopped = True
        self._monitor = ProcessMonitor()
        self._procs: List[mp.Process] = []
        self._task_q = None
        self._result_q = None
        self._results: Dict[str, Any] = {}
        self._results_lock = threading.Lock()
        self._pending: set = set()
        self._inflight: Dict[str, int] = {}   # task_id -> worker pid
        self._lost_tasks: set = set()         # force-resolved as lost
        # dispatched-but-unclaimed local-queue tasks, in dispatch order:
        # task_id -> dispatch seq.  A worker SIGKILLed between
        # task_q.get() and its feeder thread flushing the _STARTED
        # marker consumes a task that never reaches _inflight; these
        # fields let _sweep_lost_workers resolve it instead of hanging.
        self._dispatched: Dict[str, int] = {}
        self._dispatch_seq = 0
        self._max_claimed_seq = 0
        self._dead_pids: set = set()          # local worker pids swept
        self._unclaimed_deaths = 0            # deaths with no claimed task
        self._unclaimed_death_at = 0.0
        # actor_id -> ("local", proc, task_q) | ("remote", RemoteHost)
        #            | ("lost", reason)
        self._actors: Dict[str, Any] = {}
        self._actor_tasks: Dict[str, set] = {}   # actor_id -> open task_ids

    # ------------------------------------------------------------------
    def init(self) -> "RayContext":
        global _global_ray_context
        if not self.stopped:
            return self
        ctx = mp.get_context("spawn")  # CUDA cannot run in a forked child
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._inflight.clear()
        self._lost_tasks.clear()
        self._dispatched.clear()
        self._dispatch_seq = 0
        self._max_claimed_seq = 0
        self._dead_pids.clear()
        self._unclaimed_deaths = 0
        parent = os.getpid()
        for i in range(self.num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(i, parent, self._task_q, self._result_q,
                      self.platform, self.env),
                daemon=True, name=f"zoo-ray-worker-{i}")
            p.start()
            self._procs.append(p)
            self._monitor.register(p)
        self.stopped = False
        if self._listen is not None:
            from .cluster import ClusterListener, generate_authkey
            if self.cluster_authkey is None:
                self.cluster_authkey = generate_authkey()
            self._cluster = ClusterListener(
                tuple(self._listen), self._result_q,
                authkey=self.cluster_authkey,
                requeue=self._dispatch_local,
                on_host_lost=self._on_host_lost)
        _global_ray_context = self
        logger.info("RayContext: %d workers up", self.num_workers)
        return self

    def stop(self):
        global _global_ray_context
        if self.stopped:
            return
        if self._cluster is not None:
            self._cluster.close()
            self._cluster = None
        for actor_id in list(self._actors):
            self.kill(ActorHandle(self, actor_id))
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except Exception:  # noqa: BLE001
                break
        self._monitor.shutdown()
        self._procs = []
        self.stopped = True
        if _global_ray_context is self:
            _global_ray_context = None

    # ------------------------------------------------------------------
    def remote(self, fn: Callable = None, **opts):
        """Decorator/wrapper. Functions become :class:`RemoteFunction`s;
        classes become :class:`ActorClass`es (ray.remote parity)."""
        if fn is None:
            return lambda f: self.remote(f, **opts)
        if isinstance(fn, type):
            return ActorClass(self, fn)
        return RemoteFunction(self, fn)

    def _pick_actor_host(self):
        """Placement: balance actors across the head and the joined hosts
        by actor count (reference: the sharded PS spreads its shard actors
        cluster-wide, sharded_parameter_server.ipynb). Returns a
        RemoteHost or None for local."""
        if self._cluster is None:
            return None
        with self._cluster.hosts_lock:
            hosts = [h for h in self._cluster.hosts if h.alive]
        if not hosts:
            return None
        n_local = sum(1 for entry in self._actors.values()
                      if entry[0] == "local")
        best = min(hosts, key=lambda h: len(h.actors))
        return best if len(best.actors) < n_local else None

    def _create_actor(self, cls, args, kwargs) -> ActorHandle:
        if self.stopped:
            raise RuntimeError("RayContext not initialized; call init()")
        cloudpickle = _serializer()

        actor_id = uuid.uuid4().hex
        ready_id = f"actor-init-{actor_id}"
        target = self._pick_actor_host()
        if target is not None:
            try:
                self._pending.add(ready_id)
                target.send_actor_create(actor_id, ready_id,
                                         cloudpickle.dumps(cls),
                                         cloudpickle.dumps((args, kwargs)))
            except (OSError, EOFError):
                # host died under us: place locally instead
                self._pending.discard(ready_id)
                target = None
            else:
                self._actors[actor_id] = ("remote", target)
        if target is None:
            ctx = mp.get_context("spawn")
            task_q = ctx.Queue()
            p = ctx.Process(
                target=_actor_main,
                args=(os.getpid(), cloudpickle.dumps(cls),
                      cloudpickle.dumps((args, kwargs)), ready_id, task_q,
                      self._result_q, self.platform, self.env),
                daemon=True, name=f"zoo-ray-actor-{actor_id[:8]}")
            p.start()
            self._procs.append(p)
            self._monitor.register(p)
            self._actors[actor_id] = ("local", p, task_q)
        # surface constructor errors eagerly (ray raises on first use;
        # eager is strictly more debuggable)
        try:
            self._wait_one(ready_id, None)
        except RemoteTaskError:
            entry = self._actors.pop(actor_id, None)
            if entry is not None and entry[0] == "remote":
                # the remote ctor failed: nothing lives there — drop the
                # placement count too, or failed ctors permanently bias
                # _pick_actor_host away from this host
                entry[1].actors.discard(actor_id)
            raise
        return ActorHandle(self, actor_id)

    def _submit_actor(self, actor_id, method, args, kwargs) -> ObjectRef:
        cloudpickle = _serializer()

        entry = self._actors.get(actor_id)
        if entry is None:
            raise RuntimeError(f"unknown or killed actor {actor_id[:8]}")
        if entry[0] == "lost":
            raise RemoteTaskError(
                f"actor {actor_id[:8]} lost: {entry[1]}")
        args_blob = cloudpickle.dumps((args, kwargs))
        task_id = uuid.uuid4().hex
        self._pending.add(task_id)
        self._actor_tasks.setdefault(actor_id, set()).add(task_id)
        if entry[0] == "remote":
            # sticky routing: the owning host holds the state
            try:
                entry[1].send_actor_task(task_id, actor_id, method,
                                         args_blob)
            except (OSError, EOFError) as e:
                self._pending.discard(task_id)
                self._actor_tasks.get(actor_id, set()).discard(task_id)
                self._actors[actor_id] = ("lost", "its worker host died")
                raise RemoteTaskError(
                    f"actor {actor_id[:8]} lost: its worker host "
                    f"died ({e})") from e
        else:
            entry[2].put((task_id, method, args_blob))
        return ObjectRef(task_id)

    def _on_host_lost(self, host):
        """A joined host died: every actor homed there is gone. Pending
        refs were already resolved with errors by the listener; future
        submits must raise instead of hanging."""
        for actor_id, entry in list(self._actors.items()):
            if entry[0] == "remote" and entry[1] is host:
                self._actors[actor_id] = ("lost", "its worker host died")

    def kill(self, handle: ActorHandle):
        """Terminate an actor (ray.kill parity). Unresolved calls on the
        actor resolve to RemoteTaskError instead of hanging their
        ObjectRefs forever (ray raises RayActorError likewise)."""
        entry = self._actors.pop(handle._actor_id, None)
        if entry is None or entry[0] == "lost":
            return
        if entry[0] == "remote":
            try:
                entry[1].send_actor_kill(handle._actor_id)
            except (OSError, EOFError):
                pass
        else:
            _, proc, task_q = entry
            try:
                task_q.put(None)
                proc.join(timeout=2)
            finally:
                if proc.is_alive():
                    proc.terminate()
        with self._results_lock:
            for task_id in self._actor_tasks.pop(handle._actor_id, ()):
                if task_id not in self._results and \
                        task_id in self._pending:
                    self._results[task_id] = (
                        False, f"actor {handle._actor_id[:8]} was killed "
                               "before this call completed")

    def _submit(self, fn, args, kwargs) -> ObjectRef:
        if self.stopped:
            raise RuntimeError("RayContext not initialized; call init()")
        cloudpickle = _serializer()

        fn_blob = cloudpickle.dumps(fn)
        args_blob = cloudpickle.dumps((args, kwargs))
        task_id = uuid.uuid4().hex
        self._pending.add(task_id)
        # cross-host: prefer an idle joined host over queueing locally
        if self._cluster is not None:
            host = self._cluster.pick_host()
            if host is not None:
                try:
                    host.send_task(task_id, fn_blob, args_blob)
                    return ObjectRef(task_id)
                except (OSError, EOFError):
                    # host just died (incl. HostLostError from the race
                    # guard): fall through to the local pool
                    pass
        self._dispatch_local((task_id, fn_blob, args_blob))
        return ObjectRef(task_id)

    def _dispatch_local(self, item):
        """Queue a task onto the local pool, recording its dispatch
        order so the liveness sweep can tell claimed from
        consumed-but-unreported (see :meth:`_sweep_lost_workers`)."""
        with self._results_lock:
            self._dispatch_seq += 1
            self._dispatched[item[0]] = self._dispatch_seq
        self._task_q.put(item)

    def get(self, refs, timeout: Optional[float] = None):
        """Block for one ObjectRef or a list of them (ray.get parity)."""
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.time() + timeout
        out = [self._wait_one(r.task_id, deadline) for r in ref_list]
        return out[0] if single else out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        """ray.wait parity: block until ``num_returns`` of ``refs`` have
        results (or ``timeout`` elapses); returns ``(ready, not_ready)``
        without consuming the results — ``get`` each ready ref after.
        The as-completed primitive the async AutoML executor saturates
        the pool with (submit → wait(num_returns=1) → refill)."""
        refs = list(refs)
        num_returns = min(num_returns, len(refs))
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._results_lock:
                ready = [r for r in refs if r.task_id in self._results]
            if len(ready) >= num_returns:
                break
            remain = None if deadline is None else deadline - time.time()
            if remain is not None and remain <= 0:
                break
            self._pump(remain)
        ready_ids = {r.task_id for r in ready}
        return ready, [r for r in refs if r.task_id not in ready_ids]

    #: seconds an unclaimed task must sit while a live worker idles
    #: before an unaccounted worker death is blamed for consuming it
    _CLAIM_GRACE_S = 2.0

    def _resolve_lost(self, task_id: str, msg: str):
        """Force-resolve ``task_id`` as WorkerLostError (lock held)."""
        self._lost_tasks.add(task_id)
        self._pending.discard(task_id)
        self._results[task_id] = ("lost", msg)

    def _sweep_lost_workers(self):
        """Resolve in-flight tasks whose local worker process died.

        Only tasks claimed by a pid we spawned are swept (remote-host
        workers report foreign pids; host loss is handled by the cluster
        listener's own requeue path).  The ref resolves to a
        :class:`WorkerLostError` so callers can requeue.

        A worker SIGKILLed *between* ``task_q.get()`` and its queue
        feeder thread flushing the ``_STARTED`` marker leaves a consumed
        task that never reached ``_inflight`` — invisible to the claimed
        sweep above, and no other worker can ever run it.  Each such
        death accounts for at most one task, so the sweep counts worker
        deaths not attributable to a claimed task and blames the
        *oldest* dispatched-but-unclaimed task once the evidence is in:
        either a later-dispatched task was already claimed (the local
        queue is FIFO, so the older one must have been consumed), or a
        live worker has sat idle past a grace period with the task still
        unclaimed.  A false positive (marker merely delayed) is safe:
        the straggler guard in ``_pump`` drops the duplicate result."""
        workers = [p for p in self._procs
                   if p.name.startswith("zoo-ray-worker")]
        local = {p.pid: p for p in workers}
        now = time.time()
        with self._results_lock:
            for task_id, pid in list(self._inflight.items()):
                proc = local.get(pid)
                if proc is None or proc.is_alive():
                    continue
                self._dead_pids.add(pid)   # death accounted by its claim
                del self._inflight[task_id]
                if task_id in self._results:
                    continue   # result landed before the sweep
                self._resolve_lost(
                    task_id, f"worker pid {pid} died (exitcode "
                             f"{proc.exitcode}) while running task "
                             f"{task_id[:8]}")
            for pid, proc in local.items():
                if proc.is_alive() or pid in self._dead_pids:
                    continue
                self._dead_pids.add(pid)
                self._unclaimed_deaths += 1
                self._unclaimed_death_at = now
            if not self._dispatched:
                # nothing dispatched is outstanding, so those deaths
                # cannot have consumed anything a caller still waits on
                self._unclaimed_deaths = 0
            elif self._unclaimed_deaths:
                busy = set(self._inflight.values())
                idle_live = any(p.is_alive() and p.pid not in busy
                                for p in workers)
                oldest_id = next(iter(self._dispatched))
                overtaken = (self._max_claimed_seq
                             > self._dispatched[oldest_id])
                waited = (now - self._unclaimed_death_at
                          >= self._CLAIM_GRACE_S)
                if overtaken or (idle_live and waited):
                    self._unclaimed_deaths -= 1
                    del self._dispatched[oldest_id]
                    if oldest_id not in self._results:
                        self._resolve_lost(
                            oldest_id,
                            f"task {oldest_id[:8]} was consumed by a "
                            f"worker that died before reporting its "
                            f"claim (SIGKILL before the queue feeder "
                            f"flushed)")

    def _note_claimed(self, tid: str):
        """A marker/result for ``tid`` arrived: it is no longer
        dispatched-but-unclaimed (lock held)."""
        seq = self._dispatched.pop(tid, None)
        if seq is not None and seq > self._max_claimed_seq:
            self._max_claimed_seq = seq

    def _pump(self, remain: Optional[float]):
        """Drain one result-queue item (or time out and sweep liveness)."""
        try:
            tid, ok, payload = self._result_q.get(
                timeout=min(remain, 1.0) if remain else 1.0)
        except queue_mod.Empty:
            self._sweep_lost_workers()
            if not any(p.is_alive() for p in self._procs):
                raise RuntimeError("all workers died") from None
            return
        if ok == _STARTED:
            # claim marker: payload is the executing worker's pid
            with self._results_lock:
                self._note_claimed(tid)
                if tid in self._pending:
                    self._inflight[tid] = payload
            return
        with self._results_lock:
            self._note_claimed(tid)
            self._inflight.pop(tid, None)
            if tid in self._lost_tasks:
                # already force-resolved as lost; the straggler result
                # (a SIGKILL racing the queue feeder) must not resurrect
                # the task id — callers may have requeued it already
                self._lost_tasks.discard(tid)
                return
            self._results[tid] = (ok, payload)
            self._pending.discard(tid)

    def _wait_one(self, task_id: str, deadline: Optional[float]):
        cloudpickle = _serializer()

        while True:
            with self._results_lock:
                if task_id in self._results:
                    ok, payload = self._results.pop(task_id)
                    if ok == "lost":
                        raise WorkerLostError(payload)
                    if not ok:
                        raise RemoteTaskError(payload)
                    return cloudpickle.loads(payload)
            remain = None if deadline is None else deadline - time.time()
            if remain is not None and remain <= 0:
                raise TimeoutError(f"task {task_id[:8]} timed out")
            self._pump(remain)

    # convenience ------------------------------------------------------
    def map(self, fn: Callable, items: Sequence, timeout=None) -> List:
        refs = [self._submit(fn, (it,), {}) for it in items]
        return self.get(refs, timeout=timeout)

    def __enter__(self):
        return self.init()

    def __exit__(self, *exc):
        self.stop()
