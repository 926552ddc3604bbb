"""Cross-host extension of the Ray-equivalent runtime.

Counterpart of ``analytics_zoo_tpu/ray/cluster.py``. The reference's
RayContext spans the whole Spark cluster — partition 0 runs
``ray start --head`` and every executor host joins as a raylet
(``pyzoo/zoo/ray/util/raycontext.py:155-189``). There is no Spark barrier
to rendezvous through, so the transport is an
authenticated socket channel (``multiprocessing.connection``): the driver
host listens with a per-cluster random authkey, every worker HOST connects
with ``python -m analytics_zoo_tpu_torch.ray.worker_host --connect
head:port --authkey <key>`` and contributes its local worker pool. Tasks round-robin
across the head's own pool and the joined hosts; results stream back over
the same channel; a dying host's in-flight tasks are requeued onto the
local pool so no ObjectRef ever hangs.

Wire protocol (one pickled tuple per message; tasks, arguments and
results inside it are blobs of the runtime's serializer, cloudpickle or
the standard pickle, ``raycontext._serializer``):
  worker->head  ("register", num_workers)
  head->worker  ("task", task_id, fn_blob, args_blob)
  head->worker  ("create_actor", actor_id, ready_id, cls_blob, init_blob)
  head->worker  ("actor_task", task_id, actor_id, method, args_blob)
  head->worker  ("kill_actor", actor_id)
  worker->head  ("result", task_id, ok, payload)
  head->worker  ("shutdown",)

Actors place cluster-wide (r4; reference: the sharded parameter server
holds shards in ``@ray.remote`` actors on different hosts,
``apps/ray/parameter_server/sharded_parameter_server.ipynb``): the head
round-robins new actors across itself and the joined hosts; method calls
route stickily to the owning host; a dying host resolves every pending
ref on its actors with an actor-lost error (stateless tasks are requeued
instead — state cannot be).
"""

from __future__ import annotations

import logging
import secrets
import threading
import traceback
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch.ray.cluster")


def generate_authkey() -> bytes:
    """Per-cluster random key — the channel executes pickled closures, so
    a well-known constant key would be no authentication at all."""
    return secrets.token_hex(16).encode()


class HostLostError(OSError):
    """The target worker host is dead; raised by RemoteHost.send_* so
    submitters can fall back / resolve instead of racing the death drain
    (a send that slipped in after the drain would leave its ObjectRef
    hanging forever)."""


class RemoteHost:
    """Head-side handle for one joined worker host."""

    def __init__(self, conn, num_workers: int, name: str):
        self.conn = conn
        self.num_workers = num_workers
        self.name = name
        # task_id -> ("task", fn_blob, args_blob) | ("actor", actor_id):
        # stateless tasks can be requeued when the host dies; actor calls
        # cannot (the state died with the host) and resolve to errors
        self.in_flight: Dict[str, Tuple] = {}
        self.actors: set = set()       # actor_ids homed on this host
        self.lock = threading.Lock()
        self.alive = True

    # All sends check ``alive`` under the SAME lock the death drain holds:
    # a submitter either lands its in_flight entry before the drain (and
    # is resolved by it) or observes alive=False and raises — an entry can
    # never be inserted after the drain, which would hang its ObjectRef.
    def _checked_send(self, msg):
        if not self.alive:
            raise HostLostError("worker host is dead")
        self.conn.send(msg)

    def send_task(self, task_id: str, fn_blob: bytes, args_blob: bytes):
        with self.lock:
            self._checked_send(("task", task_id, fn_blob, args_blob))
            self.in_flight[task_id] = ("task", fn_blob, args_blob)

    def send_actor_create(self, actor_id: str, ready_id: str,
                          cls_blob: bytes, init_blob: bytes):
        with self.lock:
            self._checked_send(("create_actor", actor_id, ready_id,
                                cls_blob, init_blob))
            self.in_flight[ready_id] = ("actor", actor_id)
            self.actors.add(actor_id)

    def send_actor_task(self, task_id: str, actor_id: str, method: str,
                        args_blob: bytes):
        with self.lock:
            self._checked_send(("actor_task", task_id, actor_id, method,
                                args_blob))
            self.in_flight[task_id] = ("actor", actor_id)

    def send_actor_kill(self, actor_id: str):
        with self.lock:
            self._checked_send(("kill_actor", actor_id))
            self.actors.discard(actor_id)

    def load(self) -> float:
        with self.lock:
            return len(self.in_flight) / max(self.num_workers, 1)

    def has_capacity(self) -> bool:
        with self.lock:
            return len(self.in_flight) < self.num_workers


class ClusterListener:
    """Accepts worker-host connections and feeds their results into the
    driver's result queue (same queue the local pool uses)."""

    REGISTER_TIMEOUT_S = 10.0

    def __init__(self, address: Tuple[str, int], result_q,
                 authkey: bytes, requeue=None, on_host_lost=None):
        self.listener = Listener(address, authkey=authkey)
        self.address = self.listener.address
        self.result_q = result_q
        self.requeue = requeue          # callable((task_id, fn, args)) | None
        self.on_host_lost = on_host_lost   # callable(RemoteHost) | None
        self.hosts: List[RemoteHost] = []
        self.hosts_lock = threading.Lock()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn = self.listener.accept()
            except (AuthenticationError, EOFError, OSError) as e:
                # a failed/aborted/unauthenticated CONNECTION must not end
                # the loop (port scans and wrong keys land here); only a
                # closed listener does
                if self._stop.is_set():
                    return
                logger.warning("rejected connection: %s", e)
                continue
            # registration handshake off-thread: a connected-but-silent
            # client must not stall later joins
            threading.Thread(target=self._register, args=(conn,),
                             daemon=True).start()

    def _register(self, conn):
        try:
            if not conn.poll(self.REGISTER_TIMEOUT_S):
                conn.close()
                return
            msg = conn.recv()
        except (OSError, EOFError):
            return
        if not (isinstance(msg, tuple) and msg and msg[0] == "register"):
            conn.close()
            return
        host = RemoteHost(conn, int(msg[1]), "worker-host")
        with self.hosts_lock:
            self.hosts.append(host)
        threading.Thread(target=self._reader_loop, args=(host,),
                         daemon=True).start()
        logger.info("worker host joined (%d workers)", host.num_workers)

    def _reader_loop(self, host: RemoteHost):
        while not self._stop.is_set():
            try:
                msg = host.conn.recv()
            except (OSError, EOFError):
                break
            if isinstance(msg, tuple) and msg[0] == "result":
                _, task_id, ok, payload = msg
                with host.lock:
                    host.in_flight.pop(task_id, None)
                self.result_q.put((task_id, ok, payload))
        with self.hosts_lock:
            if host in self.hosts:
                self.hosts.remove(host)
        # the host died with work outstanding: stateless tasks requeue onto
        # the local pool; actor calls lost their state with the host and
        # resolve to actor-lost errors — either way no ObjectRef hangs.
        # alive flips INSIDE the lock so no send can interleave with the
        # drain (see RemoteHost._checked_send).
        with host.lock:
            host.alive = False
            orphans = list(host.in_flight.items())
            host.in_flight.clear()
        requeued = failed = 0
        for task_id, item in orphans:
            if item[0] == "task" and self.requeue is not None:
                _, fn_blob, args_blob = item
                self.requeue((task_id, fn_blob, args_blob))
                requeued += 1
            elif item[0] == "actor":
                self.result_q.put((
                    task_id, False,
                    f"actor {item[1][:8]} lost: its worker host died"))
                failed += 1
            else:
                self.result_q.put((task_id, False,
                                   "worker host died mid-task"))
                failed += 1
        if self.on_host_lost is not None:
            self.on_host_lost(host)
        if orphans:
            logger.warning("worker host left; %d tasks requeued, %d "
                           "actor calls failed", requeued, failed)
        else:
            logger.info("worker host left")

    def pick_host(self) -> Optional[RemoteHost]:
        """Least-loaded joined host that still has spare workers."""
        with self.hosts_lock:
            candidates = [h for h in self.hosts
                          if h.alive and h.has_capacity()]
            if not candidates:
                return None
            return min(candidates, key=RemoteHost.load)

    def close(self):
        self._stop.set()
        with self.hosts_lock:
            for host in self.hosts:
                try:
                    host.conn.send(("shutdown",))
                    host.conn.close()
                except (OSError, EOFError):
                    pass
            self.hosts = []
        try:
            self.listener.close()
        except OSError:
            pass


def worker_host_main(address: Tuple[str, int], num_workers: int = 2,
                     authkey: bytes = b"", platform: Optional[str] = None,
                     max_tasks: Optional[int] = None):
    """Join a head as a worker host: run tasks from the channel on a local
    pool (the raylet role) on ``platform`` (None: the card; ``"cpu"``).
    Blocks until the head shuts the channel."""
    from .raycontext import RayContext, _serializer

    cloudpickle = _serializer()

    conn = Client(address, authkey=authkey)
    conn.send(("register", num_workers))
    done = 0
    with RayContext(num_ray_nodes=num_workers, ray_node_cpu_cores=1,
                    platform=platform) as ctx:
        lock = threading.Lock()
        actors = {}     # head actor_id -> local ActorHandle

        def reply(task_id, ok, payload):
            with lock:
                try:
                    conn.send(("result", task_id, ok, payload))
                except (OSError, EOFError):
                    pass

        def wait_and_reply(task_id, ref):
            try:
                result = ctx.get(ref)
                payload, ok = cloudpickle.dumps(result), True
            except BaseException as e:  # noqa: BLE001
                payload, ok = (f"{type(e).__name__}: {e}\n"
                               f"{traceback.format_exc()}"), False
            reply(task_id, ok, payload)

        while True:
            try:
                msg = conn.recv()
            except (OSError, EOFError):
                break
            if not isinstance(msg, tuple) or msg[0] == "shutdown":
                break
            if msg[0] == "task":
                _, task_id, fn_blob, args_blob = msg
                fn = cloudpickle.loads(fn_blob)
                args, kwargs = cloudpickle.loads(args_blob)
                ref = ctx._submit(fn, args, kwargs)
                threading.Thread(target=wait_and_reply,
                                 args=(task_id, ref), daemon=True).start()
                done += 1
                if max_tasks is not None and done >= max_tasks:
                    break
            elif msg[0] == "create_actor":
                # synchronous: the head blocks on ready_id before handing
                # the handle to user code, so no actor_task can precede
                # readiness; constructor errors surface in the reply
                _, actor_id, ready_id, cls_blob, init_blob = msg
                try:
                    cls = cloudpickle.loads(cls_blob)
                    args, kwargs = cloudpickle.loads(init_blob)
                    actors[actor_id] = ctx._create_actor(cls, args, kwargs)
                    reply(ready_id, True, cloudpickle.dumps(None))
                except BaseException as e:  # noqa: BLE001
                    reply(ready_id, False,
                          f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}")
            elif msg[0] == "actor_task":
                _, task_id, actor_id, method, args_blob = msg
                handle = actors.get(actor_id)
                if handle is None:
                    reply(task_id, False,
                          f"unknown actor {actor_id[:8]} on this host")
                    continue
                try:
                    args, kwargs = cloudpickle.loads(args_blob)
                    ref = ctx._submit_actor(handle._actor_id, method, args,
                                            kwargs)
                except BaseException as e:  # noqa: BLE001
                    reply(task_id, False, f"{type(e).__name__}: {e}")
                    continue
                threading.Thread(target=wait_and_reply,
                                 args=(task_id, ref), daemon=True).start()
            elif msg[0] == "kill_actor":
                handle = actors.pop(msg[1], None)
                if handle is not None:
                    ctx.kill(handle)
    try:
        conn.close()
    except OSError:
        pass
