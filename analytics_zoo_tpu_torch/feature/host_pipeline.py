"""Staged host input pipeline: transform pool -> prefetch -> device staging.

Counterpart of ``analytics_zoo_tpu/feature/host_pipeline.py``, copied.
Reference analogue: ``MTSampleToMiniBatch`` (multi-threaded batch assembly)
plus the FeatureSet DRAM tier kept the JVM side of the infeed busy; here the
host side runs as three decoupled layers so the step never waits on input:

1. ``ParallelTransformIterator`` — an ordered, bounded-in-flight thread pool
   running the Preprocessing chain for several batches concurrently
   (``ZooConfig.transform_workers``).
2. ``PrefetchIterator`` (feature_set.py) — a background thread that keeps
   ``prefetch_depth`` transformed batches queued on the host.
3. ``DeviceStagingIterator`` — keeps up to ``device_ahead`` dispatch chunks
   already handed to the trainer's ``put_one``/``put_stacked``; on the
   card those write each batch into a pinned buffer and copy it on a side
   stream (``pipeline/engine.py``), so the H2D copy of batch N+1 overlaps
   the device compute of batch N. Nothing in this module imports torch.

All host-side blocking is accounted into an ``InfeedMonitor`` so the engine
can emit input-wait and input-bound-fraction telemetry per logging window.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import pickle
import queue as queue_mod
import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import time

import numpy as np

from ..utils import telemetry
from ..utils.telemetry import span
from .feature_set import (FeatureSet, MiniBatch, PrefetchIterator,
                          TransformedFeatureSet, minibatch_len,
                          register_pipeline)
from .infeed_worker import rebuild_batch, worker_main

logger = logging.getLogger("analytics_zoo_tpu_torch.feature")


class ParallelTransformIterator:
    """Ordered multi-worker transform pool with bounded in-flight batches.

    Pulls raw batches from ``base_it`` on the consumer thread (the base
    generator is never touched from pool threads), submits ``fn(batch)``
    to a thread pool, and yields results in submission order. At most
    ``num_workers + 2`` batches are in flight, bounding host RAM while
    keeping every worker busy. A worker exception is re-raised on the
    very next ``__next__`` for the failed batch's position.
    """

    def __init__(self, base_it: Iterator, fn: Callable[[Any], Any],
                 num_workers: int = 2, max_in_flight: Optional[int] = None):
        self._base = iter(base_it)
        self._fn = fn
        self.num_workers = max(1, int(num_workers))
        self._pool = ThreadPoolExecutor(
            max_workers=self.num_workers,
            thread_name_prefix="zoo-transform")
        self._futures: deque = deque()
        self._max_in_flight = max_in_flight or self.num_workers + 2
        self._exhausted = False
        self._closed = False
        register_pipeline(self)
        self._fill()

    def _fill(self):
        while not self._exhausted and \
                len(self._futures) < self._max_in_flight:
            try:
                item = next(self._base)
            except StopIteration:
                self._exhausted = True
                break
            self._futures.append(self._pool.submit(self._run, item))

    def _run(self, item):
        # runs on a pool thread: the span lands on the zoo-transform
        # thread's timeline in the exported trace
        with span("infeed/transform"):
            return self._fn(item)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if not self._futures:
            self.close()
            raise StopIteration
        fut = self._futures.popleft()
        try:
            out = fut.result()
        except BaseException:
            self.close()
            raise
        self._fill()
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        for f in self._futures:
            f.cancel()
        self._futures.clear()
        self._pool.shutdown(wait=False)
        base_close = getattr(self._base, "close", None)
        if base_close is not None:
            base_close()


DEFAULT_SLOT_BYTES = 8 << 20    # ZOO_TPU_INFEED_SLOT_BYTES
DEFAULT_SLOTS_PER_WORKER = 4    # ZOO_TPU_INFEED_SLOTS


class _RingSegment:
    """Lifecycle of one worker's shared-memory ring.

    numpy does not pin the buffer export of the ``SharedMemory``
    memoryview, so ``shm.close()`` really unmaps even while zero-copy
    views are alive — touching them afterwards is a segfault, not an
    exception. The segment therefore refcounts outstanding batch leases:
    ``retire()`` (pool close) unlinks the name immediately — no /dev/shm
    entry survives the pool — but the unmap is deferred until the last
    consumer-held view is garbage collected.
    """

    __slots__ = ("shm", "_active", "_retired", "_lock")

    def __init__(self, shm):
        self.shm = shm
        self._active = 0
        self._retired = False
        self._lock = threading.Lock()

    def lease(self):
        with self._lock:
            self._active += 1

    def unlease(self):
        with self._lock:
            self._active -= 1
            last = self._retired and self._active == 0
        if last:
            self._unmap()

    def retire(self):
        with self._lock:
            if self._retired:
                return
            self._retired = True
            drained = self._active == 0
        try:
            self.shm.unlink()
        except Exception:  # noqa: BLE001 - already unlinked
            pass
        if drained:
            self._unmap()

    def _unmap(self):
        try:
            self.shm.close()
        except Exception:  # noqa: BLE001
            pass


class _SlotLease:
    """One leased ring slot: returned to its worker's free slots (and
    unleased from the segment) when the last zero-copy view wrapped from
    it is garbage collected."""

    __slots__ = ("free", "segment", "slot", "count", "lock")

    def __init__(self, free: deque, segment: "_RingSegment", slot: int,
                 count: int):
        self.free = free
        self.segment = segment
        self.slot = slot
        self.count = count
        self.lock = threading.Lock()
        segment.lease()

    def release_one(self):
        with self.lock:
            self.count -= 1
            if self.count > 0:
                return
        # deque.append is atomic: finalizers run on whatever thread drops
        # the last view
        self.free.append(self.slot)
        self.segment.unlease()


_STOP = object()


class _TaskSender:
    """Writes one worker's tasks into its task pipe from a thread of its
    own (``zoo-infeed-feed-<wid>``), so the consumer never blocks on a
    pipe the worker is not reading. The worker holds the pipe's only
    reader: once it dies a write fails (EPIPE) and the thread ends."""

    def __init__(self, wid: int, conn):
        self.conn = conn
        self._q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"zoo-infeed-feed-{wid}")
        self.thread.start()

    def put(self, msg) -> None:
        self._q.put(msg)

    def _run(self):
        try:
            while True:
                msg = self._q.get()
                if msg is _STOP:
                    break
                self.conn.send(msg)
        except (OSError, ValueError):  # the worker is gone
            pass
        finally:
            try:
                self.conn.close()
            except OSError:
                pass

    def stop(self, timeout: float = 1.0) -> None:
        self._q.put(_STOP)
        self.thread.join(timeout)


class _Worker:
    """Parent-side record of one spawned transform worker. The ring
    segment and the free slots outlive the process: a respawned
    replacement writes into the same ring. The pipes do not: each process
    gets a task pipe and a result pipe of its own, and a dead one's are
    dropped with it, so nothing it held (a lock, half a message) reaches
    its replacement."""

    __slots__ = ("wid", "proc", "segment", "free", "assigned", "conn",
                 "sender")

    def __init__(self, wid, segment, slots: int):
        self.wid = wid
        self.proc = None
        self.segment = segment
        self.free: deque = deque(range(slots))
        #: seq -> the ring slot sent with the task (None: no slot free)
        self.assigned: Dict[int, Optional[int]] = {}
        self.conn = None       # the result pipe's reading end
        self.sender: Optional[_TaskSender] = None


class _RemoteError:
    """Marks a ready-slot as a worker failure to re-raise in order."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _reap_pool(procs, segments):
    """close()/GC backstop: put down workers and retire every ring
    segment (unlink now, unmap when the last consumer view drops).
    Module-level — weakref.finalize must not resurrect the pool."""
    for p in procs:
        try:
            if p.is_alive():
                p.terminate()
        except Exception:  # noqa: BLE001
            pass
    for p in procs:
        try:
            p.join(timeout=1.0)
            if p.is_alive():
                p.kill()
        except Exception:  # noqa: BLE001
            pass
    for seg in segments:
        seg.retire()


class ProcessTransformPool:
    """Ordered multi-process transform pool with shared-memory hand-off.

    The iterator contract is :class:`ParallelTransformIterator`'s
    exactly — results in submission order, bounded in-flight, a worker
    failure re-raised at the failed batch's position on the very next
    ``__next__``, idempotent mid-stream ``close()`` — but the transform
    runs in N spawned processes, so GIL-holding Python chains scale with
    cores instead of serializing. Each worker returns batches through
    its own ``multiprocessing.shared_memory`` ring: each task goes out
    with a free slot of that ring, the parent wraps the slot bytes in
    numpy views (zero copies on the hot path) and the slot recycles when
    the consumer drops the batch (weakref lease). Batches that don't fit
    a slot — or are sent while the consumer retains every lease, e.g. a
    caching tier — travel pickled through the worker's result pipe:
    slower, never wrong, never deadlocked.

    Every worker has a task pipe and a result pipe of its own; the worker
    writes its results straight into its pipe, with no feeder thread and
    no lock shared with the other workers, and the parent waits on all
    result pipes at once (``multiprocessing.connection.wait``). A worker
    killed at any point, mid-write included, leaves nothing held: its
    pipe gives the parent EOF after the last whole message. Respawn rides
    the launcher supervision seam
    (:class:`~analytics_zoo_tpu_torch.launcher.supervisor.Respawner`):
    the dead worker's pipes are dropped, its replacement gets new ones
    and the same ring, and its unacknowledged batches are resubmitted
    with the slots they held — the stream stays complete,
    duplicate-free and ordered. Ring segments are unlinked in
    ``close()``'s finally (plus a GC finalizer backstop): no /dev/shm
    leak survives the pool.
    """

    def __init__(self, base_it: Iterator, preprocessing,
                 num_workers: int = 2, max_in_flight: Optional[int] = None,
                 stats=None, slot_bytes: Optional[int] = None,
                 slots_per_worker: Optional[int] = None, respawner=None):
        from multiprocessing import shared_memory

        from ..launcher.supervisor import Respawner

        self._base = iter(base_it)
        self.num_workers = max(1, int(num_workers))
        self._max_in_flight = max_in_flight or self.num_workers + 2
        self._stats = stats
        try:
            self._payload = pickle.dumps(preprocessing, -1)
        except Exception as e:
            raise ValueError(
                "infeed backend 'process' needs a picklable Preprocessing "
                "chain (module-level functions; no lambdas or closures): "
                f"{e}") from e
        self._slot_bytes = int(slot_bytes or os.environ.get(
            "ZOO_TPU_INFEED_SLOT_BYTES", DEFAULT_SLOT_BYTES))
        self._slots = int(slots_per_worker or os.environ.get(
            "ZOO_TPU_INFEED_SLOTS", DEFAULT_SLOTS_PER_WORKER))
        self._respawner = respawner or Respawner(max_per_child=3)
        # spawn: forking a process whose threads hold CUDA state is unsafe
        self._ctx = mp.get_context("spawn")
        self._tasks: Dict[int, Any] = {}    # seq -> raw batch (requeue)
        self._ready: Dict[int, Any] = {}    # seq -> batch | _RemoteError
        self._seq_submit = 0
        self._seq_emit = 0
        self._rr = 0
        self._exhausted = False
        self._closed = False
        self._fatal: Optional[BaseException] = None
        self._close_lock = threading.Lock()
        self.shm_batches = 0
        self.pickled_batches = 0
        self._all_procs: List = []
        self._workers: Dict[int, _Worker] = {}
        for wid in range(self.num_workers):
            shm = shared_memory.SharedMemory(
                create=True, size=self._slot_bytes * self._slots)
            self._workers[wid] = _Worker(wid, _RingSegment(shm),
                                         self._slots)
        self._finalizer = weakref.finalize(
            self, _reap_pool, self._all_procs,
            [w.segment for w in self._workers.values()])
        for w in self._workers.values():
            self._start_proc(w)
        register_pipeline(self)
        self._fill()

    @property
    def respawns(self) -> int:
        return self._respawner.total_respawns

    def pool_stats(self) -> Dict[str, int]:
        return {"shm_batches": self.shm_batches,
                "pickled_batches": self.pickled_batches,
                "respawns": self.respawns}

    def _start_proc(self, w: _Worker):
        """Start a process for ``w`` on new pipes. The parent keeps only
        the task pipe's writing end and the result pipe's reading end, so
        the worker's death closes both pipes' other ends."""
        task_r, task_w = self._ctx.Pipe(duplex=False)
        res_r, res_w = self._ctx.Pipe(duplex=False)
        p = self._ctx.Process(
            target=worker_main,
            args=(w.wid, w.segment.shm.name, self._slot_bytes,
                  self._payload, task_r, res_w),
            daemon=True, name=f"zoo-infeed-{w.wid}")
        p.start()
        task_r.close()
        res_w.close()
        w.proc = p
        w.conn = res_r
        w.sender = _TaskSender(w.wid, task_w)
        self._all_procs.append(p)

    def _submit(self, w: _Worker, seq: int, slot: Optional[int]):
        w.assigned[seq] = slot
        w.sender.put((seq, slot, self._tasks[seq]))

    def _fill(self):
        while not self._exhausted and \
                len(self._tasks) + len(self._ready) < self._max_in_flight:
            try:
                item = next(self._base)
            except StopIteration:
                self._exhausted = True
                break
            seq = self._seq_submit
            self._seq_submit += 1
            w = self._workers[self._rr % self.num_workers]
            self._rr += 1
            self._tasks[seq] = item
            try:
                slot: Optional[int] = w.free.popleft()
            except IndexError:  # the consumer holds every lease
                slot = None
            self._submit(w, seq, slot)

    def _note_time(self, wid: int, elapsed: float):
        if self._stats is not None:
            self._stats.record(elapsed)
            self._stats.record_worker(wid, elapsed)

    def _wrap(self, w: _Worker, slot: int, metas, template) -> MiniBatch:
        """Wrap one ring slot's bytes in numpy views — the zero-copy hot
        path. Each view carries a finalizer on the shared lease; the
        slot returns to the worker only after every view is gone."""
        if not metas:
            w.free.append(slot)
            return rebuild_batch(template, [])
        lease = _SlotLease(w.free, w.segment, slot, len(metas))
        base = slot * self._slot_bytes
        arrays = []
        for off, shape, dt in metas:
            arr = np.ndarray(shape, np.dtype(dt), buffer=w.segment.shm.buf,
                             offset=base + off)
            weakref.finalize(arr, lease.release_one)
            arrays.append(arr)
        return rebuild_batch(template, arrays)

    def _handle(self, msg):
        kind, wid, seq = msg[0], msg[1], msg[2]
        if kind == "spans":
            # telemetry side-channel: replay the worker's span events
            # under its real pid so the trace shows a per-worker timeline
            telemetry.ingest_events(
                msg[3], pid=seq, process_name=f"zoo-infeed-{wid}")
            return
        if kind == "fatal":
            # the worker can't run at all (chain failed to unpickle in
            # the spawned interpreter): surface on the next __next__
            self._fatal = pickle.loads(msg[3])
            return
        w = self._workers[wid]
        slot = msg[3]
        if seq not in self._tasks:
            # not a task of this pool's any more: hand its slot straight
            # back so the ring doesn't shrink
            if slot is not None:
                w.free.append(slot)
            return
        del self._tasks[seq]
        del w.assigned[seq]
        if kind == "shm":
            _, _, _, _, metas, template, elapsed = msg
            self._ready[seq] = self._wrap(w, slot, metas, template)
            self.shm_batches += 1
            self._note_time(wid, elapsed)
            return
        if slot is not None:
            w.free.append(slot)
        if kind == "pkl":
            self._ready[seq] = pickle.loads(msg[4])
            self.pickled_batches += 1
            self._note_time(wid, msg[5])
        else:  # "err"
            self._ready[seq] = _RemoteError(pickle.loads(msg[4]))

    def _drain(self, w: _Worker) -> None:
        """Handle every whole message left in ``w``'s result pipe, up to
        its EOF (a dead writer's last, cut message included: dropped)."""
        try:
            while w.conn.poll():
                self._handle(w.conn.recv())
        except (EOFError, OSError):
            pass

    def _respawn(self, w: _Worker) -> None:
        """Replace ``w``'s dead process: drain and drop its pipes, start
        a new one on new pipes and the same ring, and resubmit its
        unacknowledged batches with the slots they held. Raises
        RuntimeError (via the Respawner budget) when deaths look
        structural."""
        w.proc.join(timeout=1.0)
        self._drain(w)
        w.conn.close()
        w.sender.stop()
        if self._fatal is not None:
            # it could not run at all: the next __next__ raises
            w.conn = None
            return
        self._respawner.note_death(
            f"infeed-{w.wid}", f"exit code {w.proc.exitcode}")
        logger.warning(
            "infeed worker %d died (exit %s); respawning and "
            "resubmitting %d batch(es)", w.wid, w.proc.exitcode,
            len(w.assigned))
        self._start_proc(w)
        for seq, slot in sorted(w.assigned.items()):
            self._submit(w, seq, slot)

    def _check_workers(self):
        """Respawn workers whose process has ended (the backstop of the
        EOF that their result pipe gives)."""
        for w in list(self._workers.values()):
            if self._closed or w.proc is None or w.proc.is_alive():
                continue
            self._respawn(w)

    def _receive(self, timeout: float) -> None:
        """Wait up to ``timeout`` s on every worker's result pipe and
        handle what arrived; a pipe at EOF is a dead worker, respawned."""
        by_conn = {w.conn: w for w in self._workers.values()
                   if w.conn is not None}
        ready = mp_connection.wait(list(by_conn), timeout=timeout)
        if not ready:
            self._check_workers()
            return
        for conn in ready:
            w = by_conn[conn]
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                self._respawn(w)
                continue
            self._handle(msg)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._seq_emit not in self._ready and not self._tasks \
                and self._exhausted:
            self.close()
            raise StopIteration
        while self._seq_emit not in self._ready:
            if self._fatal is not None:
                err, self._fatal = self._fatal, None
                self.close()
                raise err
            try:
                self._receive(0.2)
            except BaseException:
                self.close()
                raise
        out = self._ready.pop(self._seq_emit)
        if isinstance(out, _RemoteError):
            self.close()
            raise out.exc
        self._seq_emit += 1
        self._fill()
        return out

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        try:
            for w in self._workers.values():
                if w.sender is not None:
                    w.sender.put(None)   # the worker's exit sentinel
            for w in self._workers.values():
                if w.proc is not None:
                    w.proc.join(timeout=1.0)
            self._tasks.clear()
            self._ready.clear()
            base_close = getattr(self._base, "close", None)
            if base_close is not None:
                base_close()
        finally:
            # segments must not outlive the pool no matter how teardown
            # went: _reap_pool terminates stragglers and unlinks every
            # ring (idempotent with the GC backstop); a dead reader ends
            # each sender thread
            self._finalizer()
            for w in self._workers.values():
                if w.sender is not None:
                    w.sender.stop()
                if w.conn is not None:
                    try:
                        w.conn.close()
                    except OSError:
                        pass


class StagedChunk:
    """One dispatch unit handed to the engine.

    ``stacked`` is the (k, batch, ...) device super-batch when the chunk
    filled a full fused dispatch of k > 1 steps; otherwise ``singles``
    holds per-batch device batches (epoch tails and k == 1, the only k
    the port's trainer asks for until its fused dispatch lands). ``hosts`` keeps
    the pre-put host copies so a k-change can restage without re-reading
    the input pipeline, and so predict() can count real samples.
    """

    __slots__ = ("k", "stacked", "singles", "hosts")

    def __init__(self, k: int, stacked, singles, hosts: List[MiniBatch]):
        self.k = k
        self.stacked = stacked
        self.singles = singles
        self.hosts = hosts

    @property
    def real_counts(self) -> List[int]:
        """Per-batch count of real (non-padding) samples: zero-weight rows
        are the pad_remainder filler; weight-less batches are all real.
        Lets evaluate()/predict() unpad fused outputs without touching the
        device copies."""
        counts = []
        for h in self.hosts:
            w = h.weights
            counts.append(minibatch_len(h) if w is None else
                          int(np.sum(np.asarray(w) > 0)))
        return counts


class DeviceStagingIterator:
    """Keeps up to ``depth`` dispatch chunks already on the device.

    ``put_one`` / ``put_stacked`` are the engine's placement rules
    (``SPMDTrainer._put_one`` / ``_put_stacked``: the pinned side-stream
    copy on the card, a plain copy on the CPU), so staged batches are
    laid out exactly as the step expects. ``next_chunk(k)`` recomputes
    per call: the engine's fused dispatch size can shrink at trigger
    boundaries, in which case already-staged chunks are dissolved back
    into the pending host queue (order preserved) and restaged at the
    new k; the dropped device copies are the cost of a rare event.
    """

    def __init__(self, host_it: Iterator[MiniBatch],
                 put_one: Callable[[MiniBatch], Any],
                 put_stacked: Callable[[List[MiniBatch]], Any],
                 depth: int = 2, monitor=None):
        self._host_it = iter(host_it)
        self._put_one = put_one
        self._put_stacked = put_stacked
        self.depth = max(1, int(depth))
        self.monitor = monitor
        self._staged: deque = deque()       # StagedChunk, oldest first
        self._pending: deque = deque()      # host batches awaiting staging
        self._eof = False
        register_pipeline(self)

    def _fetch_host(self) -> Optional[MiniBatch]:
        if self._pending:
            return self._pending.popleft()
        if self._eof:
            return None
        t0 = time.perf_counter()
        try:
            with span("infeed/wait"):
                hb = next(self._host_it)
        except StopIteration:
            self._eof = True
            return None
        finally:
            if self.monitor is not None:
                self.monitor.input_wait(time.perf_counter() - t0)
        return hb

    def _stage_one(self, k: int) -> bool:
        hosts: List[MiniBatch] = []
        while len(hosts) < k:
            hb = self._fetch_host()
            if hb is None:
                break
            hosts.append(hb)
        if not hosts:
            return False
        # a full chunk stacks into the (k, batch, ...) super-batch only
        # when every batch has the same length: a non-dropped, non-padded
        # remainder (drop_remainder=False, pad_remainder=False) lands mid-
        # chunk with a shorter batch axis and must take the singles path
        # rather than np.stack raising
        uniform = len({minibatch_len(h) for h in hosts}) == 1
        if k > 1 and len(hosts) == k and uniform:
            # stacking needs one tree structure across the chunk: a padded
            # remainder carries a weights array while full batches carry
            # None — materialize ones (the semantic equivalent of None)
            # so the stacked super-batch has a single treedef
            if any(h.weights is not None for h in hosts) and \
                    not all(h.weights is not None for h in hosts):
                hosts = [h if h.weights is not None else
                         MiniBatch(h.inputs, h.targets,
                                   np.ones(minibatch_len(h), np.float32))
                         for h in hosts]
            chunk = StagedChunk(k, self._put_stacked(hosts), None, hosts)
        else:
            chunk = StagedChunk(
                k, None, [self._put_one(h) for h in hosts], hosts)
        self._staged.append(chunk)
        return True

    def _restage(self, k: int):
        """Dispatch size changed: return staged hosts to the front of the
        pending queue in original order and drop their device copies."""
        while self._staged:
            chunk = self._staged.pop()
            self._pending.extendleft(reversed(chunk.hosts))

    def next_chunk(self, k: int) -> Optional[StagedChunk]:
        if self._staged and self._staged[0].k != k:
            self._restage(k)
        while len(self._staged) < self.depth:
            if not self._stage_one(k):
                break
        if not self._staged:
            return None
        return self._staged.popleft()

    def __iter__(self):
        """k == 1 convenience stream (evaluate/predict): yields
        (device_batch, host_batch) pairs."""
        while True:
            chunk = self.next_chunk(1)
            if chunk is None:
                return
            yield chunk.singles[0], chunk.hosts[0]

    def close(self):
        self._staged.clear()
        self._pending.clear()
        host_close = getattr(self._host_it, "close", None)
        if host_close is not None:
            host_close()


def resolve_transform_workers(
        transform_workers: Optional[int] = None) -> int:
    """Resolve the transform/decode worker count — THE resolver, consulted
    by every pool in the package (thread and process infeed backends,
    image-pipeline decoders, sharded-dataset readers) so
    ``ZOO_TPU_TRANSFORM_WORKERS`` means one thing everywhere.

    ``None`` reads ``ZOO_TPU_TRANSFORM_WORKERS`` (default auto); >= 0 is
    taken literally (0 = serial in the prefetch thread); negative means
    auto — size the pool from the host core count so the host half can
    keep pace with the model's consumption rate. The auto pool is
    clamped to [2, 8]: below 2 a single worker cannot hide per-batch
    transform latency behind the device step, above 8 the ordered
    hand-off queue is the bottleneck, not the pool."""
    if transform_workers is None:
        transform_workers = int(
            os.environ.get("ZOO_TPU_TRANSFORM_WORKERS") or -1)
    if transform_workers >= 0:
        return int(transform_workers)
    return max(2, min(8, os.cpu_count() or 2))


INFEED_BACKENDS = ("auto", "thread", "process")


def resolve_infeed_backend(backend: Optional[str] = None,
                           preprocessing=None) -> str:
    """Pick the transform-pool backend: ``thread`` or ``process``.

    Explicit wins: ``backend`` argument, else ``ZOO_TPU_INFEED_BACKEND``,
    else ``auto`` — an explicit ``"auto"`` (the ZooConfig default the
    engine always passes) also defers to the env var, so
    ``ZOO_TPU_INFEED_BACKEND=process`` reaches an unmodified training
    script. Auto chooses ``process`` only when it can actually
    pay off: the Preprocessing chain declares itself CPU-bound Python
    (``cpu_bound=True`` — GIL-holding work that threads serialize), the
    chain survives pickling (spawned workers must reconstruct it), and
    the host has more than one core. Everything else stays on threads,
    where numpy's GIL-releasing kernels already scale and the hand-off
    is cheaper.
    """
    b = (backend or "auto").strip().lower()
    if b == "auto":
        b = (os.environ.get("ZOO_TPU_INFEED_BACKEND") or
             "auto").strip().lower()
    if b not in INFEED_BACKENDS:
        raise ValueError(
            f"ZOO_TPU_INFEED_BACKEND={b!r}: expected one of "
            f"{INFEED_BACKENDS}")
    if b != "auto":
        return b
    if preprocessing is None or \
            not getattr(preprocessing, "cpu_bound", False):
        return "thread"
    if (os.cpu_count() or 1) < 2:
        return "thread"
    try:
        pickle.dumps(preprocessing)
    except Exception:  # noqa: BLE001 - closures/lambdas in the chain
        logger.info("infeed auto backend: cpu_bound chain is not "
                    "picklable; staying on threads")
        return "thread"
    return "process"


def build_host_pipeline(fs: FeatureSet, batch_size: int, *,
                        shuffle: bool = False, drop_remainder: bool = True,
                        pad_remainder: bool = False, seed: int = 0,
                        transform_workers: Optional[int] = -1,
                        prefetch_depth: int = 2,
                        infeed_backend: Optional[str] = None
                        ) -> PrefetchIterator:
    """Host half of the staged pipeline: (parallel) transform + prefetch.

    Returns a closeable iterator of host MiniBatches; wrap it in a
    ``DeviceStagingIterator`` for the device half. ``transform_workers``
    only applies when ``fs`` carries a Preprocessing chain
    (TransformedFeatureSet); raw array slicing is already cheap. The
    default (-1) auto-sizes the pool from the host core count
    (:func:`resolve_transform_workers`); ``infeed_backend`` selects
    thread vs process transform workers
    (:func:`resolve_infeed_backend`).
    """
    transform_workers = resolve_transform_workers(transform_workers)
    kw = dict(shuffle=shuffle, drop_remainder=drop_remainder,
              pad_remainder=pad_remainder, seed=seed)
    if transform_workers > 0 and isinstance(fs, TransformedFeatureSet):
        it = fs.batches(batch_size, num_workers=transform_workers,
                        backend=infeed_backend, **kw)
    else:
        it = fs.batches(batch_size, **kw)
    return PrefetchIterator(it, depth=prefetch_depth)
