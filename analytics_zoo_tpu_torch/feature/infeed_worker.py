"""Spawn-side half of the process infeed backend.

Counterpart of ``analytics_zoo_tpu/feature/infeed_worker.py``, copied.

``ProcessTransformPool`` (host_pipeline.py) ships raw batches to N
``multiprocessing`` workers; each worker runs the pickled Preprocessing
chain and returns the transformed batch through a per-worker
``multiprocessing.shared_memory`` ring — the parent wraps the slot bytes
in numpy views with zero copies. This module is everything that runs
(or is shared) on the worker side, kept import-light: workers are
spawned (forking a process whose threads hold CUDA state is unsafe), so
every import here is paid once per worker at startup: numpy, the feature
package and the port's ``utils`` (whose ``__init__`` imports torch).
Nothing here touches ``torch.cuda``: a worker never initialises CUDA.

Wire protocol. Tasks arrive on the worker's own task pipe as ``(seq,
slot, raw_batch)``, ``slot`` being the ring slot the parent lent with the
task (None when the consumer held every lease), and ``None`` ends the
worker. One message per task goes back on the worker's own result pipe,
written straight from this process (no feeder thread, no lock shared
with other workers: a worker killed mid-write leaves the parent an EOF,
not a held lock):

``("shm", wid, seq, slot, metas, template, elapsed)``
    The batch's arrays live in worker ``wid``'s ring at ``slot``;
    ``metas`` is ``[(byte_offset, shape, dtype_str), ...]`` per array
    and ``template`` rebuilds the MiniBatch structure around them.
``("pkl", wid, seq, slot, payload, elapsed)``
    Fallback when the batch exceeds the slot size, contains non-ndarray
    leaves, or no slot was lent (the consumer is holding every lease —
    e.g. a caching tier retaining the whole epoch): the batch travels
    pickled through the pipe, and the lent slot (if any) goes back.
    Correctness is identical; only the zero-copy property is lost, and
    only for that batch.
``("err", wid, seq, slot, payload)``
    The transform raised; the parent re-raises at batch ``seq``'s
    position in the output stream.
``("fatal", wid, -1, payload)``
    The worker cannot run at all (the Preprocessing chain failed to
    unpickle — e.g. it references names the spawned interpreter cannot
    import). The parent surfaces this immediately instead of burning
    the respawn budget on a structurally-broken worker.
``("spans", wid, pid, events)``
    Telemetry only (shipped when ``ZOO_TPU_TELEMETRY`` is on, inherited
    through the spawn env): compact span-event tuples recorded around
    this worker's transforms. The parent ingests them under the
    worker's own pid so the exported Chrome trace shows a timeline per
    infeed worker process.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from typing import Any, List, Optional, Tuple

import numpy as np

_ALIGN = 64  # match the native arena's alignment


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def flatten_batch(batch) -> Tuple[Optional[List[np.ndarray]], Any]:
    """MiniBatch -> (contiguous arrays, structure template), or
    ``(None, None)`` when the value cannot take the shared-memory path
    (not a MiniBatch, or a leaf is an object array / not array-like)."""
    from .feature_set import MiniBatch

    if not isinstance(batch, MiniBatch):
        return None, None
    arrays: List[np.ndarray] = []

    def take(x) -> int:
        a = np.asarray(x)
        if a.dtype.hasobject:
            raise TypeError("object dtype")
        arrays.append(np.ascontiguousarray(a))
        return len(arrays) - 1

    try:
        xs = [take(x) for x in batch.inputs]
        t = batch.targets
        if t is None:
            ty: Tuple = ("none",)
        elif isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            ty = (kind, [take(v) for v in t])
        else:
            ty = ("arr", take(t))
        w = None if batch.weights is None else take(batch.weights)
    except (TypeError, ValueError):
        return None, None
    return arrays, (xs, ty, w)


def rebuild_batch(template, arrays: List[np.ndarray]):
    """Inverse of :func:`flatten_batch` over any array sequence (the
    parent passes zero-copy shared-memory views)."""
    from .feature_set import MiniBatch

    xs_idx, ty, w = template
    xs = tuple(arrays[i] for i in xs_idx)
    if ty[0] == "none":
        t = None
    elif ty[0] == "arr":
        t = arrays[ty[1]]
    else:
        seq = [arrays[i] for i in ty[1]]
        t = seq if ty[0] == "list" else tuple(seq)
    return MiniBatch(xs, t, None if w is None else arrays[w])


def slot_nbytes(arrays: List[np.ndarray]) -> int:
    """Bytes the arrays occupy in a slot (each array 64-byte aligned)."""
    return sum(_aligned(a.nbytes) for a in arrays)


def write_slot(buf, base: int, arrays: List[np.ndarray]) -> List[Tuple]:
    """Pack ``arrays`` into ``buf`` starting at byte ``base``; returns
    the metas list for the wire message. Caller checks the total fits."""
    metas = []
    off = 0
    for a in arrays:
        dst = np.ndarray(a.shape, a.dtype, buffer=buf, offset=base + off)
        dst[...] = a
        metas.append((off, a.shape, a.dtype.str))
        off += _aligned(a.nbytes)
    return metas


def _attach_ring(shm_name: str):
    """Attach the parent-owned segment without the resource tracker
    adopting it: in 3.10 an attaching ``SharedMemory`` registers with the
    (inherited) tracker, which would unlink the parent's segment when
    this worker exits and spam KeyErrors at parent unlink time. The
    no-op patch is worker-local and workers create no shm of their own."""
    from multiprocessing import resource_tracker, shared_memory

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=shm_name)
    finally:
        resource_tracker.register = orig


def _encode_error(e: BaseException) -> bytes:
    try:
        return pickle.dumps(e)
    except Exception:  # noqa: BLE001 - unpicklable exception state
        return pickle.dumps(RuntimeError(
            f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def worker_main(wid: int, shm_name: Optional[str], slot_bytes: int,
                fn_payload: bytes, task_conn, result_conn) -> None:
    """Entry point of one spawned transform worker.

    Reads ``(seq, slot, raw_batch)`` tasks from ``task_conn`` until the
    ``None`` sentinel (or the parent's end closing), runs the unpickled
    Preprocessing chain, and writes results to ``result_conn`` per the
    module protocol. The ``infeed-worker`` fault site fires here — after
    the transform, before the result ships — so an injected kill
    genuinely loses a batch mid-flight and the parent must recover it.
    """
    from ..utils import faults, telemetry

    tracing = telemetry.enabled()
    if tracing:
        # spans recorded here are drained into compact tuples and shipped
        # on the result pipe; the parent replays them under this pid
        telemetry.enable_forwarding()

    def _ship_spans() -> None:
        evs = telemetry.drain_events()
        if evs:
            result_conn.send(("spans", wid, os.getpid(), evs))

    try:
        fn = pickle.loads(fn_payload)
    except BaseException as e:  # noqa: BLE001 - surface, don't respawn
        result_conn.send(("fatal", wid, -1, _encode_error(e)))
        return
    shm = _attach_ring(shm_name) if shm_name else None
    items = 0
    try:
        while True:
            try:
                task = task_conn.recv()
            except EOFError:   # the parent is gone
                break
            if task is None:
                break
            seq, slot, batch = task
            t0 = time.perf_counter()
            try:
                with telemetry.span("infeed/transform", seq=seq, wid=wid):
                    out = fn(batch)
                items += 1
                faults.check("infeed-worker", items)
            except BaseException as e:  # noqa: BLE001 - ship to parent
                result_conn.send(("err", wid, seq, slot, _encode_error(e)))
                if tracing:
                    _ship_spans()
                continue
            elapsed = time.perf_counter() - t0
            shipped = False
            if shm is not None and slot is not None:
                arrays, template = flatten_batch(out)
                if arrays is not None and slot_nbytes(arrays) <= slot_bytes:
                    with telemetry.span("infeed/slot_write", seq=seq):
                        metas = write_slot(shm.buf, slot * slot_bytes,
                                           arrays)
                    result_conn.send(("shm", wid, seq, slot, metas,
                                      template, elapsed))
                    shipped = True
            if not shipped:
                result_conn.send(("pkl", wid, seq, slot,
                                  pickle.dumps(out, -1), elapsed))
            if tracing:
                _ship_spans()
    finally:
        if tracing:
            try:
                _ship_spans()
            except OSError:
                pass
        if shm is not None:
            shm.close()
