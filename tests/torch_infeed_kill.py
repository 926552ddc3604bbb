"""Kill a ``ProcessTransformPool`` worker and check the epoch still ends.

Run as ``python -c "import torch_infeed_kill as k; k.main(DIR)"`` with
``tests/`` and the repo root on ``PYTHONPATH`` (the pool's spawned
workers import this module to unpickle its chains; it imports no JAX and
no pytest). ``main`` runs two epochs and exits 0 only if both end with
every batch, in order, equal to the plain transform's:

1. ``ZOO_TPU_FAULT=infeed-worker:kill@2``: a worker SIGKILLs itself after
   its second transform, before its result ships;
2. a worker SIGKILLed by the parent while it writes a pickled result of
   16 MB into its pipe (the parent reads nothing until then, so the
   write is blocked part-way: a lock or half a message is what a shared
   result queue would be left holding).

A hang shows as the caller's time limit; the caller runs this in a
subprocess with one.
"""

import os
import signal
import sys
import time

import numpy as np

# rows of 4 float32 values repeated to 16 MB a batch of 8
FAT_REPEAT = 1 << 17


def double(batch):
    return type(batch)(tuple(x * 2.0 for x in batch.inputs),
                       batch.targets, batch.weights)


def fat_marked(batch):
    """A 16 MB batch; then a mark file named by this process's pid and
    the batch's first target, in the directory ``ZOO_TEST_MARK_DIR``."""
    out = type(batch)(
        tuple(np.repeat(x * 2.0, FAT_REPEAT, axis=1) for x in batch.inputs),
        batch.targets, batch.weights)
    mark = os.path.join(os.environ["ZOO_TEST_MARK_DIR"],
                        f"{os.getpid()}-{int(batch.targets[0])}")
    open(mark, "w").close()
    return out


def _same(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(list(a.inputs) + [a.targets],
                        list(b.inputs) + [b.targets]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, i
            assert x.tobytes() == y.tobytes(), f"batch {i} differs"


def _fs(n):
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet

    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return FeatureSet.array(x, np.arange(n, dtype=np.float32))


def _drain(pool):
    try:
        return [b for b in pool]
    finally:
        pool.close()


def fault_kill(root):
    from analytics_zoo_tpu_torch.feature.common import LambdaPreprocessing
    from analytics_zoo_tpu_torch.feature.host_pipeline import \
        ProcessTransformPool

    state = os.path.join(root, "fault_state")
    os.makedirs(state)
    os.environ["ZOO_TPU_FAULT"] = "infeed-worker:kill@2"
    os.environ["ZOO_TPU_FAULT_STATE"] = state
    try:
        fs = _fs(128)
        want = list(fs.transform(LambdaPreprocessing(double)).batches(8))
        pool = ProcessTransformPool(fs.batches(8),
                                    LambdaPreprocessing(double),
                                    num_workers=2)
        got = _drain(pool)
    finally:
        del os.environ["ZOO_TPU_FAULT"], os.environ["ZOO_TPU_FAULT_STATE"]
    assert os.listdir(state), "the fault never fired"
    assert pool.respawns >= 1, pool.pool_stats()
    _same(got, want)


def kill_mid_write(root, timeout=60.0):
    from analytics_zoo_tpu_torch.feature.common import LambdaPreprocessing
    from analytics_zoo_tpu_torch.feature.host_pipeline import \
        ProcessTransformPool

    marks = os.path.join(root, "marks")
    os.makedirs(marks)
    os.environ["ZOO_TEST_MARK_DIR"] = marks
    fs = _fs(64)
    # slots of 64 bytes: every result travels pickled through the pipe
    pool = ProcessTransformPool(fs.batches(8),
                                LambdaPreprocessing(fat_marked),
                                num_workers=2, slot_bytes=64)
    try:
        victim = pool._workers[0].proc.pid
        deadline = time.time() + timeout
        while not any(m.startswith(f"{victim}-") for m in os.listdir(marks)):
            if time.time() > deadline:
                raise AssertionError("worker 0 transformed nothing")
            time.sleep(0.02)
        # the result is 16 MB: its write blocks on the full pipe
        time.sleep(0.3)
        os.kill(victim, signal.SIGKILL)
        got = _drain(pool)
    finally:
        pool.close()
    assert pool.respawns >= 1, pool.pool_stats()
    assert pool.pickled_batches == 8, pool.pool_stats()
    _same(got, list(fs.transform(LambdaPreprocessing(fat_marked))
                    .batches(8)))


def main(root):
    fault_kill(root)
    kill_mid_write(root)
    print("ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
