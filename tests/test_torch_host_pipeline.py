"""The port's host data layer against the JAX package on the CPU: the
ordered transform pool, the prefetch thread, the DRAM cache and its
replays, the staging contract, both resolvers, the process pool (parity,
errors, ring cleanup, respawn under ``infeed-worker:kill``), the DIRECT
arena (spill, a second process reading it, JAX's arena read by the port)
and ``fit``/``evaluate``/``predict`` through the staged pipeline.

Every comparison with JAX is bit for bit: the same numpy inputs from a
seed go through both packages, and the batches (inputs, targets and
weights, in order) must be equal. The ``fit`` comparison is of a small
float32 MLP from copied weights: 1e-6 on each step's loss and on the
outputs (one Dense layer's matmul summed in another order).

JAX is imported inside the test functions only: the process pool's
workers import this module to unpickle its chains, and must not load JAX.
"""

import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.common import LambdaPreprocessing
from analytics_zoo_tpu_torch.feature.feature_set import (
    FeatureSet, MiniBatch, PrefetchIterator, TransformStats,
    TransformedFeatureSet, shutdown_all_pipelines)
from analytics_zoo_tpu_torch.feature.host_pipeline import (
    DeviceStagingIterator, ParallelTransformIterator, ProcessTransformPool,
    build_host_pipeline, resolve_infeed_backend, resolve_transform_workers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_contexts():
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


@pytest.fixture(autouse=True, scope="module")
def _no_transform_thread_outlives_the_file():
    """After this file's tests no ``zoo-transform`` thread may be left
    alive: the JAX package's shutdown test counts every live thread of
    that name in the process (ROADMAP C36). Threads a test's pool shut
    down get a few seconds to end."""
    yield
    deadline = time.time() + 5.0
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t.is_alive() and t.name.startswith("zoo-transform"))
        if not left or time.time() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"zoo-transform threads left alive: {left}"


def _xy(n=64, dim=4):
    x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)
    y = np.arange(n, dtype=np.float32)
    return x, y


def _array_fs(n=64, dim=4):
    return FeatureSet.array(*_xy(n, dim))


def _jax_fs(n=64, dim=4):
    from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFS

    return JFS.array(*_xy(n, dim))


def _jax_lambda(fn, **kw):
    from analytics_zoo_tpu.feature.common import LambdaPreprocessing as JL

    return JL(fn, **kw)


# module-level (not nested) so the spawned process-backend workers can
# unpickle them by reference; type(batch) keeps each package's MiniBatch
def _double(batch):
    return type(batch)(tuple(x * 2.0 for x in batch.inputs),
                       batch.targets, batch.weights)


def _boom_at_24(batch):
    if float(np.asarray(batch.targets)[0]) == 24.0:  # 4th batch of 8
        raise ValueError("boom at 24")
    return _double(batch)


def _column_targets(batch):
    return type(batch)(batch.inputs, batch.targets.reshape(-1, 1),
                       batch.weights)


def _leaves(batch):
    t = batch.targets
    ts = list(t) if isinstance(t, (list, tuple)) else [t]
    return list(batch.inputs) + ts + [batch.weights]


def assert_batches_equal(got, want):
    """Two batch streams equal bit for bit: count, then each leaf's
    dtype, shape and bytes."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb), i
        for x, y in zip(la, lb):
            if x is None or y is None:
                assert x is None and y is None, i
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, i
            assert x.tobytes() == y.tobytes(), f"batch {i} differs"


# ---------------------------------------------------------------------------
# ParallelTransformIterator
# ---------------------------------------------------------------------------
class TestParallelTransformIterator:
    def test_preserves_order_and_values(self):
        items = list(range(20))

        def slow_square(i):
            time.sleep(0.001 * (20 - i) / 20)  # later items finish sooner
            return i * i

        out = list(ParallelTransformIterator(iter(items), slow_square,
                                             num_workers=4))
        assert out == [i * i for i in items]

    def test_bounded_in_flight(self):
        pulled = []

        def source():
            for i in range(100):
                pulled.append(i)
                yield i

        it = ParallelTransformIterator(source(), lambda x: x, num_workers=2)
        time.sleep(0.05)  # let the pool run: nothing should over-pull
        assert len(pulled) <= 2 + 2 + 1
        assert next(it) == 0
        it.close()

    def test_worker_error_reraised_in_order(self):
        def fn(i):
            if i == 3:
                raise ValueError("boom at 3")
            return i

        it = ParallelTransformIterator(iter(range(10)), fn, num_workers=4)
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="boom at 3"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)

    def test_close_closes_base_generator(self):
        closed = []

        def source():
            try:
                for i in range(100):
                    yield i
            finally:
                closed.append(True)

        it = ParallelTransformIterator(source(), lambda x: x, num_workers=2)
        next(it)
        it.close()
        assert closed == [True]

    def test_batches_equal_jax(self):
        from analytics_zoo_tpu.feature.host_pipeline import \
            ParallelTransformIterator as JPTI

        got = ParallelTransformIterator(
            _array_fs().batches(8, shuffle=True, seed=5),
            LambdaPreprocessing(_double), num_workers=3)
        want = JPTI(_jax_fs().batches(8, shuffle=True, seed=5),
                    _jax_lambda(_double), num_workers=3)
        assert_batches_equal(got, want)


# ---------------------------------------------------------------------------
# PrefetchIterator
# ---------------------------------------------------------------------------
class TestPrefetchIterator:
    def test_error_surfaces_before_queue_drains(self):
        started = threading.Event()

        def source():
            yield 1
            yield 2
            started.set()
            raise RuntimeError("producer died")

        it = PrefetchIterator(source(), depth=4)
        assert started.wait(timeout=5.0)
        it.thread.join(timeout=5.0)
        assert not it.thread.is_alive()
        with pytest.raises(RuntimeError, match="producer died"):
            next(it)

    def test_error_without_queued_items(self):
        def source():
            raise KeyError("immediate")
            yield  # pragma: no cover

        it = PrefetchIterator(source(), depth=2)
        with pytest.raises(KeyError):
            next(it)

    def test_close_joins_worker_and_closes_upstream(self):
        closed = []

        def source():
            try:
                for i in range(10_000):
                    yield i
            finally:
                closed.append(True)

        it = PrefetchIterator(source(), depth=1)
        next(it)
        it.close()
        assert not it.thread.is_alive()
        assert closed == [True]
        assert it.q.qsize() == 0
        with pytest.raises(StopIteration):
            next(it)

    def test_host_pipeline_equals_jax(self):
        from analytics_zoo_tpu.feature.host_pipeline import \
            build_host_pipeline as jbuild

        for kw in (dict(shuffle=True, seed=3),
                   dict(drop_remainder=False, pad_remainder=True)):
            got = build_host_pipeline(_array_fs(n=61), 8,
                                      transform_workers=0, **kw)
            want = jbuild(_jax_fs(n=61), 8, transform_workers=0, **kw)
            assert_batches_equal(got, want)


# ---------------------------------------------------------------------------
# TransformedFeatureSet: stats, parallel workers, DRAM cache tier
# ---------------------------------------------------------------------------
class TestTransformedFeatureSet:
    def test_stats_counts_batches_and_seconds(self):
        fs = _array_fs().transform(LambdaPreprocessing(_double))
        assert fs.stats().as_dict()["batches_transformed"] == 0
        list(fs.batches(8))
        s = fs.stats().as_dict()
        assert s["batches_transformed"] == 8
        assert s["transform_seconds"] >= 0.0
        assert s["cache_hits"] == 0

    def test_parallel_matches_serial(self):
        base = _array_fs()
        serial = base.transform(LambdaPreprocessing(_double))
        par = base.transform(LambdaPreprocessing(_double))
        assert_batches_equal(
            par.batches(8, shuffle=True, seed=3, num_workers=3),
            serial.batches(8, shuffle=True, seed=3))

    def test_rdd_dram_cache_replays_equal_jax(self):
        from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFS

        fs = FeatureSet.rdd(
            _array_fs().transform(LambdaPreprocessing(_double)),
            memory_type="DRAM")
        jfs = JFS.rdd(_jax_fs().transform(_jax_lambda(_double)),
                      memory_type="DRAM")
        assert isinstance(fs, TransformedFeatureSet)
        e1 = list(fs.batches(8, shuffle=True, seed=1))
        assert fs.stats().as_dict()["cache_hits"] == 0
        e2 = list(fs.batches(8, shuffle=True, seed=2))
        s = fs.stats().as_dict()
        assert s["cache_hits"] == 8
        assert s["batches_transformed"] == 8  # epoch 2 transformed nothing
        key = lambda b: b.inputs[0].tobytes()  # noqa: E731
        assert sorted(key(b) for b in e1) == sorted(key(b) for b in e2)
        assert [key(b) for b in e1] != [key(b) for b in e2]
        # the first epoch and the batch-granular replay are JAX's
        assert_batches_equal(e1, jfs.batches(8, shuffle=True, seed=1))
        assert_batches_equal(e2, jfs.batches(8, shuffle=True, seed=2))

    def test_partial_epoch_does_not_commit(self):
        fs = _array_fs().transform(LambdaPreprocessing(_double)).cache()
        it = fs.batches(8)
        next(it)
        it.close()
        list(fs.batches(8))
        assert fs.stats().as_dict()["cache_hits"] == 0

    def test_over_budget_signature_disables_caching(self, caplog):
        fs = _array_fs().transform(LambdaPreprocessing(_double)).cache(
            max_bytes=100)
        with caplog.at_level(logging.INFO, "analytics_zoo_tpu_torch.feature"):
            list(fs.batches(8))
            list(fs.batches(8))
        assert fs.stats().as_dict()["cache_hits"] == 0
        assert any("caching disabled" in r.message for r in caplog.records)

    def test_lru_eviction_across_signatures(self, caplog):
        one_epoch = 64 * 4 * 4 + 64 * 4 + 64 * 4  # x + y + w bytes
        fs = _array_fs().transform(LambdaPreprocessing(_double)).cache(
            max_bytes=int(one_epoch * 1.5))
        with caplog.at_level(logging.INFO, "analytics_zoo_tpu_torch.feature"):
            list(fs.batches(8))
            list(fs.batches(16))
        assert any("evicted signature" in r.message
                   for r in caplog.records)
        list(fs.batches(16))
        assert fs.stats().as_dict()["cache_hits"] == 4


# ---------------------------------------------------------------------------
# DeviceStagingIterator: the staging contract
# ---------------------------------------------------------------------------
def _staging(fs, batch=8, depth=2, monitor=None, **kw):
    it = build_host_pipeline(fs, batch, **kw)
    return it, DeviceStagingIterator(
        it, lambda b: ("put", b), lambda bs: ("stacked", list(bs)),
        depth=depth, monitor=monitor)


def _chunks(stg, ks):
    out = []
    for k in ks:
        c = stg.next_chunk(k)
        if c is None:
            break
        out.append(c)
    return out


class TestDeviceStagingIterator:
    def test_full_chunks_and_tail(self):
        it, stg = _staging(_array_fs(n=40), batch=8, drop_remainder=False)
        chunks = _chunks(stg, [2] * 10)
        stg.close()
        it.close()
        assert [len(c.hosts) for c in chunks] == [2, 2, 1]
        assert chunks[0].stacked is not None and chunks[0].singles is None
        assert chunks[2].stacked is None and len(chunks[2].singles) == 1

    def test_k_change_restages_without_losing_batches(self):
        it, stg = _staging(_array_fs(n=64), batch=8, depth=3)
        chunks = _chunks(stg, [3, 1] + [2] * 10)
        stg.close()
        it.close()
        seen = [h.inputs[0][0, 0] for c in chunks for h in c.hosts]
        ref = [b.inputs[0][0, 0] for b in _array_fs(n=64).batches(8)]
        assert seen == ref

    def test_chunks_and_real_counts_equal_jax(self):
        from analytics_zoo_tpu.feature.host_pipeline import (
            DeviceStagingIterator as JDSI, build_host_pipeline as jbuild)

        kw = dict(drop_remainder=False, pad_remainder=True)
        it, stg = _staging(_array_fs(n=45), batch=8, depth=2, **kw)
        jit_ = jbuild(_jax_fs(n=45), 8, **kw)
        jstg = JDSI(jit_, lambda b: b, lambda bs: bs, depth=2)
        ks = [2, 2, 1, 2, 2]
        got, want = _chunks(stg, ks), _chunks(jstg, ks)
        for s in (stg, it, jstg, jit_):
            s.close()
        assert [c.k for c in got] == [c.k for c in want]
        assert [c.real_counts for c in got] == \
            [c.real_counts for c in want]
        assert [c.real_counts for c in got][-1] == [5]  # 45 = 5 * 8 + 5
        assert_batches_equal([h for c in got for h in c.hosts],
                             [h for c in want for h in c.hosts])

    def test_monitor_accounts_input_wait(self):
        from analytics_zoo_tpu_torch.utils.profiling import InfeedMonitor

        monitor = InfeedMonitor()
        fs = _array_fs().transform(LambdaPreprocessing(
            lambda b: (time.sleep(0.002), _double(b))[1]))
        it, stg = _staging(fs, batch=8, monitor=monitor)
        while stg.next_chunk(1) is not None:
            pass
        stg.close()
        it.close()
        assert monitor.total_wait > 0.0
        w = monitor.window(8, 0.1)
        assert 0.0 <= w["input_bound_fraction"] <= 1.0
        assert w["input_wait_ms_per_step"] > 0.0
        assert monitor.window(8, 0.1)["input_wait_ms_per_step"] == 0.0

    def test_monitor_worker_utilization_equals_jax(self):
        from analytics_zoo_tpu.utils.profiling import InfeedMonitor as JIM

        from analytics_zoo_tpu_torch.utils.profiling import InfeedMonitor

        snaps = iter([{0: 0.5, 1: 0.25}, {0: 1.5, 1: 0.5}])
        jsnaps = iter([{0: 0.5, 1: 0.25}, {0: 1.5, 1: 0.5}])
        got = InfeedMonitor(worker_provider=lambda: next(snaps))
        want = JIM(worker_provider=lambda: next(jsnaps))
        for _ in range(2):
            a, b = got.window(4, 2.0), want.window(4, 2.0)
            assert a["infeed_workers"] == b["infeed_workers"] == 2.0
            assert a["infeed_worker_utilization"] == \
                b["infeed_worker_utilization"]
        assert "infeed_workers" not in InfeedMonitor().window(4, 2.0)


def test_cpu_staging_puts_plain_tensors_and_no_event():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    tnn.init_nncontext(device="cpu")
    m = Sequential()
    m.add(Dense(1, input_shape=(4,)))
    m.compile(optimizer="sgd", loss="mse")
    trainer = m._ensure_trainer()
    host = MiniBatch((np.ones((8, 4)),), np.zeros(8, np.float32),
                     np.ones(8, np.float32))
    (xs, y, w), event = trainer._put_one(host)
    assert event is None and trainer._stager() is None
    assert xs[0].dtype == torch.float32 and xs[0].device.type == "cpu"
    (xs2, y2, w2), event = trainer._put_stacked([host, host])
    assert event is None and tuple(xs2[0].shape) == (2, 8, 4)
    assert tuple(w2.shape) == (2, 8)


# ---------------------------------------------------------------------------
# the engine on the staged pipeline
# ---------------------------------------------------------------------------
def _mlp(pkg):
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu.pipeline.api.keras.models import Sequential
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
            Sequential
    m = Sequential()
    m.add(Dense(8, activation="relu", input_shape=(4,)))
    m.add(Dense(1))
    m.compile(optimizer="sgd", loss="mse")
    return m


def _regression(seed, n=70):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (x @ rng.standard_normal(4)).astype(np.float32)
    return x, y


class TestEngineIntegration:
    def _fit(self, tmp_path, cfg_kw, tb_name):
        tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=2, **cfg_kw),
                           device="cpu")
        m = _mlp("torch")
        m.set_tensorboard(str(tmp_path), tb_name)
        x, y = _regression(0, 64)
        m.fit(x, y.reshape(-1, 1), batch_size=16, nb_epoch=2)
        scalars = {tag: m.get_train_summary(tag)
                   for tag in ("InfeedWaitMs", "InputBoundFraction",
                               "StepTimeMs", "Throughput")}
        return [p.detach().numpy().copy() for p in m.parameters()], scalars

    def test_input_telemetry_scalars_emitted(self, tmp_path):
        _, scalars = self._fit(tmp_path, dict(transform_workers=2), "app")
        for tag, vals in scalars.items():
            assert vals, f"no {tag} scalar in the train event file"
        for _step, _wall, _tag, v in scalars["InputBoundFraction"]:
            assert 0.0 <= v <= 1.0

    def test_parallel_pipeline_training_is_deterministic(self, tmp_path):
        w_serial, _ = self._fit(tmp_path / "a", dict(transform_workers=0),
                                "serial")
        tnn.set_nncontext(None)
        w_par, _ = self._fit(tmp_path / "b", dict(transform_workers=3,
                                                  device_ahead=3), "par")
        for a, b in zip(w_serial, w_par):
            np.testing.assert_array_equal(a, b)

    def test_fit_on_dram_cached_transform_set_writes_worker_scalars(
            self, tmp_path):
        # the process pool reports its workers' busy seconds
        tnn.init_nncontext(tnn.ZooConfig(
            transform_workers=2, infeed_backend="process",
            log_every_n_steps=2), device="cpu")
        x, y = _regression(1, 64)
        fs = FeatureSet.rdd(FeatureSet.array(x, y).transform(
            LambdaPreprocessing(_column_targets)), memory_type="DRAM")
        m = _mlp("torch")
        m.set_tensorboard(str(tmp_path), "cached")
        m.fit(fs, batch_size=8, nb_epoch=3)
        s = fs.stats().as_dict()
        assert s["cache_hits"] == 16 and s["batches_transformed"] == 8
        workers = m.get_train_summary("InfeedWorkers")
        util = m.get_train_summary("InfeedWorkerUtilization")
        assert workers and util
        assert {v for *_, v in workers} == {2.0}
        assert all(0.0 <= v <= 1.0 for *_, v in util)

    def test_fit_through_transform_pool_equals_jax(self, tmp_path):
        import jax

        from analytics_zoo_tpu.common import nncontext as jnn
        from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFS

        from analytics_zoo_tpu_torch.utils import load_jax_params

        x, y = _regression(2, 70)
        jnn.set_nncontext(None)
        jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(
            log_every_n_steps=1, transform_workers=2)))
        try:
            jm = _mlp("jax")
            jm.set_tensorboard(str(tmp_path), "jax")
            tm = _mlp("torch")
            load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))
            jm.fit(JFS.array(x, y).transform(_jax_lambda(_column_targets)),
                   batch_size=16, nb_epoch=2)
            jlosses = [v for *_, v in jm.get_train_summary("Loss")]
            jpred = np.asarray(jm.predict(x, batch_size=16))
            jeval = jm.evaluate(x, y.reshape(-1, 1), batch_size=16)
        finally:
            jnn.set_nncontext(None)
        tnn.init_nncontext(tnn.ZooConfig(transform_workers=2), device="cpu")
        tm.fit(FeatureSet.array(x, y).transform(
            LambdaPreprocessing(_column_targets)), batch_size=16, nb_epoch=2)
        assert len(tm.trainer.step_losses) == len(jlosses) == 8
        np.testing.assert_allclose(tm.trainer.step_losses, jlosses,
                                   rtol=0, atol=1e-6)
        # 70 rows at 16: the last batch holds 6 real rows and 10 pad rows
        tpred = tm.predict(x, batch_size=16)
        assert tpred.shape == jpred.shape == (70, 1)
        np.testing.assert_allclose(tpred, jpred, rtol=0, atol=1e-6)
        teval = tm.evaluate(x, y.reshape(-1, 1), batch_size=16)
        np.testing.assert_allclose(teval["loss"], jeval["loss"], rtol=1e-6)
        assert tm.trainer.last_predict_stats["PredictThroughput"] > 0

    def test_resume_skips_on_the_host_iterator(self):
        tnn.init_nncontext(device="cpu")
        x, y = _regression(3, 64)
        fs = FeatureSet.array(x, y.reshape(-1, 1))
        full = _mlp("torch")
        start = [p.detach().clone() for p in full.parameters()]
        full.fit(fs, batch_size=8, nb_epoch=1)
        part = _mlp("torch")
        with torch.no_grad():
            for p, s in zip(part.parameters(), start):
                p.copy_(s)
        trainer = part._ensure_trainer()
        trainer.ensure_initialized()
        # replay the first 3 steps by hand, then resume the epoch mid-way
        for b in list(fs.batches(8, shuffle=True, seed=trainer.seed))[:3]:
            trainer.train_step(trainer.put_batch(b))
        trainer.epoch_batches = 3
        part.fit(fs, batch_size=8, nb_epoch=1)
        for a, b in zip(full.parameters(), part.parameters()):
            np.testing.assert_array_equal(a.detach().numpy(),
                                          b.detach().numpy())


# ---------------------------------------------------------------------------
# launcher-driven teardown
# ---------------------------------------------------------------------------
class TestShutdownAllPipelines:
    def _alive_transform_threads(self):
        return [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("zoo-transform")]

    def test_closes_stages_and_stops_threads(self):
        baseline = len(self._alive_transform_threads())

        def slow_double(batch):
            time.sleep(0.01)
            return _double(batch)

        fs = _array_fs(n=512).transform(LambdaPreprocessing(slow_double))
        host_it = build_host_pipeline(fs, 8, transform_workers=3,
                                      prefetch_depth=2)
        staged = DeviceStagingIterator(host_it, lambda b: b,
                                       lambda bs: bs, depth=2)
        assert staged.next_chunk(2) is not None
        prefetch_thread = host_it.thread
        assert prefetch_thread.is_alive()
        assert len(self._alive_transform_threads()) > baseline
        assert shutdown_all_pipelines() >= 3
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if not prefetch_thread.is_alive() and \
                    len(self._alive_transform_threads()) <= baseline:
                break
            time.sleep(0.05)
        assert not prefetch_thread.is_alive()
        assert len(self._alive_transform_threads()) <= baseline

    def test_idempotent_and_weakset_drains(self):
        shutdown_all_pipelines()
        it = PrefetchIterator(iter([1, 2, 3]), depth=1)
        next(it)
        assert shutdown_all_pipelines() >= 1
        assert shutdown_all_pipelines() == 0


# ---------------------------------------------------------------------------
# the resolvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, -1, 0, 3])
@pytest.mark.parametrize("env", [None, "5", "-1"])
def test_resolve_transform_workers_equals_jax(monkeypatch, value, env):
    from analytics_zoo_tpu.feature.host_pipeline import \
        resolve_transform_workers as jresolve

    if env is None:
        monkeypatch.delenv("ZOO_TPU_TRANSFORM_WORKERS", raising=False)
    else:
        monkeypatch.setenv("ZOO_TPU_TRANSFORM_WORKERS", env)
    assert resolve_transform_workers(value) == jresolve(value)
    auto = max(2, min(8, os.cpu_count() or 2))
    assert resolve_transform_workers(-1) == auto


def test_resolve_infeed_backend_equals_jax(monkeypatch):
    from analytics_zoo_tpu.feature.host_pipeline import \
        resolve_infeed_backend as jresolve

    monkeypatch.delenv("ZOO_TPU_INFEED_BACKEND", raising=False)
    cases = [(None, LambdaPreprocessing(_double), _jax_lambda(_double)),
             (None, LambdaPreprocessing(_double, cpu_bound=True),
              _jax_lambda(_double, cpu_bound=True)),
             (None, LambdaPreprocessing(lambda b: b, cpu_bound=True),
              _jax_lambda(lambda b: b, cpu_bound=True)),
             ("process", LambdaPreprocessing(_double),
              _jax_lambda(_double)),
             ("thread", LambdaPreprocessing(_double, cpu_bound=True),
              _jax_lambda(_double, cpu_bound=True))]
    for env in (None, "process"):
        if env is not None:
            monkeypatch.setenv("ZOO_TPU_INFEED_BACKEND", env)
        for backend, chain, jchain in cases:
            assert resolve_infeed_backend(backend, chain) == \
                jresolve(backend, jchain)
    assert resolve_infeed_backend(
        None, LambdaPreprocessing(_double)) == "process"
    monkeypatch.setenv("ZOO_TPU_INFEED_BACKEND", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        resolve_infeed_backend(None, LambdaPreprocessing(_double))


def test_zoo_config_data_fields_equal_jax(monkeypatch):
    from analytics_zoo_tpu.common.nncontext import ZooConfig as JZC

    fields = ("prefetch_depth", "transform_workers", "infeed_backend",
              "device_ahead")
    for f in fields:
        monkeypatch.delenv("ZOO_TPU_" + f.upper(), raising=False)
    assert {f: getattr(tnn.ZooConfig(), f) for f in fields} == \
        {f: getattr(JZC(), f) for f in fields}
    monkeypatch.setenv("ZOO_TPU_TRANSFORM_WORKERS", "3")
    monkeypatch.setenv("ZOO_TPU_INFEED_BACKEND", "process")
    monkeypatch.setenv("ZOO_TPU_DEVICE_AHEAD", "4")
    cfg = tnn.ZooConfig.from_env()
    assert (cfg.transform_workers, cfg.infeed_backend, cfg.device_ahead) \
        == (3, "process", 4)


# ---------------------------------------------------------------------------
# ProcessTransformPool: spawned workers + shared-memory rings
# ---------------------------------------------------------------------------
def _drain(pool, seconds=120.0):
    """``list(pool)`` on a daemon thread, failing the test (and closing
    the pool) if the epoch has not ended within ``seconds``: a pool whose
    workers stop answering fails here instead of holding the run."""
    out = {}

    def run():
        try:
            out["batches"] = list(pool)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pool.close()
        pytest.fail(f"the process pool gave no end of epoch in {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["batches"]


class TestProcessTransformPool:
    def _pool(self, fs=None, n=64, workers=2, fn=_double, **kw):
        fs = fs or _array_fs(n=n)
        return ProcessTransformPool(fs.batches(8), LambdaPreprocessing(fn),
                                    num_workers=workers, **kw)

    def test_batches_equal_jax_thread_pool(self):
        from analytics_zoo_tpu.feature.host_pipeline import \
            ParallelTransformIterator as JPTI

        stats = TransformStats()
        pool = self._pool(stats=stats)
        got = _drain(pool)
        want = JPTI(_jax_fs().batches(8), _jax_lambda(_double),
                    num_workers=2)
        assert_batches_equal(got, want)
        assert pool.shm_batches == 8 and pool.pickled_batches == 0
        s = stats.as_dict()
        assert s["batches_transformed"] == 8
        assert sum(s["worker_items"].values()) == 8
        assert set(s["worker_items"]) == {0, 1}

    def test_worker_error_reraised_at_position(self):
        pool = self._pool(fn=_boom_at_24)
        out = [next(pool) for _ in range(3)]
        assert [float(b.targets[0]) for b in out] == [0.0, 8.0, 16.0]
        with pytest.raises(ValueError, match="boom at 24"):
            next(pool)
        with pytest.raises(StopIteration):
            next(pool)

    def test_close_unlinks_ring_segments(self):
        from multiprocessing import shared_memory

        pool = self._pool()
        names = [w.segment.shm.name for w in pool._workers.values()]
        next(pool)
        pool.close()
        pool.close()  # idempotent
        for name in names:
            with pytest.raises(FileNotFoundError):
                shared_memory.SharedMemory(name=name)

    def test_unpicklable_chain_rejected_upfront(self):
        with pytest.raises(ValueError, match="picklable"):
            ProcessTransformPool(_array_fs().batches(8),
                                 LambdaPreprocessing(lambda b: b),
                                 num_workers=2)

    def test_oversized_batches_travel_pickled(self):
        pool = self._pool(slot_bytes=64)
        got = _drain(pool)
        assert pool.pickled_batches == 8 and pool.shm_batches == 0
        assert_batches_equal(got, _array_fs().transform(
            LambdaPreprocessing(_double)).batches(8))

    def test_chaos_worker_kill_respawns_complete_epoch(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setenv("ZOO_TPU_FAULT", "infeed-worker:kill@2")
        monkeypatch.setenv("ZOO_TPU_FAULT_STATE", str(tmp_path))
        fs = _array_fs(n=128)
        ref = list(fs.transform(LambdaPreprocessing(_double)).batches(8))
        pool = ProcessTransformPool(fs.batches(8),
                                    LambdaPreprocessing(_double),
                                    num_workers=2)
        got = _drain(pool)
        assert os.path.exists(
            str(tmp_path / "fired.infeed-worker_kill_2")), \
            "fault never fired"
        assert pool.respawns >= 1
        assert_batches_equal(got, ref)  # complete, ordered, no duplicates


# ROADMAP C35: a worker SIGKILLed at once while it writes a 16 MB result
# (and one killed by the infeed-worker fault), 8 copies, each in a
# subprocess under its own time limit: a hang fails that copy
KILL_COPIES = 8
KILL_TIMEOUT_S = 120


@pytest.mark.parametrize("copy", range(KILL_COPIES))
def test_worker_killed_mid_write_never_hangs(copy, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "tests"), ROOT] +
        env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("ZOO_TPU_FAULT", None)
    r = subprocess.run(
        [sys.executable, "-c",
         f"import torch_infeed_kill as k; k.main({str(tmp_path)!r})"],
        env=env, capture_output=True, text=True, timeout=KILL_TIMEOUT_S)
    assert r.returncode == 0 and r.stdout.strip() == "ok", \
        r.stdout + r.stderr


def _npz_shards(tmp_path, n_shards=3, rows=16):
    from analytics_zoo_tpu_torch.feature.feature_set import DiskFeatureSet

    rng = np.random.default_rng(5)
    paths = []
    for i in range(n_shards):
        p = str(tmp_path / f"shard{i}.npz")
        DiskFeatureSet.write_shard(
            p, rng.standard_normal((rows, 2)).astype(np.float32),
            rng.integers(0, 2, rows).astype(np.int64))
        paths.append(p)
    return paths


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_backend_parity_over_npz_with_arena_spill(tmp_path, backend):
    """Thread and process backends give the JAX package's epoch bit for
    bit over npz shards, across the DRAM -> DIRECT spill boundary, and
    the second epoch replays RAM prefix + arena tail with zero
    re-transforms."""
    from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFS

    paths = _npz_shards(tmp_path)
    tfs = FeatureSet.files(paths, shard_per_host=False).transform(
        LambdaPreprocessing(_double, cpu_bound=True))
    tfs.cache(600, arena_path=str(tmp_path / f"{backend}.arena"))
    want = list(JFS.files(paths, shard_per_host=False).transform(
        _jax_lambda(_double)).batches(8))
    e1 = list(tfs.batches(8, num_workers=2, backend=backend))
    assert len(e1) == 6
    assert_batches_equal(e1, want)
    assert tfs.stats().as_dict()["batches_transformed"] == 6
    e2 = list(tfs.batches(8, num_workers=2, backend=backend))
    s2 = tfs.stats().as_dict()
    assert s2["batches_transformed"] == 6, "cached epoch re-transformed"
    assert s2["arena_hits"] > 0, "tail never spilled to the arena"
    assert_batches_equal(e2, e1)


# ---------------------------------------------------------------------------
# DIRECT arena: a second process, and JAX's arena file
# ---------------------------------------------------------------------------
class TestDirectArena:
    def test_second_process_replays_zero_transforms(self, tmp_path):
        arena = str(tmp_path / "x.arena")
        tfs = _array_fs().transform(LambdaPreprocessing(_double))
        tfs.cache(500, arena_path=arena)
        e1 = list(tfs.batches(8))
        assert tfs.stats().as_dict()["batches_transformed"] == 8
        script = (
            "import sys, numpy as np\n"
            "from analytics_zoo_tpu_torch.feature.feature_set import "
            "FeatureSet\n"
            "from analytics_zoo_tpu_torch.feature.common import "
            "LambdaPreprocessing\n"
            "x = np.arange(256, dtype=np.float32).reshape(64, 4)\n"
            "y = np.arange(64, dtype=np.float32)\n"
            "tfs = FeatureSet.array(x, y).transform("
            "LambdaPreprocessing(lambda b: b))\n"
            f"tfs.cache(500, arena_path={arena!r})\n"
            "out = list(tfs.batches(8))\n"
            "s = tfs.stats().as_dict()\n"
            "assert s['batches_transformed'] == 0, s\n"
            "assert s['arena_hits'] == 8, s\n"
            "assert 'jax' not in sys.modules\n"
            "print(out[0].inputs[0][0, 0], out[-1].inputs[0][-1, -1])\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        first, last = r.stdout.split()
        assert float(first) == float(e1[0].inputs[0][0, 0])
        assert float(last) == float(e1[-1].inputs[0][-1, -1])

    def test_port_replays_an_arena_jax_wrote(self, tmp_path):
        arena = str(tmp_path / "j.arena")
        jtfs = _jax_fs().transform(_jax_lambda(_double))
        jtfs.cache(500, arena_path=arena)
        want = list(jtfs.batches(8, shuffle=True, seed=4))
        tfs = _array_fs().transform(LambdaPreprocessing(_double))
        tfs.cache(500, arena_path=arena)
        assert tfs._fingerprint() == jtfs._fingerprint()
        got = list(tfs.batches(8, shuffle=True, seed=4))
        s = tfs.stats().as_dict()
        assert s["batches_transformed"] == 0 and s["arena_hits"] == 8
        # the arena holds epoch order: JAX's first epoch replays in it
        assert sorted(b.inputs[0].tobytes() for b in got) == \
            sorted(b.inputs[0].tobytes() for b in want)
        assert_batches_equal(
            got, jtfs.batches(8, shuffle=True, seed=4))

    def test_arena_not_committed_on_partial_epoch(self, tmp_path):
        arena = str(tmp_path / "p.arena")
        tfs = _array_fs().transform(LambdaPreprocessing(_double))
        tfs.cache(500, arena_path=arena)
        it = tfs.batches(8)
        next(it)
        it.close()
        assert not tfs._arena.has("8:1:0", tfs._fingerprint())
        assert not os.path.exists(arena + ".lock")
        list(tfs.batches(8))
        assert tfs._arena.has("8:1:0", tfs._fingerprint())
