"""The port's AutoML (``analytics_zoo_tpu_torch.automl``) against the JAX
package's on the CPU, and the behaviours of ``tests/test_automl_asha.py``
and the AutoML half of ``tests/test_ray_automl.py`` on the port with
``platform="cpu"``.

- The ASHA and run-to-completion schedulers answer the same report
  sequences with the same decisions; the window, split, scaler, config
  sampling, grid and best-trial selection give equal values.
- ``LSTMForecaster`` and ``TCNForecaster`` hold JAX's weights (copied by
  ``load_jax_params``) and fit alike: losses within 1e-5 and predictions
  within 1e-4 after an epoch (float32; the packages' products sum in
  another order), and either package's ``weights.npz`` loads in the
  other.
- The executor's exactly-once accounting, requeue of a SIGKILLed
  worker's segment, checkpoint layout and model cache; the smoke
  contract of ``analytics_zoo_tpu/automl/smoke.py`` on two spawned
  workers.

Spawned workers import this module to unpickle its stub segments, so it
imports JAX only inside test functions. Every wait on a child process is
bounded (60 s at most).
"""

import json
import math
import os
import signal
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.automl import (AshaSearchEngine, AutoForecaster,
                                            Choice, LSTMForecaster, RandInt,
                                            TCNForecaster, TCNRandomRecipe,
                                            Uniform, grid_configs,
                                            rolling_window, select_best,
                                            train_val_split)
from analytics_zoo_tpu_torch.automl import executor as texec
from analytics_zoo_tpu_torch.automl.executor import AsyncTrialExecutor
from analytics_zoo_tpu_torch.automl.scheduler import (COMPLETE, PROMOTE,
                                                      STOP, AshaScheduler,
                                                      RunToCompletionScheduler)
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.ray import RayContext, WorkerLostError

WAIT = 60


@pytest.fixture(autouse=True)
def _port_context():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _sine(n=120):
    t = np.arange(n, dtype=np.float32)
    return np.sin(t / 6)[:, None].astype(np.float32)


# ---------------------------------------------------------------------------
# stub segments (module level: spawned workers unpickle them by reference)
# ---------------------------------------------------------------------------

def _stub_segment(trial_id, config, budget, data, ckpt_dir, start_epochs=0):
    return {"trial_id": trial_id, "val_loss": config["v"] / (1 + budget),
            "epochs": budget, "seconds": 0.0, "pid": os.getpid()}


def _claiming_stub_segment(trial_id, config, budget, data, ckpt_dir,
                           start_epochs=0):
    with open(os.path.join(ckpt_dir, f"claim-{os.getpid()}"), "w"):
        pass
    time.sleep(0.5)
    return _stub_segment(trial_id, config, budget, data, ckpt_dir)


def _nan_stub_segment(trial_id, config, budget, data, ckpt_dir,
                      start_epochs=0):
    out = _stub_segment(trial_id, config, budget, data, ckpt_dir)
    if config.get("diverge"):
        out["val_loss"] = float("nan")
    return out


def _boom_segment(trial_id, config, budget, data, ckpt_dir, start_epochs=0):
    if config.get("boom"):
        raise ValueError("segment kaboom")
    return _stub_segment(trial_id, config, budget, data, ckpt_dir)


def _sleep_then(seconds, value):
    time.sleep(seconds)
    return value


def _touch_sleep_then(path, seconds, value):
    with open(path, "w"):
        pass
    time.sleep(seconds)
    return value


# ---------------------------------------------------------------------------
# schedulers, features, search primitives: equal to JAX's
# ---------------------------------------------------------------------------

REPORTS = [("a", 0.5), ("b", 0.9), ("c", 0.1), ("d", 0.2), ("e", 0.05),
           ("f", 0.07), ("a", 0.4), ("c", 0.08), ("nan", float("nan")),
           ("e", 0.03), ("a", 0.3), ("inf", float("inf")), ("f", 0.06)]


@pytest.mark.parametrize("kw", [
    dict(max_epochs=9, min_epochs=1, reduction_factor=3),
    dict(max_epochs=50, min_epochs=2, reduction_factor=4),
    dict(max_epochs=1, min_epochs=1, reduction_factor=3)])
def test_asha_decisions_match_jax(kw):
    from analytics_zoo_tpu.automl import scheduler as jsched

    port, ref = AshaScheduler(**kw), jsched.AshaScheduler(**kw)
    assert port.rungs() == ref.rungs()
    assert port.initial_budget() == ref.initial_budget()
    for tid, loss in REPORTS:
        a, b = port.on_report(tid, loss), ref.on_report(tid, loss)
        assert (a.action, a.budget, a.rung) == (b.action, b.budget, b.rung)
    for rung in range(len(port.rungs())):
        assert port.cutoff(rung) == ref.cutoff(rung)


def test_scheduler_validation_and_run_to_completion():
    for bad in (dict(max_epochs=9, min_epochs=0),
                dict(max_epochs=9, reduction_factor=1),
                dict(max_epochs=1, min_epochs=2)):
        with pytest.raises(ValueError):
            AshaScheduler(**bad)
    s = RunToCompletionScheduler(max_epochs=7)
    assert (s.initial_budget(), s.rungs()) == (7, [7])
    assert s.on_report("t", 0.1).action == COMPLETE
    d = AshaScheduler(max_epochs=9).on_report("t0", 99.0)
    assert (d.action, d.rung, d.budget) == (PROMOTE, 0, 2)
    assert AshaScheduler(max_epochs=9).on_report("n", float("nan")
                                                 ).action == STOP


def test_features_and_search_primitives_match_jax():
    from analytics_zoo_tpu.automl import feature as jfeat
    from analytics_zoo_tpu.automl import search as jsearch

    series = np.random.default_rng(0).standard_normal((50, 3)).astype(
        np.float32)
    for a, b in zip(rolling_window(series, 6, 2),
                    jfeat.rolling_window(series, 6, 2)):
        np.testing.assert_array_equal(a, b)
    x, y = rolling_window(series, 6, 2)
    for a, b in zip(train_val_split(x, y, 0.3),
                    jfeat.train_val_split(x, y, 0.3)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    from analytics_zoo_tpu_torch.automl import Scaler
    ps, js = Scaler().fit(series), jfeat.Scaler().fit(series)
    np.testing.assert_array_equal(ps.transform(series),
                                  js.transform(series))
    np.testing.assert_array_equal(ps.inverse_transform_y(x[:, 0, 0]),
                                  js.inverse_transform_y(x[:, 0, 0]))
    with pytest.raises(ValueError, match="too short"):
        rolling_window(series[:5], 6, 1)

    space = {"model": "lstm", "u": Choice([1, 2, 3]), "d": Uniform(0, 1),
             "n": RandInt(1, 4)}
    jspace = {"model": "lstm", "u": jsearch.Choice([1, 2, 3]),
              "d": jsearch.Uniform(0, 1), "n": jsearch.RandInt(1, 4)}
    from analytics_zoo_tpu_torch.automl.search import sample_config
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    assert [sample_config(space, rng_a) for _ in range(6)] == \
        [jsearch.sample_config(jspace, rng_b) for _ in range(6)]
    assert grid_configs(space) == jsearch.grid_configs(jspace)
    with pytest.raises(ValueError, match="10000 trials.*random.*asha"):
        grid_configs({"a": RandInt(1, 100), "b": RandInt(1, 100)})
    trials = [{"val_loss": float("nan"), "config": {"a": 1}},
              {"val_loss": 0.5, "config": {"a": 2}},
              {"val_loss": float("inf"), "config": {"a": 3}},
              {"val_loss": 0.7, "config": {"a": 4}, "state": "failed"}]
    assert select_best(trials)["config"] == {"a": 2}
    assert trials[0]["state"] == "failed"
    with pytest.raises(RuntimeError, match="all 2 trials failed"):
        select_best([{"val_loss": float("nan")},
                     {"val_loss": None, "error": "boom"}])
    with pytest.raises(ValueError, match="asha.*grid.*random"):
        AutoForecaster(recipe=None, engine="hyperband")


# ---------------------------------------------------------------------------
# forecasters: fit alike from JAX's weights, checkpoints both ways
# ---------------------------------------------------------------------------

FORECASTERS = [("lstm", {"lstm_units": (8,), "dropout": 0.0}),
               ("tcn", {"n_filters": 4, "kernel_size": 2, "n_blocks": 2,
                        "dropout": 0.0})]


def _paired_forecasters(model, kw):
    import jax

    from analytics_zoo_tpu.automl import forecaster as jfc
    from analytics_zoo_tpu.common import nncontext as jnn
    from analytics_zoo_tpu_torch.automl import forecaster as tfc
    from analytics_zoo_tpu_torch.utils import load_jax_params

    jnn.set_nncontext(None)
    jf = jfc.build_forecaster(model, lookback=8, feature_dim=1, horizon=1,
                              lr=1e-2, **kw)
    tf = tfc.build_forecaster(model, lookback=8, feature_dim=1, horizon=1,
                              lr=1e-2, **kw)
    load_jax_params(tf.model, jax.tree.map(np.asarray,
                                           jf.model.get_params()))
    return jf, tf


@pytest.mark.parametrize("model,kw", FORECASTERS)
def test_forecaster_fits_like_jax(model, kw):
    jf, tf = _paired_forecasters(model, kw)
    x, y = rolling_window(_sine(80), 8, 1)
    np.testing.assert_allclose(tf.predict(x), np.asarray(jf.predict(x)),
                               rtol=0, atol=1e-5)
    jf.fit(x, y, batch_size=16, epochs=1)
    tf.fit(x, y, batch_size=16, epochs=1)
    np.testing.assert_allclose(tf.predict(x), np.asarray(jf.predict(x)),
                               rtol=0, atol=1e-4)
    jres, tres = jf.evaluate(x, y, batch_size=16), tf.evaluate(x, y, 16)
    assert set(tres) == set(jres)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_forecaster_weights_npz_load_across_packages(direction, tmp_path):
    jf, tf = _paired_forecasters(*FORECASTERS[0])
    x, y = rolling_window(_sine(60), 8, 1)
    path = str(tmp_path / "trial-0" / "weights.npz")
    src, dst = (jf, tf) if direction == "jax_to_port" else (tf, jf)
    src.fit(x, y, batch_size=16, epochs=1)
    src.save_params(path)
    assert os.listdir(tmp_path / "trial-0") == ["weights.npz"]
    dst.load_params(path)
    np.testing.assert_allclose(np.asarray(dst.predict(x)),
                               np.asarray(src.predict(x)), rtol=0,
                               atol=1e-5)


def test_unknown_forecaster_raises():
    from analytics_zoo_tpu_torch.automl import build_forecaster
    with pytest.raises(ValueError, match="unknown forecaster"):
        build_forecaster("gru", lookback=4)
    f = build_forecaster("lstm", lookback=4, lstm_units=4, unknown=1)
    assert isinstance(f, LSTMForecaster) and f.lstm_units == [4]
    assert isinstance(build_forecaster("TCN", lookback=4, n_blocks=1),
                      TCNForecaster)


# ---------------------------------------------------------------------------
# segments and the executor
# ---------------------------------------------------------------------------

_SEG_CFG = {"model": "lstm", "lstm_units": (4,), "batch_size": 16,
            "dropout": 0.0, "lr": 1e-2}


def _tiny_windows():
    x, y = rolling_window(_sine(80), 6, 1)
    (xt, yt), (xv, yv) = train_val_split(x, y, 0.25)
    return xt, yt, xv, yv


def test_segment_checkpoint_layout_and_committed_epochs(tmp_path):
    data = _tiny_windows()
    r1 = texec.run_trial_segment(0, _SEG_CFG, 1, data, str(tmp_path), 0)
    assert r1["epochs"] == 1 and not r1["resumed"]
    trial_dir = tmp_path / "trial-0"
    assert sorted(os.listdir(trial_dir)) == ["progress.json", "weights.npz"]
    progress = json.loads((trial_dir / "progress.json").read_text())
    assert progress["epochs"] == 1 and len(progress["token"]) == 32
    r2 = texec.run_trial_segment(0, _SEG_CFG, 1, data, str(tmp_path), 0)
    assert r2["epochs"] == 0 and r2["resumed"] and r2["cached"]
    r3 = texec.run_trial_segment(0, _SEG_CFG, 2, data, str(tmp_path), 1)
    assert r3["epochs"] == 2
    # a foreign commit rolls the token: the cached model is not trusted
    texec._write_progress(str(trial_dir / "weights.npz"), 4)
    r4 = texec.run_trial_segment(0, _SEG_CFG, 2, data, str(tmp_path), 3)
    assert not r4["cached"] and r4["resumed"] and r4["epochs"] == 1


def test_port_segment_resumes_a_jax_checkpoint(tmp_path):
    """A trial directory written by the JAX executor resumes in the port's
    segment (same file names, same npz leaves, same sidecar)."""
    from analytics_zoo_tpu.automl import executor as jexec
    from analytics_zoo_tpu.common import nncontext as jnn

    jnn.set_nncontext(None)
    data = _tiny_windows()
    jexec.run_trial_segment(3, _SEG_CFG, 1, data, str(tmp_path), 0)
    r = texec.run_trial_segment(3, _SEG_CFG, 2, data, str(tmp_path), 1)
    assert r["resumed"] and not r["cached"] and r["epochs"] == 2
    assert math.isfinite(r["val_loss"])
    assert json.loads((tmp_path / "trial-3" / "progress.json").read_text()
                      )["epochs"] == 3


@pytest.mark.parametrize("fn,configs", [
    (_stub_segment, [{"v": v} for v in (1.0, 0.5, 2.0, 0.2, 3.0, 0.8)]),
    (_nan_stub_segment, [{"v": 1.0}, {"v": 0.5, "diverge": True},
                         {"v": 0.7}]),
    (_boom_segment, [{"v": 1.0, "boom": True}, {"v": 0.5}])])
def test_serial_executor_matches_jax(fn, configs):
    from analytics_zoo_tpu.automl import executor as jexec
    from analytics_zoo_tpu.automl import scheduler as jsched

    port = AsyncTrialExecutor(AshaScheduler(max_epochs=9), trial_fn=fn,
                              serial=True)
    ref = jexec.AsyncTrialExecutor(jsched.AshaScheduler(max_epochs=9),
                                   trial_fn=fn, serial=True)
    got, want = port.run(configs, data=None), ref.run(configs, data=None)
    assert got == want
    assert port.stats == ref.stats
    assert port.stats["finalized"] == len(configs)


def test_executor_defaults_to_the_card():
    ex = AsyncTrialExecutor(AshaScheduler(max_epochs=3))
    assert ex.platform is None and ex.max_concurrent == 2


def test_seeded_serial_asha_search_is_deterministic():
    x, y = rolling_window(_sine(140), 8, 1)
    (xt, yt), (xv, yv) = train_val_split(x, y, 0.2)
    space = {"model": "lstm", "lstm_units": Choice([(4,), (6,)]),
             "lr": Choice([1e-2, 3e-3]), "batch_size": 32, "dropout": 0.0}

    def run_once():
        eng = AshaSearchEngine(serial=True)
        best = eng.run(space, (xt, yt, xv, yv), num_samples=3, epochs=3,
                       seed=7)
        return best, [(t["config"], t["val_loss"], t["state"])
                      for t in eng.trials]
    (best_a, trials_a), (best_b, trials_b) = run_once(), run_once()
    assert best_a["config"] == best_b["config"]
    assert best_a["val_loss"] == best_b["val_loss"]
    assert trials_a == trials_b and math.isfinite(best_a["val_loss"])


def test_asha_smoke_contract_with_a_sigkill(tmp_path):
    """``analytics_zoo_tpu/automl/smoke.py``'s contract on the port: 8
    trials of ASHA on two spawned workers, one SIGKILLed when it claims a
    segment; its segment is requeued exactly once, every trial finalized
    once, at least one stopped early, the best loss finite."""
    ctx = RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                     platform="cpu").init()
    victim = ctx._procs[0].pid
    killed = []

    def kill_on_claim():
        claim = tmp_path / f"claim-{victim}"
        deadline = time.time() + WAIT
        while not claim.exists() and time.time() < deadline:
            time.sleep(0.02)
        os.kill(victim, signal.SIGKILL)
        killed.append(victim)

    killer = threading.Thread(target=kill_on_claim, daemon=True)
    killer.start()
    try:
        ex = AsyncTrialExecutor(AshaScheduler(max_epochs=9), ray_ctx=ctx,
                                max_concurrent=2,
                                trial_fn=_claiming_stub_segment,
                                workdir=str(tmp_path))
        trials = ex.run([{"v": 0.5 + 0.37 * ((3 * i) % 8)}
                         for i in range(8)], data=None)
        killer.join(timeout=WAIT)
    finally:
        ctx.stop()
    stats = ex.stats
    assert killed == [victim]
    assert stats["requeued"] == 1 and sum(t["requeues"] for t in trials) == 1
    assert stats["finalized"] == 8 and stats["failed"] == 0
    assert stats["stopped"] > 0 and stats["max_concurrent"] >= 2
    assert all(t["state"] in ("completed", "stopped") for t in trials)
    assert math.isfinite(min(t["val_loss"] for t in trials))


def test_worker_dead_before_claim_marker_resolves_lost(tmp_path):
    with RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                    platform="cpu") as ctx:
        busy = [ctx.remote(_touch_sleep_then).remote(
            str(tmp_path / f"busy-{i}"), 1.5, i) for i in range(2)]
        deadline = time.time() + WAIT
        while not all((tmp_path / f"busy-{i}").exists()
                      for i in range(2)) and time.time() < deadline:
            time.sleep(0.02)
        victim = ctx.remote(_sleep_then).remote(0.0, "victim")
        item = ctx._task_q.get(timeout=10)
        assert item[0] == victim.task_id
        assert ctx.get(busy, timeout=WAIT) == [0, 1]
        ctx._task_q.put(None)
        deadline = time.time() + WAIT
        while all(p.is_alive() for p in ctx._procs) and \
                time.time() < deadline:
            time.sleep(0.02)
        with pytest.raises(WorkerLostError):
            ctx.get(victim, timeout=WAIT)
        assert ctx.get(ctx.remote(_sleep_then).remote(0.0, "ok"),
                       timeout=WAIT) == "ok"
        # as-completed wait does not consume results
        fast = ctx.remote(_sleep_then).remote(0.1, "fast")
        slow = ctx.remote(_sleep_then).remote(2.0, "slow")
        ready, not_ready = ctx.wait([slow, fast], num_returns=1)
        assert [r.task_id for r in ready] == [fast.task_id]
        assert [r.task_id for r in not_ready] == [slow.task_id]
        assert ctx.get([fast, slow], timeout=WAIT) == ["fast", "slow"]


def test_auto_forecaster_on_cpu_workers():
    """The search runs its trials in spawned CPU workers, the winner is
    refit in the driver, and predictions track the sine."""
    series = _sine(200)[:, 0]
    with RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                    platform="cpu") as ctx:
        auto = AutoForecaster(recipe=TCNRandomRecipe(num_samples=2,
                                                     epochs=1),
                              ray_ctx=ctx).fit(series, lookback=12,
                                               horizon=1)
    assert len(auto.engine.trials) == 2
    assert all(math.isfinite(t["val_loss"]) for t in auto.engine.trials)
    x, _ = rolling_window(auto.scaler.transform(series), 12, 1)
    preds = auto.predict(x[-20:])
    assert preds.shape == (20, 1) and np.isfinite(preds).all()
