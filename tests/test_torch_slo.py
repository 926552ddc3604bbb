"""The port's SLO engine and ``InferenceSummary`` against the JAX
package's, on one recorded series.

A seeded stream of request outcomes (latencies, errors, sheds, with
timestamps spread over two minutes) is recorded into both packages'
``SloEngine`` and evaluated at the same instants: every status (burn
rates, budgets, counts, latches) and every fired alert are equal. The
same stage latencies and queue depths go into both ``InferenceSummary``
objects: equal snapshots (percentiles in ms, rounded to 3 places by both)
and equal TensorBoard scalars. Everything here is the same float64
arithmetic in both packages, so the comparisons are exact.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.pipeline.inference import \
    inference_summary as jsummary
from analytics_zoo_tpu.utils import slo as jslo
from analytics_zoo_tpu.utils import telemetry as jtel
from analytics_zoo_tpu_torch.pipeline.inference import \
    inference_summary as tsummary
from analytics_zoo_tpu_torch.utils import slo as tslo
from analytics_zoo_tpu_torch.utils import telemetry as ttel
from analytics_zoo_tpu_torch.utils import tensorboard as ttb

SLO_CONFIG = {
    "fast_window_s": 10, "slow_window_s": 60, "burn_threshold": 2.0,
    "objectives": [{"name": "latency", "p99_ms": 80},
                   {"name": "tail", "p90_ms": 40, "burn_threshold": 1.5},
                   {"name": "errors", "error_rate": 0.02},
                   {"name": "sheds", "shed_fraction": 0.03,
                    "fast_window_s": 5}],
    "classes": [{"name": "premium", "model": "resnet50", "version": "2",
                 "weight": 3, "priority": 0,
                 "objectives": [{"name": "lat", "p99_ms": 50}]},
                {"name": "standard", "model": "resnet50", "weight": 1,
                 "priority": 1},
                {"name": "batch", "priority": 2, "shed_wait_ms": 900}]}
T0 = 10_000.0


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


def _series(seed=0, n=3000):
    """(ts, latency_ms or None, error, shed): a healthy minute, a bad
    burst of slow requests, errors and sheds, then recovery."""
    rs = np.random.default_rng(seed)
    ts = np.sort(T0 + rs.uniform(0.0, 120.0, n))
    out = []
    for t in ts:
        bad = 50.0 <= t - T0 <= 90.0
        r = rs.uniform()
        if bad and r < 0.15:
            out.append((float(t), None, False, True))
        elif bad and r < 0.30:
            out.append((float(t), None, True, False))
        else:
            lat = rs.lognormal(np.log(100.0 if bad else 12.0), 0.5)
            out.append((float(t), float(lat), False, False))
    return out


def _engines():
    return {pkg: mod.SloEngine(mod.parse_slo_config(SLO_CONFIG))
            for pkg, mod in (("jax", jslo), ("torch", tslo))}


def test_parsed_objectives_and_classes_match_jax():
    assert [vars(o) for o in tslo.parse_slo_config(SLO_CONFIG)] == \
        [vars(o) for o in jslo.parse_slo_config(SLO_CONFIG)]
    tcls = tslo.parse_slo_class_config(SLO_CONFIG)
    jcls = jslo.parse_slo_class_config(SLO_CONFIG)
    assert [(c.name, c.weight, c.priority, c.model, c.version,
             c.shed_wait_ms, [vars(o) for o in c.objectives])
            for c in tcls] == \
        [(c.name, c.weight, c.priority, c.model, c.version,
          c.shed_wait_ms, [vars(o) for o in c.objectives]) for c in jcls]
    for model, version in (("resnet50", "2"), ("resnet50", "1"),
                           ("bert", None), (None, None)):
        want = jslo.match_slo_class(jcls, model, version)
        got = tslo.match_slo_class(tcls, model, version)
        assert (got and got.name) == (want and want.name)


@pytest.mark.parametrize("bad", [
    {"objectives": [{"name": "x", "p99_ms": 1, "error_rate": 0.1}]},
    {"objectives": [{"name": "x", "p42_ms": 1}]},
    {"objectives": [{"name": "x", "error_rate": 1.5}]},
    {"classes": [{"name": "a"}, {"name": "a"}]},
    {"classes": [{"name": "a", "weight": 0}]}])
def test_invalid_configs_raise_as_in_jax(bad):
    for mod in (jslo, tslo):
        with pytest.raises(ValueError):
            mod.parse_slo_config(bad)
            mod.parse_slo_class_config(bad)


def test_burn_rates_and_alert_edges_match_jax_on_one_series():
    engines = _engines()
    series = _series()
    fired = {pkg: [] for pkg in engines}
    statuses = {pkg: [] for pkg in engines}
    i = 0
    for tick in np.arange(T0 + 1.0, T0 + 200.0, 1.0):
        while i < len(series) and series[i][0] <= tick:
            ts, lat, err, shed = series[i]
            for eng in engines.values():
                eng.record(latency_ms=lat, error=err, shed=shed, ts=ts)
            i += 1
        for pkg, eng in engines.items():
            fired[pkg].append(eng.evaluate(now=float(tick)))
            statuses[pkg].append(eng.status(now=float(tick)))
    assert fired["torch"] == fired["jax"]
    assert statuses["torch"] == statuses["jax"]
    # the series is built to fire and clear every objective
    names = {a["objective"] for alerts in fired["torch"] for a in alerts}
    assert names == {"latency", "tail", "errors", "sheds"}
    assert statuses["torch"][-1]["latency"]["alerting"] is False
    assert engines["torch"].total_alerts() == \
        engines["jax"].total_alerts() >= 4
    for name in ("latency", "errors"):
        assert ttel.gauge("zoo_slo_budget_remaining",
                          objective=name).value == \
            jtel.gauge("zoo_slo_budget_remaining", objective=name).value


def test_summary_snapshots_match_jax(tmp_path):
    rs = np.random.default_rng(1)
    summaries = {
        "jax": jsummary.InferenceSummary(str(tmp_path / "jax"), "app"),
        "torch": tsummary.InferenceSummary(str(tmp_path / "torch"), "app")}
    stages = ("decode", "compute", "write", "e2e")
    lat = rs.lognormal(np.log(5e-3), 0.7, size=(5000, len(stages)))
    for row in lat:
        for s in summaries.values():
            for stage, v in zip(stages, row):
                s.record_stage(stage, float(v),
                               batch_size=4 if stage == "compute" else None)
            s.record_batch(4, float(row[1]))
    for s in summaries.values():
        s.record_queue_depth("ready", 7)
        s.add_scalar("Custom", 3.5, step=99999)
        s.add_scalar("Custom", 4.5)
    snaps = {pkg: s.snapshot() for pkg, s in summaries.items()}
    assert snaps["torch"] == snaps["jax"]
    for stage in stages:
        assert summaries["torch"].stage_percentiles(stage, (50, 95, 99)) \
            == summaries["jax"].stage_percentiles(stage, (50, 95, 99))
        assert summaries["torch"].stage_count(stage) == 5000
    for s in summaries.values():
        s.close()
    logdir = {pkg: str(tmp_path / pkg / "app" / "inference")
              for pkg in summaries}
    from analytics_zoo_tpu.utils import tensorboard as jtb

    for tag in ("Throughput", "LatencyMs", "compute/Throughput",
                "Queue/ready", "Custom"):
        # (step, wall time, tag, value): all but the wall time
        got = [(r[0],) + tuple(r[2:])
               for r in ttb.read_scalars(logdir["torch"], tag)]
        want = [(r[0],) + tuple(r[2:])
                for r in jtb.read_scalars(logdir["jax"], tag)]
        assert got == want and got, tag


def test_summary_without_a_log_dir_keeps_statistics_only():
    s = tsummary.InferenceSummary()
    for ms in (1, 2, 3, 4):
        s.record_stage("decode", ms / 1e3, batch_size=2)
    s.record_queue_depth("ready", 5)
    snap = s.snapshot()
    assert snap["queues"]["ready"] == 5
    assert snap["stages"]["decode"]["count"] == 4
    assert snap["stages"]["decode"]["p99"] == pytest.approx(3.97)
    assert s.writer is None
    s.close()
    with tsummary.Timer(s, batch_size=3) as t:
        pass
    assert t.elapsed >= 0.0 and s.stage_count("predict") == 1
