"""The port's serving fleet, its supervisor and autoscaler, on the CPU.

- The cases of ``test_serving_fleet.py`` (admission math, linger
  budgets, health files and status rows, the supervisor seam, restart
  backoff and crash loops) and ``test_fleet_autoscale.py`` (the
  backlog policy and the fleet's grow and drain bookkeeping, with the
  fleet's spawn replaced) on the port's modules.
- The supervisor primitives of the launcher (``Respawner``,
  ``inject_pythonpath``), which the port's fleet reuses.
- One test with real processes, the counterpart of JAX's fleet smoke
  over the socket transport: the ``broker`` and ``fleet`` verbs of the
  port's CLI (two workers, an echo stub model, ``--device cpu``,
  ``min_workers`` = ``max_workers`` = 2 so no autoscaler can retire the
  victim), a SIGKILL of worker 1 once its heartbeat exists and results
  flow, the broker's redelivery, the restart, every uri answered once
  with its own value (1e-4, the echo stub's mean), and a typed shed of
  an unmeetable deadline.

The configs are read by the port's YAML-subset reader.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from analytics_zoo_tpu_torch.serving import BacklogAutoscaler, ServingFleet
from analytics_zoo_tpu_torch.serving.admission import (
    SHED_DEADLINE, AdaptiveBatcher, AdmissionController, now_ms)
from analytics_zoo_tpu_torch.serving.fleet import (
    autoscale_path, fleet_metrics, fleet_status, read_autoscale_trace,
    read_health, write_health)
from analytics_zoo_tpu_torch.utils.profiling import Ewma

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _trace_dir(tmp_path, monkeypatch):
    """Telemetry's output of this process and of the workers it starts
    (flight dumps on a fault path, traces) lands under ``tmp_path``, never
    in the checkout the tests run from."""
    from analytics_zoo_tpu_torch.utils import telemetry

    trace = str(tmp_path / "trace")
    monkeypatch.setenv("ZOO_TPU_TRACE_DIR", trace)
    monkeypatch.setattr(telemetry, "_TRACE_DIR", trace)
    return trace


# ---------------------------------------------------------------------------
# admission controller policy
# ---------------------------------------------------------------------------

def test_ewma_estimates():
    e = Ewma(alpha=0.5)
    assert e.value is None
    assert e.update(10.0) == pytest.approx(10.0)   # first sample seeds
    assert e.update(20.0) == pytest.approx(15.0)
    assert e.update(20.0) == pytest.approx(17.5)
    with pytest.raises(ValueError):
        Ewma(alpha=0.0)


def test_admission_admits_everything_without_estimates():
    """Before the first measured batch the controller has no data: only
    the safety margin applies, so generous deadlines always admit."""
    ctl = AdmissionController(safety_ms=2.0)
    ok, code = ctl.admit(slack_ms=None, backlog=1000)   # no deadline
    assert ok and code is None
    ok, code = ctl.admit(slack_ms=50.0, backlog=1000)
    assert ok and code is None
    # but a slack inside the safety margin is still shed
    ok, code = ctl.admit(slack_ms=1.0, backlog=0)
    assert not ok and code == SHED_DEADLINE
    assert ctl.stats()["shed_deadline"] == 1


def test_admission_sheds_on_backlog_estimate():
    ctl = AdmissionController(safety_ms=1.0)
    ctl.observe_batch(10, 0.050)          # 5 ms/record, 50 ms/batch
    assert ctl.record_ms == pytest.approx(5.0)
    assert ctl.batch_ms == pytest.approx(50.0)
    # wait estimate = backlog*record + batch
    assert ctl.estimate_wait_ms(10) == pytest.approx(100.0)
    ok, _ = ctl.admit(slack_ms=200.0, backlog=10)
    assert ok
    ok, code = ctl.admit(slack_ms=80.0, backlog=10)    # 101 > 80
    assert not ok and code == SHED_DEADLINE
    # deeper backlog sheds at slack a shallow backlog admits
    ok, _ = ctl.admit(slack_ms=80.0, backlog=2)        # 61 <= 80
    assert ok


def test_admission_expired_at_dispatch():
    ctl = AdmissionController(safety_ms=0.0)
    ctl.observe_batch(1, 0.010)           # 10 ms/batch
    t = now_ms()
    assert not ctl.expired(None, t)                  # no deadline
    assert not ctl.expired(t + 100.0, t)             # plenty of slack
    assert ctl.expired(t + 5.0, t)                   # can't finish in 5ms
    assert ctl.expired(t - 1.0, t)                   # already past
    assert ctl.stats()["shed_expired"] == 2


def test_adaptive_batcher_linger_budget():
    ctl = AdmissionController(safety_ms=1.0)
    ctl.observe_batch(4, 0.004)           # 4 ms/batch
    bat = AdaptiveBatcher([1, 2, 4, 8], ctl, linger_ms=10.0)
    assert bat.next_boundary(3) == 4
    t = now_ms()
    # off-boundary partial batch, no deadline: the full linger budget
    assert bat.linger_budget_s(3, None) == pytest.approx(0.010)
    # exactly on a bucket boundary: dispatch now, lingering only grows
    # the signature
    assert bat.linger_budget_s(4, None) == 0.0
    # at the largest bucket: nothing to round up to
    assert bat.linger_budget_s(8, None) == 0.0
    # deadline slack caps the budget: 9ms slack - 4ms batch - 1ms safety
    assert bat.linger_budget_s(3, t + 9.0, at_ms=t) == \
        pytest.approx(0.004)
    # exhausted slack: no linger at all
    assert bat.linger_budget_s(3, t + 2.0, at_ms=t) == 0.0
    # linger disabled (the default) always dispatches immediately
    off = AdaptiveBatcher([1, 2, 4, 8], ctl, linger_ms=0.0)
    assert off.linger_budget_s(3, None) == 0.0


# ---------------------------------------------------------------------------
# health files + status rows
# ---------------------------------------------------------------------------

def test_health_files_and_fleet_status(tmp_path):
    wd = str(tmp_path)
    write_health(wd, 0, {"pid": os.getpid(), "records_served": 42,
                         "shed": 3, "restarts": 1})
    write_health(wd, 1, {"pid": 999999999, "records_served": 7, "shed": 0})
    h = read_health(wd, 0)
    assert h["worker_id"] == 0 and h["records_served"] == 42
    rows = fleet_status(wd)
    assert [r["worker_id"] for r in rows] == [0, 1]
    me = rows[0]
    assert me["alive"] is True          # our own pid is signal-0 probeable
    assert me["records_served"] == 42 and me["shed"] == 3
    assert me["restarts"] == 1
    assert me["health_age_s"] < 5.0
    assert rows[1]["alive"] is False    # pid 999999999 does not exist
    assert fleet_status(str(tmp_path / "nope")) == []


def test_fleet_status_flags_stale_live_worker(tmp_path):
    wd = str(tmp_path)
    # live pid, fresh heartbeat: any positive age beats a 0.0 threshold
    write_health(wd, 0, {"pid": os.getpid(), "records_served": 1})
    time.sleep(0.05)
    rows = fleet_status(wd, stale_after_s=0.0)
    assert rows[0]["alive"] is True and rows[0]["stale"] is True
    # generous threshold: same worker is not stale
    assert fleet_status(wd, stale_after_s=60.0)[0]["stale"] is False
    # a dead worker is DOWN, not STALE — staleness is the wedged-but-
    # alive case only
    write_health(wd, 1, {"pid": 999999999})
    time.sleep(0.05)
    r1 = fleet_status(wd, stale_after_s=0.0)[1]
    assert r1["alive"] is False and r1["stale"] is False


def test_fleet_status_flags_stale_stats_file(tmp_path):
    wd = str(tmp_path)
    write_health(wd, 0, {"pid": os.getpid(), "records_served": 1})
    stats = os.path.join(wd, "stats-worker-0.json")
    with open(stats, "w") as f:
        json.dump({"records": 1}, f)
    old = time.time() - 120.0
    os.utime(stats, (old, old))
    row = fleet_status(wd)[0]  # default 10s threshold
    assert row["stats_age_s"] > 100.0
    assert row["alive"] is True and row["stale"] is True


def test_fleet_metrics_merges_counters_across_workers(tmp_path):
    wd = str(tmp_path)
    for wid, served in ((0, 5.0), (1, 7.0)):
        with open(os.path.join(wd, f"metrics-worker-{wid}.json"),
                  "w") as f:
            json.dump({"ts": time.time(),
                       "service": f"serving-worker-{wid}",
                       "metrics": [
                           {"name": "zoo_served_total", "type": "counter",
                            "labels": {}, "value": served},
                           {"name": "zoo_stage_lat_s", "type": "summary",
                            "labels": {}, "count": 3, "sum": 0.1,
                            "quantiles": {}}]}, f)
    view = fleet_metrics(wd)
    assert [w["worker_id"] for w in view["workers"]] == ["0", "1"]
    merged = {m["name"]: m["value"] for m in view["merged"]}
    # counters sum; summaries stay per-worker (not mergeable)
    assert merged == {"zoo_served_total": 12.0}
    assert fleet_metrics(str(tmp_path / "nope")) == \
        {"workers": [], "merged": []}


def test_status_cli_renders_stale_worker(tmp_path, capsys):
    from analytics_zoo_tpu_torch.serving.cli import cmd_status

    wd = str(tmp_path)
    write_health(wd, 0, {"pid": os.getpid(), "records_served": 5})
    stats = os.path.join(wd, "stats-worker-0.json")
    with open(stats, "w") as f:
        json.dump({"records": 5}, f)
    old = time.time() - 120.0
    os.utime(stats, (old, old))
    rc = cmd_status(wd)
    out = capsys.readouterr().out
    assert rc == 0
    assert "worker 0:" in out and "STALE" in out


def test_status_cli_renders_worker_rows(tmp_path, capsys):
    from analytics_zoo_tpu_torch.serving.cli import cmd_status

    wd = str(tmp_path)
    write_health(wd, 0, {"pid": os.getpid(), "records_served": 5,
                         "shed": 2, "restarts": 0})
    rc = cmd_status(wd)
    out = capsys.readouterr().out
    assert rc == 0
    assert "worker 0:" in out and "served=5" in out and "shed=2" in out


# ---------------------------------------------------------------------------
# supervisor seam
# ---------------------------------------------------------------------------

def test_spawn_supervised_tags_and_terminate():
    from analytics_zoo_tpu_torch.launcher.supervisor import (
        spawn_supervised, terminate_all)

    buf, lock = io.StringIO(), threading.Lock()
    sp = spawn_supervised(
        [sys.executable, "-c", "print('hello'); print('world')"],
        env=dict(os.environ), tag="t-0", stream=buf, lock=lock)
    assert sp.proc.wait(timeout=30) == 0
    sp.pump.join(timeout=10)
    assert buf.getvalue() == "[t-0] hello\n[t-0] world\n"
    # terminate_all: SIGTERM ends a sleeping child promptly
    sp2 = spawn_supervised(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        env=dict(os.environ), tag="t-1", stream=buf, lock=lock)
    t0 = time.time()
    terminate_all([sp2.proc], grace_s=5.0)
    assert sp2.proc.poll() is not None
    assert time.time() - t0 < 10.0


# ---------------------------------------------------------------------------
# restart caps, backoff, crash-loop state (docs/fault-tolerance.md)
# ---------------------------------------------------------------------------

_FLEET_CFG = """\
model:
  stub_ms_per_batch: 1

data:
  src: file:{d}
  image_shape: 3, 4, 4

params:
  workers: 1
"""


class _FakeProc:
    def __init__(self, rc):
        self.returncode = rc
        self.pid = 4242

    def poll(self):
        return self.returncode


class _FakeSP:
    def __init__(self, rc):
        self.proc = _FakeProc(rc)
        self.pump = None


def _mini_fleet(tmp_path, **kw):
    from analytics_zoo_tpu_torch.serving.fleet import ServingFleet

    cfg = tmp_path / "config.yaml"
    cfg.write_text(_FLEET_CFG.format(d=tmp_path / "stream"))
    fleet = ServingFleet(str(cfg), str(tmp_path), workers=1,
                         stream=io.StringIO(), **kw)
    spawns = []

    def fake_spawn(wid):
        # every (re)spawned worker dies instantly with rc=1
        spawns.append(wid)
        fleet._procs[wid] = _FakeSP(rc=1)
        fleet._spawned_at[wid] = time.time()

    fleet._spawn = fake_spawn
    return fleet, spawns


def test_fleet_restart_backoff_then_crash_loop(tmp_path):
    from analytics_zoo_tpu_torch.serving.fleet import read_supervisor_state

    fleet, spawns = _mini_fleet(tmp_path, max_restarts=2,
                                restart_backoff_s=0.05)
    fleet._spawn(0)
    # death #1: restart deferred behind the backoff, not immediate
    assert fleet.poll_once() == []
    assert fleet.restarts[0] == 1
    assert 0 in fleet.backoff_until and 0 not in fleet._procs
    time.sleep(0.06)
    # backoff elapsed: respawned (then it dies again -> backoff doubles)
    assert fleet.poll_once() == [0]
    assert fleet.restarts[0] == 2
    until = fleet.backoff_until[0]
    assert until - time.time() > 0.05   # 0.05 * 2^1
    time.sleep(max(0.0, until - time.time()) + 0.02)
    # third death exceeds max_restarts=2: crash loop, no more respawns
    assert fleet.poll_once() == [0]
    assert 0 in fleet.crash_looped
    assert fleet.poll_once() == []
    assert spawns == [0, 0, 0]
    # persisted for `zoo-serving status` (worker never wrote a heartbeat)
    state = read_supervisor_state(str(tmp_path))
    assert state["0"]["crash_looped"] is True
    assert state["0"]["restarts"] == 3
    rows = fleet_status(str(tmp_path))
    row = [r for r in rows if r["worker_id"] == 0][0]
    assert row["crash_looped"] is True and row["restarts"] == 3
    assert row["alive"] is False


def test_fleet_healthy_uptime_resets_counter(tmp_path):
    fleet, _ = _mini_fleet(tmp_path, max_restarts=2,
                           restart_backoff_s=0.01, healthy_reset_s=1.0)
    fleet._spawn(0)
    fleet.restarts[0] = 2
    fleet._spawned_at[0] = time.time() - 5.0   # healthy for 5s > 1s
    fleet.poll_once()
    assert fleet.restarts[0] == 1              # reset, then this death
    assert 0 not in fleet.crash_looped


def test_helper_restart_knobs(tmp_path):
    from analytics_zoo_tpu_torch.serving.cluster_serving import \
        ClusterServingHelper

    cfg = tmp_path / "config.yaml"
    cfg.write_text(_FLEET_CFG.format(d=tmp_path / "stream") +
                   "  max_restarts: 4\n  restart_backoff_s: 2.5\n")
    h = ClusterServingHelper(config_path=str(cfg))
    assert h.max_restarts == 4
    assert h.restart_backoff_s == 2.5
    cfg2 = tmp_path / "config2.yaml"
    cfg2.write_text(_FLEET_CFG.format(d=tmp_path / "stream"))
    h2 = ClusterServingHelper(config_path=str(cfg2))
    assert h2.max_restarts == 10
    assert h2.restart_backoff_s == 0.5


def test_status_cli_renders_backoff_and_crash_loop(tmp_path, capsys):
    from analytics_zoo_tpu_torch.serving.cli import cmd_status
    from analytics_zoo_tpu_torch.serving.fleet import supervisor_path
    from analytics_zoo_tpu_torch.utils import file_io

    wd = str(tmp_path)
    write_health(wd, 0, {"pid": 999999999, "records_served": 3, "shed": 0})
    file_io.write_bytes_atomic(supervisor_path(wd), json.dumps({
        "0": {"restarts": 2, "backoff_until": time.time() + 9.0,
              "crash_looped": False},
        "1": {"restarts": 5, "backoff_until": 0.0, "crash_looped": True},
    }).encode())
    rc = cmd_status(wd)
    out = capsys.readouterr().out
    assert rc == 0
    assert "worker 0:" in out and "backoff(" in out and "restarts=2" in out
    assert "worker 1:" in out and "CRASH-LOOP" in out and "restarts=5" in out


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_validates_band():
    with pytest.raises(ValueError):
        BacklogAutoscaler(0, 3)
    with pytest.raises(ValueError):
        BacklogAutoscaler(4, 3)
    BacklogAutoscaler(2, 2)  # degenerate band is fine


def test_predicted_wait_is_backlog_times_service_over_workers():
    a = BacklogAutoscaler(1, 4, target_ms=200.0)
    # 100 records * 2ms each / 2 workers + 10ms current batch
    assert a.predicted_wait_ms(100, 2.0, 10.0, 2) == pytest.approx(110.0)
    assert a.predicted_wait_ms(0, 2.0, 10.0, 2) == pytest.approx(10.0)


def test_scale_up_jumps_to_fit_backlog():
    a = BacklogAutoscaler(1, 8, target_ms=100.0, scale_up_fraction=0.5,
                          cooldown_s=0.0)
    # wait = 400*2/1 + 5 = 805ms >> 50ms threshold; need ~= ceil(800/45)
    desired, reason = a.desired(400, 2.0, 5.0, 1, now=100.0)
    assert desired == 8  # clamped to max
    assert "scale_up" in reason or "backlog" in reason


def test_scale_up_is_stepwise_without_estimates():
    # record_ms unknown (cold fleet): only batch_ms can cross the
    # threshold, and growth is a single +1 step, never a blind jump
    a = BacklogAutoscaler(1, 8, target_ms=100.0, scale_up_fraction=0.5,
                          cooldown_s=0.0)
    desired, reason = a.desired(500, 0.0, 80.0, 2, now=100.0)
    assert desired == 3
    assert reason is not None


def test_no_scale_up_below_threshold_or_at_max():
    a = BacklogAutoscaler(1, 4, target_ms=200.0, scale_up_fraction=0.5,
                          cooldown_s=0.0)
    assert a.desired(10, 1.0, 1.0, 2, now=0.0) == (2, None)  # 6ms wait
    # saturated: over threshold but already at max
    desired, reason = a.desired(1000, 2.0, 5.0, 4, now=1.0)
    assert (desired, reason) == (4, None)


def test_scale_down_needs_sustained_idle_and_floor():
    a = BacklogAutoscaler(1, 4, target_ms=100.0, idle_s=2.0,
                          cooldown_s=0.0)
    assert a.desired(0, 1.0, 1.0, 3, now=0.0) == (3, None)   # idle starts
    assert a.desired(0, 1.0, 1.0, 3, now=1.0) == (3, None)   # not yet
    desired, reason = a.desired(0, 1.0, 1.0, 3, now=2.5)
    assert desired == 2 and "idle" in reason
    # backlog resets the idle clock
    a2 = BacklogAutoscaler(1, 4, target_ms=100.0, idle_s=2.0,
                           cooldown_s=0.0)
    a2.desired(0, 1.0, 1.0, 3, now=0.0)
    a2.desired(5, 1.0, 1.0, 3, now=1.9)
    assert a2.desired(0, 1.0, 1.0, 3, now=2.5) == (3, None)
    # floor: min_workers never breached even when idle forever
    a3 = BacklogAutoscaler(2, 4, target_ms=100.0, idle_s=0.5,
                           cooldown_s=0.0)
    a3.desired(0, 1.0, 1.0, 2, now=0.0)
    assert a3.desired(0, 1.0, 1.0, 2, now=10.0) == (2, None)


def test_cooldown_separates_actions():
    a = BacklogAutoscaler(1, 8, target_ms=100.0, scale_up_fraction=0.5,
                          cooldown_s=5.0)
    # stepwise growth (no record estimate yet) under sustained pressure
    desired, reason = a.desired(500, 0.0, 80.0, 2, now=0.0)
    assert (desired, bool(reason)) == (3, True)
    # identical pressure 1s later: inside cooldown, hold
    assert a.desired(500, 0.0, 80.0, 3, now=1.0) == (3, None)
    d2, r2 = a.desired(500, 0.0, 80.0, 3, now=6.0)
    assert (d2, bool(r2)) == (4, True)


# ---------------------------------------------------------------------------
# fleet bookkeeping (spawn/terminate stubbed out)
# ---------------------------------------------------------------------------

_CFG = """\
model:
  stub_ms_per_batch: 1

data:
  src: file:{d}
  image_shape: 3, 4, 4

params:
  batch_size: 4
  workers: 2
  min_workers: 1
  max_workers: 4
  autoscale_target_ms: 100
  autoscale_interval: 0
  autoscale_cooldown_s: 0
  scale_down_idle_s: 0.5
"""


class _DrainProc:
    def __init__(self):
        self.terminated = False

    def poll(self):
        return 0 if self.terminated else None

    def terminate(self):
        self.terminated = True

    def send_signal(self, _sig):
        self.terminated = True

    def kill(self):
        self.terminated = True

    def wait(self, timeout=None):
        return 0


class _DrainSupervised:
    def __init__(self):
        self.proc = _DrainProc()


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    stream = tmp_path / "stream"
    stream.mkdir()
    cfg = tmp_path / "config.yaml"
    cfg.write_text(_CFG.format(d=stream))
    fl = ServingFleet(str(cfg), str(tmp_path))
    spawned = []

    def fake_spawn(wid):
        spawned.append(wid)
        fl._procs[wid] = _DrainSupervised()
        fl._spawned_at[wid] = time.time()
    monkeypatch.setattr(fl, "_spawn", fake_spawn)
    fl._spawned = spawned
    yield fl


def test_fleet_reads_autoscale_band_from_config(fleet):
    assert (fleet.min_workers, fleet.workers, fleet.max_workers) == (1, 2, 4)
    assert fleet.autoscaler is not None
    assert sorted(fleet._active) == [0, 1]


def test_fleet_scales_up_on_backlog_and_persists_trace(fleet, monkeypatch):
    monkeypatch.setattr(fleet, "_queue_backlog", lambda: 400)
    monkeypatch.setattr(fleet, "_ewma_estimates", lambda: (2.0, 5.0))
    assert fleet.autoscale_once(now=100.0)
    assert sorted(fleet._active) == [0, 1, 2, 3]
    assert sorted(fleet._spawned) == [2, 3]
    trace = read_autoscale_trace(fleet.workdir)
    assert [e["action"] for e in trace] == ["scale_up"]
    assert trace[0]["workers"] == [2, 3]
    assert trace[0]["backlog"] == 400
    assert trace[0]["predicted_wait_ms"] > 100
    with open(autoscale_path(fleet.workdir)) as f:
        state = json.load(f)
    assert state["active"] == 4
    assert (state["min_workers"], state["max_workers"]) == (1, 4)


def test_fleet_drains_before_kill_on_scale_down(fleet, monkeypatch):
    monkeypatch.setattr(fleet, "_queue_backlog", lambda: 0)
    monkeypatch.setattr(fleet, "_ewma_estimates", lambda: (1.0, 1.0))
    for wid in (0, 1):
        fleet._procs[wid] = _DrainSupervised()
        fleet._spawned_at[wid] = time.time()
    fleet.autoscale_once(now=0.0)           # idle clock starts
    assert fleet.autoscale_once(now=1.0)    # idle_s=0.5 elapsed
    # highest wid retires first, via SIGTERM -> draining, not removal
    assert sorted(fleet._active) == [0]
    assert 1 in fleet._draining
    assert fleet._procs[1].proc.terminated
    assert 1 in fleet._procs  # reaped later by poll_once, not here
    trace = read_autoscale_trace(fleet.workdir)
    assert trace[-1]["action"] == "scale_down"
    assert trace[-1]["workers"] == [1]


def test_fleet_skips_tick_when_backlog_unreadable(fleet, monkeypatch):
    monkeypatch.setattr(fleet, "_queue_backlog", lambda: None)
    assert not fleet.autoscale_once(now=100.0)
    assert sorted(fleet._active) == [0, 1]
    assert read_autoscale_trace(fleet.workdir) == []


def test_degenerate_band_disables_autoscaler(tmp_path):
    cfg = tmp_path / "config.yaml"
    stream = tmp_path / "stream"
    stream.mkdir()
    cfg.write_text(_CFG.format(d=stream).replace(
        "min_workers: 1", "min_workers: 2").replace(
        "max_workers: 4", "max_workers: 2"))
    fl = ServingFleet(str(cfg), str(tmp_path))
    assert fl.autoscaler is None
    assert not fl.autoscale_once(now=100.0)


def test_restart_skips_drained_worker(fleet, monkeypatch):
    monkeypatch.setattr(fleet, "_queue_backlog", lambda: 0)
    monkeypatch.setattr(fleet, "_ewma_estimates", lambda: (1.0, 1.0))
    for wid in (0, 1):
        fleet._procs[wid] = _DrainSupervised()
        fleet._spawned_at[wid] = time.time()
    fleet.autoscale_once(now=0.0)
    fleet.autoscale_once(now=1.0)
    assert 1 in fleet._draining
    # the draining worker has exited: poll_once must reap it silently
    # instead of restarting it
    fleet._procs[1].proc.terminated = True
    fleet.poll_once()
    assert 1 not in fleet._procs
    assert 1 not in fleet._draining
    assert fleet._spawned == []  # no respawn of the retired worker
    assert not os.path.exists(
        os.path.join(fleet.workdir, "health", "worker-1.json"))


# ---------------------------------------------------------------------------
# the launcher's supervisor primitives
# ---------------------------------------------------------------------------

def test_respawner_budget_per_child_and_total():
    from analytics_zoo_tpu_torch.launcher import Respawner

    r = Respawner(max_per_child=2, max_total=3)
    r.note_death("a")
    r.note_death("a")
    with pytest.raises(RuntimeError, match="died 3 times"):
        r.note_death("a", "rc=1")
    r2 = Respawner(max_per_child=5, max_total=2)
    r2.note_death("a")
    r2.note_death("b")
    with pytest.raises(RuntimeError, match="3 worker deaths"):
        r2.note_death("c")
    assert r2.total_respawns == 3


def test_inject_pythonpath_prepends_the_package_root_once():
    from analytics_zoo_tpu_torch.launcher import inject_pythonpath

    env = inject_pythonpath({"PYTHONPATH": os.pathsep.join([REPO, "/x"])})
    assert env["PYTHONPATH"].split(os.pathsep) == [REPO, "/x"]
    assert inject_pythonpath({})["PYTHONPATH"] == REPO


# ---------------------------------------------------------------------------
# a socket fleet through the CLI (processes)
# ---------------------------------------------------------------------------

_SOCKET_FLEET_CFG = """\
model:
  stub_ms_per_batch: 20

data:
  src: socket://127.0.0.1:{port}
  image_shape: 3, 4, 4

params:
  batch_size: 4
  top_n: 0
  workers: 2
  min_workers: 2
  max_workers: 2
  health_interval: 0.25
  health_timeout: 5
  restart_backoff_s: 0.1
"""


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(*args, workdir, timeout=60, env=None):
    return subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli", *args,
         "--dir", str(workdir)],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_socket_fleet_sigkill_redelivers_exactly_once(tmp_path):
    import signal

    import numpy as np

    from analytics_zoo_tpu_torch.serving import (InputQueue, OutputQueue,
                                                 ServingRejected,
                                                 SocketStreamQueue)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZOO_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ZOO_TPU_TRACE_DIR"] = str(tmp_path / "trace")
    port = _free_port()
    wd = tmp_path / "fleet"
    wd.mkdir()
    (wd / "config.yaml").write_text(_SOCKET_FLEET_CFG.format(port=port))
    spec = f"socket://127.0.0.1:{port}"
    procs = []

    def spawn(*args):
        p = subprocess.Popen(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli",
             *args, "--dir", str(wd)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    def logs():
        out = []
        for p in procs:
            if p.poll() is None:
                p.terminate()
            try:
                out.append(p.communicate(timeout=30)[0] or "")
            except subprocess.TimeoutExpired:
                p.kill()
                out.append(p.communicate(timeout=10)[0] or "")
        return "\n".join(out)

    try:
        spawn("broker", "--transport", spec)
        from analytics_zoo_tpu_torch.serving.shard_fabric import \
            wait_broker_up

        wait_broker_up("127.0.0.1", port, timeout=60.0)
        spawn("fleet", "--device", "cpu")
        deadline = time.time() + 90.0
        while time.time() < deadline and not all(
                read_health(str(wd), w) for w in (0, 1)):
            time.sleep(0.1)
        assert all(read_health(str(wd), w) for w in (0, 1)), logs()

        q = SocketStreamQueue("127.0.0.1", port)
        in_q, out_q = InputQueue(backend=q), OutputQueue(backend=q)
        n = 240
        uris = [f"u-{i}" for i in range(n)]
        for i, uri in enumerate(uris):
            in_q.enqueue(uri, input=np.full((3, 4, 4), i, np.float32))
        got = {}
        deadline = time.time() + 60.0
        while len(got) < 16 and time.time() < deadline:
            got.update(out_q.dequeue())
            time.sleep(0.02)
        assert len(got) >= 16, logs()
        # the victim exists (its heartbeat is on disk) and the band
        # (min = max = 2) cannot retire it before the kill
        victim = read_health(str(wd), 1)
        assert victim and victim["pid"], logs()
        os.kill(int(victim["pid"]), signal.SIGKILL)
        rest = out_q.wait_all([u for u in uris if u not in got],
                              timeout=120.0)
        got.update(rest)
        assert sorted(got) == sorted(uris), logs()
        for i, uri in enumerate(uris):
            v = got[uri]
            assert not isinstance(v, Exception), (uri, v)
            assert abs(float(np.asarray(v).ravel()[0]) - i) <= 1e-4, uri
        st = q.stats()
        assert st["redelivered"] > 0, st
        assert st["claims_outstanding"] == 0 and st["stream_len"] == 0, st
        assert st["results_pending"] == 0, st
        assert q.all_results() == {}   # nothing served twice lingers

        # the supervisor restarts the victim and status shows it
        deadline = time.time() + 60.0
        while time.time() < deadline:
            h = read_health(str(wd), 1)
            if h and h["pid"] != victim["pid"]:
                break
            time.sleep(0.1)
        assert h and h["pid"] != victim["pid"], logs()
        status = _cli("status", workdir=wd, env=env)
        assert status.returncode == 0, status.stdout + status.stderr
        assert "worker 1:" in status.stdout and "restarts=1" in \
            status.stdout, status.stdout
        assert f"transport {spec}:" in status.stdout, status.stdout

        # an unmeetable deadline comes back typed, not as a timeout
        in_q.enqueue("doomed", deadline_ms=1.0,
                     input=np.full((3, 4, 4), 1, np.float32))
        v = out_q.wait_all(["doomed"], timeout=30.0).get("doomed")
        assert isinstance(v, ServingRejected), v
        assert v.code in ("shed_deadline", "shed_expired")
        q.close()
    finally:
        out = logs()
    assert all(p.poll() is not None for p in procs), out
