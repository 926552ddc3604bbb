"""The port's sharded broker fabric and multi-tenant admission against
the JAX package's, on the CPU.

The cases of ``test_shard_fabric.py`` on the port: HRW placement
stability, enqueue failover with dedup, the chaos leg (SIGKILL a broker
process mid-burst, exactly-once results; slow, as in JAX),
deficit-round-robin fairness, priority-shed ordering, SLO-class config
parsing and binding, the fleet's backlog over ``shard://`` and the
per-shard status rows. The configs are written by ``yaml.safe_dump``
and read by the port's YAML-subset reader. Added: ``rendezvous_rank``
equals JAX's for 1,000 keys over several shard sets, and a port client
fabric over JAX brokers serves each record once. Every check is exact
but the echo model's mean (1e-4, as in JAX).
"""

import json
import os
import signal
import time
from collections import Counter

import pytest

from analytics_zoo_tpu.serving import shard_fabric as jsf
from analytics_zoo_tpu_torch.serving import (LocalShardFabric,
                                             ShardedStreamQueue,
                                             TenantScheduler,
                                             parse_shard_spec)
from analytics_zoo_tpu_torch.serving.admission import (AdmissionController,
                                                       DEFAULT_TENANT)
from analytics_zoo_tpu_torch.serving.shard_fabric import (rendezvous_rank,
                                                          spawn_broker_proc,
                                                          wait_broker_up)
from analytics_zoo_tpu_torch.utils.slo import (SloClass, match_slo_class,
                                               parse_slo_class_config)


def _rec(i):
    return {"uri": f"u-{i}", "data": b"x" * 8, "shape": [1]}


# ---------------------------------------------------------------- spec

def test_parse_shard_spec():
    assert parse_shard_spec("shard://h1:7001,h2:7002") == \
        [("h1", 7001), ("h2", 7002)]
    # a bare port inherits the previous entry's host
    assert parse_shard_spec("shard://10.0.0.1:7001,7002,7003") == \
        [("10.0.0.1", 7001), ("10.0.0.1", 7002), ("10.0.0.1", 7003)]
    with pytest.raises(ValueError):
        parse_shard_spec("shard://")
    with pytest.raises(ValueError):
        parse_shard_spec("shard://7001")   # bare port with no host yet


# ---------------------------------------------------------- placement

def test_hash_stability_and_spread():
    ids = [f"h:{7000 + i}" for i in range(4)]
    keys = [f"key-{i}" for i in range(200)]
    # deterministic across instances/processes (blake2b, not hash())
    assert [rendezvous_rank(k, ids) for k in keys] == \
        [rendezvous_rank(k, ids) for k in keys]
    # every shard owns a reasonable share of keys
    owners = Counter(rendezvous_rank(k, ids)[0] for k in keys)
    assert len(owners) == 4
    assert min(owners.values()) >= 200 / 4 / 4


def test_hash_minimal_movement_on_shard_loss():
    """HRW's defining property: removing one shard only moves the keys
    it owned — every other key keeps its placement."""
    ids = [f"h:{7000 + i}" for i in range(4)]
    keys = [f"key-{i}" for i in range(300)]
    before = {k: ids[rendezvous_rank(k, ids)[0]] for k in keys}
    survivors = ids[1:]
    after = {k: survivors[rendezvous_rank(k, survivors)[0]] for k in keys}
    for k in keys:
        if before[k] != ids[0]:
            assert after[k] == before[k], "unowned key moved"
        else:
            assert after[k] in survivors


# ---------------------------------------------------- failover + dedup

def test_enqueue_failover_and_health_probe_recovery():
    fab = LocalShardFabric(2).start()
    try:
        q = fab.queue(probe_interval_s=0.2)
        # kill shard 0 ungracefully from the client's point of view
        fab.brokers[0].shutdown()
        for i in range(30):
            q.enqueue(_rec(i))
        assert q.failovers > 0          # some keys had the dead winner
        got = []
        while len(got) < 30:
            items = q.read_batch(32, timeout=2.0)
            assert items, "read starved with one live shard"
            got.extend(rec["uri"] for _r, rec in items)
        assert sorted(got) == sorted(f"u-{i}" for i in range(30))
        st = q.stats()
        assert st["healthy"] == 1
        assert sum(1 for r in st["shards"] if not r["alive"]) == 1
    finally:
        fab.shutdown()


def test_reenqueue_missing_dedups_on_live_broker():
    """reenqueue_missing reuses the original token: a record whose
    original enqueue SURVIVED must not be double-inserted."""
    fab = LocalShardFabric(2).start()
    try:
        q = fab.queue()
        for i in range(10):
            q.enqueue(_rec(i))
        assert q.stream_len() == 10
        n = q.reenqueue_missing([f"u-{i}" for i in range(10)])
        assert n == 10                   # re-sent ...
        assert q.stream_len() == 10      # ... but deduped broker-side
        # popped results clear the pending ledger -> later re-drives noop
        items = q.read_batch(16, timeout=2.0)
        q.put_results({rec["uri"]: b"r" for _r, rec in items})
        got = q.all_results(pop=True)
        assert len(got) == 10
        assert q.reenqueue_missing(got.keys()) == 0
    finally:
        fab.shutdown()


@pytest.mark.slow
def test_chaos_sigkill_broker_exactly_once():
    """SIGKILL one of two real broker processes mid-burst: after
    re-driving unresolved uris through the fabric's pending ledger,
    every record has exactly one, correct, result."""
    import socket as socket_mod

    ports = []
    for _ in range(2):
        s = socket_mod.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    procs = [spawn_broker_proc(p, claim_timeout_s=5.0) for p in ports]
    try:
        for p in ports:
            wait_broker_up("127.0.0.1", p)
        q = ShardedStreamQueue([("127.0.0.1", p) for p in ports],
                               probe_interval_s=0.2)
        n = 40
        for i in range(n):
            q.enqueue(_rec(i))
        # serve half the stream, then kill one broker dead
        served = {}
        deadline = time.time() + 60.0
        while len(served) < n // 2:
            assert time.time() < deadline, f"served {len(served)} of {n}"
            for rid, rec in q.read_batch(8, timeout=2.0):
                served[rec["uri"]] = rec["uri"].encode()
            q.put_results(served)
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=10)
        # Recovery: the kill lost both unserved records AND unpopped
        # results on shard 0.  The client pattern is to treat POPPED
        # results as the only ground truth — keep serving what arrives
        # and re-drive (via the pending ledger) any uri whose result
        # has not been seen yet.
        results = {}
        deadline = time.time() + 30.0
        while len(results) < n and time.time() < deadline:
            batch = {rec["uri"]: rec["uri"].encode()
                     for _r, rec in q.read_batch(8, timeout=0.5)}
            if batch:
                q.put_results(batch)
            results.update(q.all_results(pop=True))
            if not batch:
                q.reenqueue_missing(
                    [f"u-{i}" for i in range(n)
                     if f"u-{i}" not in results])
        assert q.reenqueued > 0
        # exactly-once: one result per uri, each with the right value
        assert sorted(results) == sorted(f"u-{i}" for i in range(n))
        for uri, val in results.items():
            assert val == uri.encode()
        assert q.all_results(pop=True) == {}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


# ------------------------------------------------- weighted-fair intake

class _Cls:
    def __init__(self, name, weight=1.0, priority=0, shed_wait_ms=None,
                 model=None, version=None):
        self.name, self.weight, self.priority = name, weight, priority
        self.shed_wait_ms = shed_wait_ms
        self.model, self.version = model, version


def test_drr_weighted_fair_math():
    """Deficit round-robin: weight 3 vs 1 with both backlogged splits a
    drain of 8 exactly 6:2; an idle class's share flows to the other."""
    ts = TenantScheduler([_Cls("a", weight=3), _Cls("b", weight=1)])
    for i in range(8):
        ts.offer("a", ("a", i))
        ts.offer("b", ("b", i))
    first = ts.drain(8)
    assert Counter(x[0] for x in first) == {"a": 6, "b": 2}
    # fairness is work-conserving: drain the rest, nothing is lost
    rest = ts.drain(100)
    assert Counter(x[0] for x in first + rest) == {"a": 8, "b": 8}
    # items within a class keep FIFO order
    assert [x[1] for x in first + rest if x[0] == "b"] == list(range(8))
    st = ts.stats()
    assert st["a"]["drained"] == 8 and st["b"]["drained"] == 8


def test_drr_idle_class_share_flows():
    ts = TenantScheduler([_Cls("a", weight=3), _Cls("b", weight=1)])
    for i in range(4):
        ts.offer("b", ("b", i))
    assert len(ts.drain(4)) == 4       # "a" idle: "b" takes everything


def test_priority_shed_ordering():
    """Under predicted-wait pressure the least-important class (highest
    priority number) sheds first, oldest first; the important class is
    untouched until the low class is empty."""
    ctrl = AdmissionController()
    ctrl.observe_batch(1, 0.010)       # 10 ms/record, 10 ms/batch
    ts = TenantScheduler([_Cls("hi", priority=0, shed_wait_ms=400.0),
                          _Cls("lo", priority=1, shed_wait_ms=60.0)])
    for i in range(12):
        ts.offer("hi", ("hi", i))
        ts.offer("lo", ("lo", i))
    victims = ts.shed_under_pressure(ctrl, extra_backlog=0)
    # 24 queued * 10ms = 240ms predicted: violates lo's 60ms bound but
    # not hi's 400ms -> only lo sheds, oldest first, until wait <= 60ms
    assert victims, "no sheds under obvious pressure"
    assert {v[0] for v in victims} == {"lo"}
    assert [v[1][1] for v in victims] == list(range(len(victims)))
    # hi's backlog alone keeps predicted wait above lo's bound, so lo
    # drains completely — but hi (within its own 400ms bound) is spared
    assert len(victims) == 12
    assert ts.queued_total() == 12
    assert ts.stats()["lo"]["shed_capacity"] == 12
    assert ts.stats()["hi"]["shed_capacity"] == 0


def test_priority_shed_reaches_high_class_only_after_low_empty():
    ctrl = AdmissionController()
    ctrl.observe_batch(1, 0.050)       # 50 ms/record: extreme pressure
    ts = TenantScheduler([_Cls("hi", priority=0, shed_wait_ms=120.0),
                          _Cls("lo", priority=1, shed_wait_ms=120.0)])
    for i in range(10):
        ts.offer("hi", ("hi", i))
        ts.offer("lo", ("lo", i))
    order = [v[0] for v in ts.shed_under_pressure(ctrl)]
    assert order, "no sheds"
    # every lo shed strictly precedes any hi shed
    if "hi" in order:
        assert order.index("hi") >= order.count("lo")
        assert "lo" not in order[order.index("hi"):]


def test_classify_specificity_and_default():
    ts = TenantScheduler([
        _Cls("exact", model="m", version="2"),
        _Cls("model-only", model="m"),
        _Cls("catchall")])
    assert ts.classify("m", "2") == "exact"
    assert ts.classify("m", "1") == "model-only"
    assert ts.classify("other", None) == "catchall"
    ts2 = TenantScheduler([_Cls("bound", model="m")])
    assert ts2.classify("x", None) == DEFAULT_TENANT
    ts2.offer("nonexistent-class", ("x", 0))    # routes to _default
    assert ts2.queued_total() == 1


# ------------------------------------------------------ SLO class config

def test_parse_slo_class_config():
    cfg = {
        "fast_window_s": 5,
        "classes": [
            {"name": "premium", "model": "resnet50", "weight": 3,
             "priority": 0,
             "objectives": [{"name": "latency", "p99_ms": 250},
                            {"name": "sheds", "shed_fraction": 0.05}]},
            {"name": "batch", "model": "embedder", "version": 7,
             "priority": 2, "shed_wait_ms": 100},
        ]}
    classes = parse_slo_class_config(cfg)
    assert [c.name for c in classes] == ["premium", "batch"]
    prem, batch = classes
    assert prem.weight == 3 and prem.priority == 0
    # default shed bound = tightest latency objective
    assert prem.shed_wait_ms == 250
    assert prem.objectives[0].fast_window_s == 5   # section default
    assert batch.shed_wait_ms == 100 and batch.version == "7"
    assert match_slo_class(classes, "resnet50", None) is prem
    assert match_slo_class(classes, "embedder", "7") is batch
    assert match_slo_class(classes, "embedder", "8") is None
    with pytest.raises(ValueError):
        parse_slo_class_config({"classes": [{"name": "a"}, {"name": "a"}]})
    with pytest.raises(ValueError):
        SloClass(name="zero", weight=0)


# --------------------------------------------------------- fleet + CLI

def test_fleet_backlog_sums_across_shards(tmp_path):
    """The autoscaler's backlog poll must see the WHOLE fabric: with
    records spread over two shards, _queue_backlog() returns the sum
    (the pre-fix code returned None for shard:// and autoscaling flew
    blind)."""
    yaml = pytest.importorskip("yaml")
    from analytics_zoo_tpu_torch.serving.fleet import ServingFleet

    fab = LocalShardFabric(2).start()
    try:
        q = fab.queue()
        for i in range(12):
            q.enqueue(_rec(i))
        per_shard = [b.queue_len() if hasattr(b, "queue_len") else None
                     for b in fab.brokers]
        cfg = {"model": {"path": "", "stub_ms_per_batch": 1.0},
               "data": {"src": fab.spec, "image_shape": "3,4,4"},
               "params": {"batch_size": 4}}
        cfg_path = tmp_path / "config.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        fleet = ServingFleet(str(cfg_path), str(tmp_path), workers=1,
                             device="cpu")
        assert fleet._queue_backlog() == 12
        del per_shard
    finally:
        fab.shutdown()


def test_status_renders_per_shard_rows(capsys, tmp_path, monkeypatch):
    """`zoo-serving status` transport section: one row per shard with
    health, plus DOWN marking for a dead shard."""
    from analytics_zoo_tpu_torch.serving import cli

    fab = LocalShardFabric(2).start()
    try:
        q = fab.queue()
        for i in range(6):
            q.enqueue(_rec(i))
        monkeypatch.setenv("ZOO_SERVING_TRANSPORT", fab.spec)
        cli._print_transport(str(tmp_path))
        out = capsys.readouterr().out
        assert "healthy=2/2" in out
        assert out.count("shard socket://") == 2
        assert "health=up" in out and "stream_len=" in out
        fab.brokers[0].shutdown()
        time.sleep(0.05)
        cli._print_transport(str(tmp_path))
        out = capsys.readouterr().out
        assert "health=DOWN" in out
        assert "healthy=1/2" in out
    finally:
        fab.shutdown()


def test_status_renders_tenant_slo_classes(capsys):
    from analytics_zoo_tpu_torch.serving import cli

    stats = {
        "slo_classes": {"premium": {"latency": {
            "kind": "p99_ms", "bound": 250.0, "burn_fast": 0.1,
            "burn_slow": 0.05, "budget_remaining": 0.95,
            "alerting": False, "alerts_fired": 0}}},
        "tenants": {"premium": {
            "queued": 1, "offered": 10, "drained": 9, "shed_capacity": 0,
            "weight": 3.0, "priority": 0, "shed_wait_ms": 250.0}},
    }
    cli._print_slo(stats)
    out = capsys.readouterr().out
    assert "premium/latency" in out
    assert "tenant premium:" in out and "weight=3" in out


# -------------------------------------------------- end-to-end serving

def test_serving_pipeline_over_fabric_with_tenants(tmp_path):
    """Full path: ClusterServing reads from a 2-shard fabric, classifies
    per-model tenants, serves every record exactly once, and reports
    per-tenant scheduler + SLO-class state."""
    yaml = pytest.importorskip("yaml")
    np = pytest.importorskip("numpy")
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 ClusterServingHelper)

    cfg = {"model": {"path": "", "stub_ms_per_batch": 1.0},
           "data": {"src": None, "image_shape": "3,4,4"},
           "params": {"batch_size": 4, "stream_maxlen": 100000},
           "slo": {"classes": [
               {"name": "premium", "model": "m1", "weight": 3,
                "priority": 0,
                "objectives": [{"name": "latency", "p99_ms": 60000}]},
               {"name": "batch", "model": "m2", "weight": 1,
                "priority": 1, "shed_wait_ms": 60000}]}}
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    fab = LocalShardFabric(2).start()
    serving = None
    try:
        helper = ClusterServingHelper(config_path=str(cfg_path))
        helper.src = fab.spec
        serving = ClusterServing(helper=helper).start()
        q = fab.queue()
        n = 24
        for i in range(n):
            q.enqueue({
                "uri": f"r-{i}", "model": "m1" if i % 2 else "m2",
                "tensors": {"t": {
                    "data": np.full((3, 4, 4), float(i),
                                    np.float32).tobytes(),
                    "shape": [3, 4, 4]}},
                "enqueue_ts_ms": time.time() * 1e3})
        got, deadline = {}, time.time() + 30
        while len(got) < n and time.time() < deadline:
            got.update(q.all_results(pop=True))
            time.sleep(0.1)
        assert len(got) == n
        row = json.loads(got["r-7"])
        assert abs(row["value"][0] - 7.0) < 1e-4   # echo-mean correctness
        assert row["timing"]["tenant"] == "premium"
        st = serving.pipeline_stats()
        assert st["tenants"]["premium"]["drained"] == n // 2
        assert st["tenants"]["batch"]["drained"] == n // 2
        assert st["slo_classes"]["premium"]["latency"]["n_slow"] == n // 2
        assert st["queue"]["duplicates"] == 0
    finally:
        if serving is not None:
            serving.stop()
        fab.shutdown()


# ----------------------------------------------------- parity with JAX

SHARD_SETS = [["127.0.0.1:7001"],
              ["127.0.0.1:7001", "127.0.0.1:7002"],
              [f"h{i}:{6380 + i}" for i in range(3)],
              [f"10.0.0.{i}:7000" for i in range(7)],
              ["0", "1", "2", "3"]]


@pytest.mark.parametrize("ids", SHARD_SETS, ids=lambda s: f"{len(s)}")
def test_rendezvous_rank_equals_jax(ids):
    keys = [f"key-{i}" for i in range(500)] + \
        [f"gen-{i:06d}-é" for i in range(500)]
    assert [rendezvous_rank(k, ids) for k in keys] == \
        [jsf.rendezvous_rank(k, ids) for k in keys]


def test_port_fabric_over_jax_brokers_exactly_once():
    fab = jsf.LocalShardFabric(2).start()
    try:
        q = ShardedStreamQueue(fab.endpoints)
        for i in range(20):
            q.enqueue(_rec(i))
        assert q.stream_len() == 20
        owners = Counter(q.shard_for(f"u-{i}") for i in range(20))
        assert sorted(owners) == [0, 1]
        assert [b.stats()["enqueued"] for b in fab.brokers] == \
            [owners[0], owners[1]]
        got = []
        deadline = time.time() + 10.0
        while len(got) < 20 and time.time() < deadline:
            got += q.read_batch(8, timeout=0.5)
        assert sorted(rec["uri"] for _r, rec in got) == \
            sorted(f"u-{i}" for i in range(20))
        q.put_results({rec["uri"]: rec["uri"].encode() for _r, rec in got})
        res = q.all_results(pop=True)
        assert res == {f"u-{i}": f"u-{i}".encode() for i in range(20)}
        assert sum(b.stats()["acked"] for b in fab.brokers) == 20
        q.close()
    finally:
        fab.shutdown()
