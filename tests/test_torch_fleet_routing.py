"""The port's length- and cache-aware fleet routing against the JAX
package's, on the CPU.

- The cases of ``test_fleet_routing.py`` on the port's
  ``serving/routing.py``: cost scoring, affinity, the stale-report
  fallback, substream placement, sweep and original-rid re-drive, the
  load reports, and the autoscaler's decode-step weighting.
- ``GenerateRouter.decide`` makes JAX's decisions on the same seeded
  reports and prompts: worker, reason, affinity and estimated cost
  (exact: the same float arithmetic in the same order).
- One test with real processes, the counterpart of JAX's route smoke: a
  2-worker fleet over the file transport (stub decode engine, prefix
  cache, ``--device cpu``), affinity routing of a repeat prompt, a
  SIGKILL mid-burst, and each uri settled exactly once with its own
  token stream.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from analytics_zoo_tpu.serving import routing as jrouting
from analytics_zoo_tpu_torch.serving.admission import BacklogAutoscaler
from analytics_zoo_tpu_torch.serving.generation import (
    ContinuousBatchScheduler, GenRequest, PrefixCache, StubDecodeEngine,
    prompt_key)
from analytics_zoo_tpu_torch.serving.queue_backend import FileStreamQueue
from analytics_zoo_tpu_torch.serving.routing import (
    GenerateRouter, RoutedGenerateQueue, WorkerIntakeQueue, WorkerReport,
    gen_substream, load_reports, substream_backlog, sweep_substream)


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


def _report(wid, now, **kw):
    kw.setdefault("free_slots", 2)
    kw.setdefault("token_ms", 2.0)
    kw.setdefault("chunk_ms", 4.0)
    return WorkerReport(worker_id=wid, ts=now, **kw)


def _key12(prompt):
    return prompt_key(np.asarray(prompt, np.int64))[:12]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def test_cost_scoring_prefers_unloaded_worker():
    """With equal EWMAs the worker without a queued-step backlog wins;
    the loser's predicted queue wait dominates its score."""
    now = time.time()
    r = GenerateRouter()
    d = r.decide([1, 2], 16, {
        0: _report(0, now, queued_steps=500.0),
        1: _report(1, now, queued_steps=0.0)}, now=now)
    assert d is not None and d.worker_id == 1 and d.reason == "cost"
    assert d.est_cost_ms < 500 * 2.0


def test_affinity_wins_at_comparable_load():
    """A warm prefix both skips the prefill term and earns the bonus,
    so the cache-holding worker wins a near-tie — but NOT a worker
    drowning in queued steps (cost still rules)."""
    now = time.time()
    prompt = [7, 8, 9]
    warm = {"prefix_keys": (_key12(prompt),)}
    r = GenerateRouter(affinity_bonus_ms=50.0)
    d = r.decide(prompt, 16, {
        0: _report(0, now),
        1: _report(1, now, **warm)}, now=now)
    assert d.worker_id == 1 and d.reason == "affinity" and d.affinity
    # warm but overloaded loses to a cold idle worker
    d2 = r.decide(prompt, 16, {
        0: _report(0, now),
        1: _report(1, now, queued_steps=1000.0, free_slots=1, **warm)},
        now=now)
    assert d2.worker_id == 0 and not d2.affinity


def test_stale_reports_fall_back():
    """All-stale -> None (degrade to any-claim); partially stale ->
    only fresh workers are candidates."""
    now = time.time()
    r = GenerateRouter(stale_after_s=5.0)
    assert r.decide([1], 4, {0: _report(0, now - 60)}, now=now) is None
    assert r.counts["stale_fallback"] == 1
    d = r.decide([1], 4, {
        0: _report(0, now - 60, queued_steps=0.0),
        1: _report(1, now, queued_steps=900.0)}, now=now)
    assert d.worker_id == 1      # stale worker 0 never considered


def test_single_worker_degenerate():
    now = time.time()
    d = GenerateRouter().decide([3], 8, {0: _report(0, now)}, now=now)
    assert d is not None and d.worker_id == 0


def test_least_loaded_without_cost_observations():
    """Before any EWMA token cost exists, placement is least-loaded
    (queued steps first) instead of cost-modelled."""
    now = time.time()
    r = GenerateRouter()
    d = r.decide([1], 8, {
        0: _report(0, now, token_ms=0.0, chunk_ms=0.0,
                   queued_steps=50.0),
        1: _report(1, now, token_ms=0.0, chunk_ms=0.0,
                   queued_steps=0.0)}, now=now)
    assert d.worker_id == 1 and d.reason == "least_loaded"


def test_tie_break_is_deterministic_and_keyed():
    """Exact cost ties break on the rendezvous rank of the prompt key:
    the same prompt always lands on the same worker, and different
    prompts spread across the tie."""
    now = time.time()
    r = GenerateRouter()
    reports = {w: _report(w, now) for w in range(4)}
    first = [r.decide([42, 42], 8, reports, now=now).worker_id
             for _ in range(5)]
    assert len(set(first)) == 1
    spread = {r.decide([i], 8, reports, now=now).worker_id
              for i in range(32)}
    assert len(spread) > 1


# ---------------------------------------------------------------------------
# substreams: placement, intake order, redelivery
# ---------------------------------------------------------------------------

def _gen_rec(i, prompt=(1, 2), steps=4):
    return {"uri": f"u-{i}",
            "generate": {"prompt": list(prompt), "max_new_tokens": steps}}


def test_routed_enqueue_lands_on_substream(tmp_path):
    """A fresh report routes the record onto that worker's substream
    with `routed_to` stamped; no fresh report -> shared stream."""
    root = str(tmp_path)
    q = RoutedGenerateQueue(root, src=f"file:{root}")
    rid, decision = q.enqueue_routed(_gen_rec(0))
    assert decision is None and q.unrouted == 1   # no heartbeats yet
    now = time.time()
    q.reports = lambda: {1: _report(1, now)}
    rid, decision = q.enqueue_routed(_gen_rec(1))
    assert decision is not None and decision.worker_id == 1
    sub = FileStreamQueue(root, name=gen_substream(1))
    got = sub.read_batch(10, timeout=0.2)
    assert [rec["uri"] for _r, rec in got] == ["u-1"]
    assert got[0][1]["routed_to"] == 1
    assert substream_backlog(root) == 0


def test_worker_intake_drains_substream_first(tmp_path):
    """WorkerIntakeQueue serves its private substream ahead of the
    shared stream and in FIFO order, then tops up from shared."""
    root = str(tmp_path)
    shared = FileStreamQueue(root)
    shared.enqueue({"uri": "shared-0"})
    sub = FileStreamQueue(root, name=gen_substream(0))
    for i in range(3):
        sub.enqueue({"uri": f"routed-{i}"})
    intake = WorkerIntakeQueue(root, 0)
    got = [rec["uri"] for _r, rec in intake.read_batch(10, timeout=0.2)]
    assert got == ["routed-0", "routed-1", "routed-2", "shared-0"]
    # results flow through the shared per-root results map
    intake.put_results({"routed-0": b"ok"})
    assert shared.get_result("routed-0") == b"ok"
    assert intake.stream_len() == 0


def test_sweep_substream_moves_unclaimed_records(tmp_path):
    """Retiring/killing a worker sweeps its unclaimed substream records
    back to the shared stream exactly once, claimable by anyone."""
    root = str(tmp_path)
    now = time.time()
    q = RoutedGenerateQueue(root, src=f"file:{root}")
    q.reports = lambda: {0: _report(0, now)}
    for i in range(4):
        q.enqueue_routed(_gen_rec(i))
    assert q.routed == 4 and substream_backlog(root) == 4
    moved = sweep_substream(root, 0)
    assert moved == 4 and substream_backlog(root) == 0
    survivor = WorkerIntakeQueue(root, 1)
    got = [rec["uri"] for _r, rec in survivor.read_batch(10, timeout=0.2)]
    assert sorted(got) == [f"u-{i}" for i in range(4)]
    # idempotent: second sweep finds nothing
    assert sweep_substream(root, 0) == 0


def test_reenqueue_missing_dedups_on_original_rid(tmp_path):
    """The claimed-but-uncommitted window: a re-driven record reuses
    its original rid, so the consumer that DID serve it skips the
    duplicate via its delivery ledger, while a genuinely lost record
    is served by the survivor — exactly once either way."""
    root = str(tmp_path)
    now = time.time()
    q = RoutedGenerateQueue(root, src=f"file:{root}")
    q.reports = lambda: {0: _report(0, now)}
    q.enqueue_routed(_gen_rec(0))
    q.enqueue_routed(_gen_rec(1))
    intake = WorkerIntakeQueue(root, 0)
    got = intake.read_batch(10, timeout=0.2)
    assert len(got) == 2                    # both claimed...
    intake.put_results({"u-0": b"done"})    # ...dies before committing u-1
    assert q.get_result("u-0") == b"done"
    # supervisor re-drives what's still missing a result: u-0 was
    # popped from the pending ledger with its result, so only u-1
    # goes back out — under its ORIGINAL rid
    assert q.reenqueue_missing(["u-0", "u-1"]) == 1
    survivor = WorkerIntakeQueue(root, 1)
    uris = [rec["uri"] for _r, rec in survivor.read_batch(10, timeout=0.2)]
    assert uris == ["u-1"]                  # served exactly once
    # a redundant second re-drive reuses the same rid: the survivor's
    # delivery ledger recognizes and drops the duplicate
    assert q.reenqueue_missing(["u-1"]) == 1
    assert survivor.read_batch(10, timeout=0.2) == []
    assert survivor.consumer_stats().get("duplicates", 0) >= 1


def test_load_reports_roundtrip(tmp_path):
    """write_health -> load_reports carries the routing section and the
    admission EWMAs into a WorkerReport."""
    from analytics_zoo_tpu_torch.serving.fleet import write_health

    workdir = str(tmp_path)
    write_health(workdir, 0, {
        "pid": 1, "admission": {"est_token_ms": 2.5, "est_chunk_ms": 7.0},
        "routing": {"free_slots": 3, "queued_steps": 12,
                    "prefix_keys": ["abc123"], "routed_in": 5,
                    "affinity_hits": 4}})
    write_health(workdir, 1, {"pid": 2, "admission": {}})   # no routing
    reports = load_reports(workdir)
    assert set(reports) == {0}
    r = reports[0]
    assert r.free_slots == 3 and r.queued_steps == 12
    assert r.token_ms == 2.5 and r.chunk_ms == 7.0
    assert r.holds_prefix("abc123fffffff") and not r.holds_prefix("zzz")
    assert r.age_s() < 5


# ---------------------------------------------------------------------------
# scheduler + cache accessors feeding the reports
# ---------------------------------------------------------------------------

def test_prefix_cache_contains_and_digest_do_not_count():
    pc = PrefixCache()
    pc.insert(np.array([1, 2]), "a", 8)
    pc.insert(np.array([3, 4]), "b", 8)
    assert pc.contains(np.array([1, 2]))
    assert not pc.contains(np.array([9]))
    digest = pc.key_digest(limit=1, width=12)
    assert digest == [prompt_key(np.array([3, 4]))[:12]]   # newest first
    assert pc.stats()["hits"] == 0 and pc.stats()["misses"] == 0


def test_scheduler_pending_decode_steps_and_load_report():
    """Queued budgets count toward pending steps before the loop runs,
    drain to ~0 after, and the load report exposes slots + digest."""
    results = {}
    eng = StubDecodeEngine(ms_per_step=0.2, stop_id=0,
                           prefix_cache=PrefixCache())
    s = ContinuousBatchScheduler(
        eng, lambda uri, payload: results.__setitem__(uri, payload),
        max_slots=2)
    s.submit(GenRequest("a", np.array([10]), max_new_tokens=6))
    s.submit(GenRequest("b", np.array([11]), max_new_tokens=4))
    assert s.pending_decode_steps() == 10
    report = s.load_report()
    assert report["slots"] == 2 and report["queued_steps"] == 10
    assert "prefix_keys" in report
    s.start()
    s.stop(drain=True, timeout=30)
    assert set(results) == {"a", "b"}
    assert s.pending_decode_steps() == 0
    assert s.stats()["pending_steps"] == 0


# ---------------------------------------------------------------------------
# autoscaler decode-step weighting
# ---------------------------------------------------------------------------

def test_autoscaler_weighs_generate_backlog():
    """A pure-generate backlog (0 records) scales the fleet up once
    weighted by decode steps x token cost; the same signature with
    gen kwargs omitted is the old behavior (no scale-up)."""
    a = BacklogAutoscaler(1, 4, target_ms=100.0, cooldown_s=0.0)
    t = 1000.0
    assert a.predicted_wait_ms(0, 0.0, 0.0, 1) == 0.0
    assert a.predicted_wait_ms(0, 0.0, 2.0, 2,
                               gen_steps=300, token_ms=2.0) == 302.0
    desired, reason = a.desired(0, 0.0, 0.0, 1, t)
    assert reason is None                      # record-blind: idle
    desired, reason = a.desired(0, 0.0, 0.0, 1, t,
                                gen_steps=300, token_ms=2.0)
    assert desired > 1 and "decode steps" in reason
    # jump is sized by total work: 600ms of decode over 50ms slack
    assert desired == 4


def test_autoscaler_gen_steps_reset_idle_clock():
    a = BacklogAutoscaler(1, 2, target_ms=1e9, idle_s=5.0,
                          cooldown_s=0.0)
    t = 1000.0
    a.desired(0, 0.0, 0.0, 2, t)               # idle clock starts
    a.desired(0, 0.0, 0.0, 2, t + 4, gen_steps=10, token_ms=0.1)
    desired, reason = a.desired(0, 0.0, 0.0, 2, t + 6)
    assert reason is None and desired == 2     # gen traffic reset idle
    desired, reason = a.desired(0, 0.0, 0.0, 2, t + 12)
    assert desired == 1 and "idle" in reason


# ---------------------------------------------------------------------------
# decisions against JAX's router
# ---------------------------------------------------------------------------

def _seeded_reports(rng, now, n, mod):
    out = {}
    for w in range(n):
        keys = tuple(_key12([int(t) for t in rng.integers(0, 50, 3)])
                     for _ in range(int(rng.integers(0, 3))))
        out[w] = mod.WorkerReport(
            worker_id=w, ts=now - float(rng.choice([0.0, 1.0, 9.0])),
            free_slots=int(rng.integers(0, 5)),
            queue_depth=int(rng.integers(0, 4)),
            queued_steps=float(rng.integers(0, 400)),
            token_ms=float(rng.choice([0.0, 1.5, 2.0, 3.25])),
            chunk_ms=float(rng.choice([0.0, 4.0, 6.5])),
            prefix_keys=keys)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_router_decides_as_jax(seed):
    from analytics_zoo_tpu_torch.serving import routing as trouting

    rng = np.random.default_rng(seed)
    now = 1.7e9
    routers = {"jax": jrouting.GenerateRouter(),
               "torch": trouting.GenerateRouter()}
    for trial in range(50):
        n = int(rng.integers(1, 6))
        state = rng.bit_generator.state
        reports = {}
        for pkg, mod in (("jax", jrouting), ("torch", trouting)):
            rng.bit_generator.state = state
            reports[pkg] = _seeded_reports(rng, now, n, mod)
        prompt = [int(t) for t in rng.integers(0, 50, 3)]
        steps = int(rng.integers(0, 64))
        chunks = int(rng.integers(1, 4))
        got = {pkg: routers[pkg].decide(prompt, steps, reports[pkg],
                                        prefill_chunks=chunks, now=now)
               for pkg in routers}
        if got["jax"] is None:
            assert got["torch"] is None, trial
            continue
        assert (got["torch"].worker_id, got["torch"].reason,
                got["torch"].affinity, got["torch"].est_cost_ms) == \
            (got["jax"].worker_id, got["jax"].reason,
             got["jax"].affinity, got["jax"].est_cost_ms), trial
    assert routers["torch"].stats() == routers["jax"].stats()
    assert routers["torch"].stats()["decisions"] > 0


def test_prompt_key_equals_jax():
    from analytics_zoo_tpu.serving.generation import prompt_key as jkey

    for p in ([1, 2], [100, 0, 7, 7, 7, 7], list(range(300))):
        assert prompt_key(np.asarray(p, np.int64)) == \
            jkey(np.asarray(p, np.int64))


# ---------------------------------------------------------------------------
# a routed fleet (processes)
# ---------------------------------------------------------------------------

_ROUTE_CFG = """\
model:
  stub_ms_per_batch: 1.0

data:
  src: file:{stream_dir}
  image_shape: 3, 4, 4

params:
  batch_size: 4
  top_n: 0
  workers: 2
  health_interval: 0.25
  health_timeout: 3.0

generate:
  slots: 4
  stub_ms_per_step: 2.0
  max_new_tokens: 8
  prefix_cache_mb: 8
"""

WARM_PROMPT = [100, 0, 7, 7, 7, 7]


def _prompt_for(i, rng):
    """The route smoke's skewed 3:1 short/long mix with ~30% repeats of
    the warm prompt (second token 0 keeps the stub's stop off)."""
    if rng.random() < 0.30:
        return WARM_PROMPT, 8
    if rng.random() < 0.75:
        return [200 + i, 0], 4
    return [200 + i, 0, 1, 1, 1, 1], 32


def test_routed_fleet_affinity_and_sigkill_settle_exactly_once(tmp_path):
    import contextlib
    import io
    import json
    import random
    import signal
    import threading

    from analytics_zoo_tpu_torch.serving import cli
    from analytics_zoo_tpu_torch.serving.client import OutputQueue
    from analytics_zoo_tpu_torch.serving.fleet import (ServingFleet,
                                                       read_health)

    workdir = str(tmp_path)
    stream_dir = os.path.join(workdir, "stream")
    cfg = os.path.join(workdir, "config.yaml")
    with open(cfg, "w") as f:
        f.write(_ROUTE_CFG.format(stream_dir=stream_dir))
    cap = io.StringIO()
    fleet = ServingFleet(cfg, workdir, stream=cap, device="cpu")
    sup = threading.Thread(target=fleet.supervise, daemon=True)
    results = {}

    def drain(q):
        for uri, raw in q.db.all_results(pop=True).items():
            assert uri not in results, f"{uri} answered twice"
            results[uri] = json.loads(raw.decode())

    try:
        fleet.start()
        sup.start()
        assert fleet.wait_healthy(timeout=90.0), cap.getvalue()
        routed = RoutedGenerateQueue(workdir, src=f"file:{stream_dir}")
        out_q = OutputQueue(backend=FileStreamQueue(stream_dir))

        warm_key = prompt_key(np.asarray(WARM_PROMPT, np.int64))
        _rid, d0 = routed.enqueue_routed(
            {"uri": "warm-0",
             "generate": {"prompt": WARM_PROMPT, "max_new_tokens": 8}})
        assert d0 is not None, "no routing decision despite heartbeats"
        holder = None
        deadline = time.time() + 60.0
        while time.time() < deadline and holder is None:
            drain(out_q)
            for wid, rep in load_reports(workdir).items():
                if rep.holds_prefix(warm_key):
                    holder = wid
            time.sleep(0.2)
        assert holder is not None, cap.getvalue()
        _rid, d1 = routed.enqueue_routed(
            {"uri": "warm-1",
             "generate": {"prompt": WARM_PROMPT, "max_new_tokens": 8}})
        assert d1 is not None and d1.affinity and d1.worker_id == holder

        records = 20
        rng = random.Random(0)
        expected = {"warm-0": WARM_PROMPT[0] + 1,
                    "warm-1": WARM_PROMPT[0] + 1}
        victim = 0
        h0 = read_health(workdir, victim)
        assert h0, "no heartbeat for the victim"
        for i in range(records):
            prompt, steps = _prompt_for(i, rng)
            uri = f"mix-{i}"
            expected[uri] = prompt[0] + 1      # stub: token 1 = p[0] + 1
            routed.enqueue_routed(
                {"uri": uri, "generate": {"prompt": list(prompt),
                                          "max_new_tokens": steps}})
            if i == records // 2:
                os.kill(int(h0["pid"]), signal.SIGKILL)
        deadline = time.time() + 120.0
        while len(results) < len(expected) and time.time() < deadline:
            drain(out_q)
            missing = [u for u in expected if u not in results]
            if missing:
                routed.sweep_worker(victim)
                routed.reenqueue_missing(missing)
                time.sleep(0.3)
        assert sorted(results) == sorted(expected), cap.getvalue()
        for uri, want in expected.items():
            toks = results[uri].get("tokens")
            assert "error" not in results[uri] and toks, results[uri]
            assert int(toks[0]) == want, (uri, toks)
        time.sleep(1.0)           # late duplicates would land now
        assert out_q.db.all_results(pop=True) == {}
        assert fleet.restarts.get(victim, 0) >= 1
        rstats = routed.stats()
        assert rstats["router"]["affinity"] >= 1
        assert rstats["routed"] >= records // 2

        scap = io.StringIO()
        with contextlib.redirect_stdout(scap):
            cli._print_fleet_generation(cli._read_stats_files(workdir))
            cli._print_routing_rows(workdir)
        assert "route worker-" in scap.getvalue()
    finally:
        fleet.stop()
        sup.join(timeout=30.0)
        fleet.shutdown()
    assert not sup.is_alive()
