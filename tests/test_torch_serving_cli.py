"""The port's ``zoo-serving`` CLI against the JAX package's, on the CPU.

- The lifecycle of ``test_serving.py::test_serving_lifecycle_cli``
  through ``python -m analytics_zoo_tpu_torch.serving.cli`` with
  ``--device cpu``: ``init`` (a second refuses), ``status`` 3 while
  stopped, ``start`` (a second refuses), tensor records served over the
  file transport from the daemon, ``status`` 0, ``restart``, more
  records, ``stop``, ``shutdown``, no pidfile left. The daemon's rows
  are held to the port's direct predict on the same saved model (1e-5:
  the same float32 model, batched in other buckets).
- The offline registry verbs of ``test_model_registry.py``
  (``deploy``/``promote``/``undeploy`` on the manifest).
- ``generate`` against a served stub decode engine.
- (f) ``status`` (``_render_status``) and ``top`` print JAX's text, line
  for line, for one workdir of health, supervisor, autoscale, metrics
  and stats files (the clock pinned, so ages agree).
- The verbs and options of JAX's CLI, and ``--device``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from analytics_zoo_tpu.serving import cli as jcli
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.serving import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TOL = 1e-5


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


@pytest.fixture(autouse=True)
def _port_on_cpu():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _tiny_model(c=3, h=8, w=8, classes=5):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (Dense,
                                                                   Flatten)
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    m = Sequential()
    m.add(Flatten(input_shape=(c, h, w)))
    m.add(Dense(classes, activation="softmax"))
    m.compile("sgd", "sparse_categorical_crossentropy")
    return m


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZOO_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serving_lifecycle_cli(tmp_path):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (FileStreamQueue, InputQueue,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.serving.cli import CONFIG

    workdir = tmp_path / "serving"
    model_dir = tmp_path / "model"
    stream_dir = tmp_path / "stream"
    _tiny_model().save_model(str(model_dir))
    env = _env()
    env["ZOO_TPU_TRACE_DIR"] = str(tmp_path / "trace")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli",
             *args, "--dir", str(workdir)],
            capture_output=True, text=True, timeout=120, env=env, cwd=REPO)

    assert cli("init").returncode == 0
    assert cli("init").returncode == 1          # refuses to overwrite
    cfg = workdir / CONFIG
    assert cfg.exists()
    cfg.write_text(
        f"model:\n  path: {model_dir}\n"
        f"data:\n  src: file:{stream_dir}\n  image_shape: 3, 8, 8\n"
        f"params:\n  batch_size: 4\n  top_n: 2\n  warmup: true\n")

    assert cli("status").returncode == 3        # not running yet
    out = cli("start", "--device", "cpu")
    assert out.returncode == 0, out.stderr + out.stdout
    direct = InferenceModel().load(str(model_dir))
    rng = np.random.default_rng(0)
    backend = FileStreamQueue(str(stream_dir))
    in_q, out_q = InputQueue(backend=backend), OutputQueue(backend=backend)

    def serve(prefix, n):
        xs = rng.standard_normal((n, 3, 8, 8)).astype(np.float32)
        uris = [f"{prefix}-{i}" for i in range(n)]
        for uri, x in zip(uris, xs):
            in_q.enqueue(uri, input=x)
        got = out_q.wait_all(uris, timeout=90.0)
        assert sorted(got) == sorted(uris), sorted(got)
        want = np.asarray(direct.predict(xs))
        for uri, row in zip(uris, want):
            top = np.argsort(-row)[:2]
            res = got[uri]
            assert not isinstance(res, Exception), res
            pairs = [(int(k), float(p)) for k, p in res]
            assert [k for k, _ in pairs] == [int(k) for k in top], uri
            np.testing.assert_allclose([p for _, p in pairs], row[top],
                                       rtol=0, atol=ROW_TOL)

    try:
        st = cli("status")
        assert st.returncode == 0, st.stdout + st.stderr
        assert "running (pid" in st.stdout
        assert cli("start", "--device", "cpu").returncode == 1
        serve("a", 6)
        out = cli("restart", "--device", "cpu")
        assert out.returncode == 0, out.stderr + out.stdout
        serve("b", 5)
        log = (workdir / "cluster-serving.log").read_text()
        assert "warmup: 3/3 buckets" in log, log
    finally:
        assert cli("stop").returncode == 0
    assert cli("status").returncode == 3
    assert not (workdir / "cluster-serving.pid").exists()
    assert cli("shutdown").returncode == 0
    assert not (workdir / "cluster-serving.log").exists()


def test_cli_offline_registry_verbs(tmp_path, capsys):
    from analytics_zoo_tpu_torch.serving import ModelRegistry

    model_dir = tmp_path / "m"
    _tiny_model().save_model(str(model_dir))
    workdir = tmp_path / "work"
    workdir.mkdir()
    root = tmp_path / "reg"
    (workdir / "config.yaml").write_text(
        "model:\n  path: null\n"
        "data:\n  image_shape: 3, 8, 8\n"
        f"registry:\n  root: {root}\n  default_model: img\n")

    assert tcli.main(["deploy", "--dir", str(workdir),
                      "--path", str(model_dir)]) == 0
    assert tcli.main(["deploy", "--dir", str(workdir),
                      "--path", str(model_dir), "--no-activate"]) == 0
    assert tcli.main(["promote", "--dir", str(workdir), "--model", "img",
                      "--version", "2"]) == 0
    reg = ModelRegistry(root=str(root)).recover(load=False)
    assert reg._active["img"] == 2
    assert tcli.main(["undeploy", "--dir", str(workdir), "--model", "img",
                      "--version", "1"]) == 0
    reg = ModelRegistry(root=str(root)).recover(load=False)
    assert list(reg._models["img"]) == [2]
    assert tcli.main(["deploy", "--dir", str(workdir)]) == 1   # no --path
    assert tcli.main(["promote", "--dir", str(workdir)]) == 1
    capsys.readouterr()


def test_generate_verb_against_a_stub_engine(tmp_path, capsys):
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 ClusterServingHelper)

    stream = tmp_path / "stream"
    (tmp_path / "config.yaml").write_text(
        f"model:\n  stub_ms_per_batch: 1\n"
        f"data:\n  src: file:{stream}\n  image_shape: 3, 4, 4\n"
        f"params:\n  batch_size: 4\n"
        f"generate:\n  slots: 2\n  stub_ms_per_step: 1\n"
        f"  max_new_tokens: 5\n")
    serving = ClusterServing(helper=ClusterServingHelper(
        config_path=str(tmp_path / "config.yaml"))).start()
    try:
        rc = tcli.main(["generate", "--dir", str(tmp_path),
                        "--prompt", "7, 0", "--timeout", "30"])
        out = capsys.readouterr().out
        assert rc == 0, out
        res = json.loads(out.strip().splitlines()[-1])
        assert res["tokens"][0] == 8          # the stub's p[0] + 1
        assert len(res["tokens"]) == 5
        assert tcli.main(["generate", "--dir", str(tmp_path)]) == 1
    finally:
        serving.stop()


def _parser_actions(mod, monkeypatch):
    """The CLI's argparse actions (dest -> option strings, choices),
    caught where ``main`` parses its arguments."""
    import argparse

    class _Parsed(Exception):
        pass

    def grab(self, *_a, **_k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            mod.main([])
    return {a.dest: (tuple(a.option_strings), tuple(a.choices or ()))
            for a in e.value.args[0]._actions}


def test_cli_offers_every_jax_verb_and_option(monkeypatch):
    j = _parser_actions(jcli, monkeypatch)
    t = _parser_actions(tcli, monkeypatch)
    assert t["command"][1] == j["command"][1]
    assert {k: v for k, v in t.items() if k != "device"} == j
    assert t["device"][0] == ("--device",)


# ---------------------------------------------------------------------------
# (f) status and top render JAX's text
# ---------------------------------------------------------------------------

NOW = 1_800_000_000.0


def _status_workdir(wd, live_pid):
    os.makedirs(os.path.join(wd, "health"))

    def dump(name, obj):
        with open(os.path.join(wd, name), "w") as f:
            json.dump(obj, f)

    adm = {"est_record_ms": 2.5, "est_batch_ms": 9.0, "est_token_ms": 1.5,
           "est_chunk_ms": 4.0}
    dump("health/worker-0.json", {
        "worker_id": 0, "ts": NOW - 1.25, "pid": live_pid,
        "records_served": 120, "shed": 3, "restarts": 0,
        "admission": adm,
        "routing": {"free_slots": 2, "active_slots": 2, "queue_depth": 1,
                    "queued_steps": 37, "prefix_keys": ["abcdef012345"],
                    "routed_in": 9, "affinity_hits": 4}})
    dump("health/worker-1.json", {
        "worker_id": 1, "ts": NOW - 30.0, "pid": 999999999,
        "records_served": 7, "shed": 0,
        "flight_dump": "/tmp/flight-1.json"})
    dump("health/supervisor.json", {
        "1": {"restarts": 2, "backoff_until": NOW + 4.0,
              "crash_looped": False},
        "2": {"restarts": 11, "backoff_until": 0.0, "crash_looped": True}})
    dump("health/autoscale.json", {
        "min_workers": 1, "max_workers": 3, "active": 2, "events": [
            {"ts": NOW - 50, "action": "scale_up", "workers": [1],
             "active": 2, "backlog": 80, "predicted_wait_ms": 300.0,
             "reason": "predicted wait 300ms > 125ms"}]})
    dump("metrics-worker-0.json", {
        "ts": NOW - 2.0, "service": "serving-worker-0", "metrics": [
            {"name": "zoo_served_total", "type": "counter",
             "labels": {"model": "a"}, "value": 12.0},
            {"name": "zoo_queue_depth", "type": "gauge", "labels": {},
             "value": 3.0}]})
    stages = {"e2e": {"p50": 4.5, "p95": 9.25, "p99": 12.0, "count": 120},
              "device": {"p50": 2.0, "p95": 3.0, "p99": 3.5, "count": 30}}
    slo = {"latency": {"kind": "p99_ms", "bound": 250.0, "burn_fast": 0.5,
                       "burn_slow": 0.25, "budget_remaining": 0.9,
                       "alerting": False, "alerts_fired": 0}}
    gen = {"active_slots": 2, "capacity": 4, "queue_depth": 1,
           "pending_steps": 37, "tokens": 640, "joins": 20, "shed": 1,
           "engine": {"prefill_calls": 20,
                      "prefix_cache": {"hits": 6, "misses": 14,
                                       "bytes": 3 << 20}}}
    dump("stats-worker-0.json", {"results_out": 120, "shed": 3,
                                 "stages": stages, "slo": slo,
                                 "generation": gen})
    dump("stats-worker-1.json", {"results_out": 7, "shed": 0,
                                 "stages": stages})
    with open(os.path.join(wd, "config.yaml"), "w") as f:
        f.write(f"data:\n  src: file:{wd}/stream\n")


def _render(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("with_stats_json", [False, True])
def test_status_and_top_render_jax_text(tmp_path, monkeypatch,
                                        with_stats_json):
    wd = str(tmp_path)
    _status_workdir(wd, os.getpid())
    if with_stats_json:
        # the single-process frame (stats.json) takes the other branch
        with open(os.path.join(wd, "stats-worker-0.json")) as f:
            frame = json.load(f)
        frame.update(records_in=130, dropped=1, dead_letters=0, batches=30)
        with open(os.path.join(wd, "stats.json"), "w") as f:
            json.dump(frame, f)
    monkeypatch.delenv("ZOO_SERVING_TRANSPORT", raising=False)
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")
    j = _render(jcli._render_status, wd)
    t = _render(tcli._render_status, wd)
    assert t == j
    assert j[0] == 0
    for line in ("worker 0: pid=", "worker 1: pid=999999999 backoff(4.0s)",
                 "worker 2: pid=None CRASH-LOOP", "autoscale: active=2",
                 "zoo_served_total{model=a} = 12", "route worker-0:"):
        assert line in j[1], (line, j[1])
    jt = _render(jcli.cmd_top, wd, 2.0, 1)
    tt = _render(tcli.cmd_top, wd, 2.0, 1)
    assert tt == jt
    assert "generate: workers=" in jt[1] and "active=" in jt[1]


def test_status_not_running_returns_3_as_jax(tmp_path):
    assert _render(tcli.cmd_status, str(tmp_path)) == \
        _render(jcli.cmd_status, str(tmp_path)) == (3, "not running\n")


def test_start_without_config_and_device_passed_to_daemon(tmp_path,
                                                           monkeypatch):
    """``start`` refuses without a config; the foreground path hands
    ``--device`` to ``init_nncontext`` before it builds the server."""
    assert tcli.cmd_start(str(tmp_path)) == 1
    (tmp_path / "config.yaml").write_text(
        "model:\n  stub_ms_per_batch: 1\ndata:\n  image_shape: 3, 4, 4\n")
    seen = []
    from analytics_zoo_tpu_torch.common import nncontext

    def fake_init(device=None, **kw):
        seen.append(device)
        raise RuntimeError("stop here")

    monkeypatch.setattr(nncontext, "init_nncontext", fake_init)
    with pytest.raises(RuntimeError, match="stop here"):
        tcli.cmd_start(str(tmp_path), foreground=True, device="cuda")
    assert seen == ["cuda"]


def test_cuda_worker_without_a_card_raises(tmp_path, monkeypatch):
    """A fleet worker asked for ``cuda`` never serves on the CPU."""
    import torch

    from analytics_zoo_tpu_torch.serving import fleet_worker

    tnn.set_nncontext(None)
    (tmp_path / "config.yaml").write_text(
        "model:\n  stub_ms_per_batch: 1\ndata:\n  image_shape: 3, 4, 4\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_worker.main(["--config", str(tmp_path / "config.yaml"),
                           "--workdir", str(tmp_path), "--worker-id", "0"])
    assert not os.path.exists(os.path.join(str(tmp_path), "health",
                                           "worker-0.json"))
