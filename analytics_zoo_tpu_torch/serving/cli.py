"""Cluster Serving lifecycle CLI (ops tier).

Counterpart of ``analytics_zoo_tpu/serving/cli.py`` (``zoo-serving``),
copied, with every verb. What differs:

- ``start``, ``restart`` and ``fleet`` take ``--device`` (``cuda``
  unless the caller asks for ``cpu``); the JAX CLI honours
  ``JAX_PLATFORMS`` instead. ``start`` double-forks before anything
  touches CUDA: the device is set up in the daemon (``_serve``), and
  fleet workers are spawned with ``subprocess``;
- ``config.yaml`` is read by the port's YAML-subset reader
  (``utils/yaml_subset.py``), without PyYAML.

Parity: the reference's ``scripts/cluster-serving/cluster-serving-{init,
start,stop,restart,shutdown}`` — its scripts prepare a working
directory with ``config.yaml``, spark-submit the serving job, and manage a
``running`` flag file. The equivalent here: one Python CLI (the shell
wrappers in ``scripts/`` exec it) that writes a config template (``init``),
runs the serve loop as a daemonized process with a pidfile (``start``),
signals it (``stop``/``restart``), and cleans the working dir
(``shutdown``). No Spark, no Redis requirement — the transport comes from
``data.src`` in the config (``file:<dir>`` for multi-process on one host,
``host:port`` for redis, in-process for tests/embedding).

Usage::

    python -m analytics_zoo_tpu_torch.serving.cli init   [--dir DIR]
    python -m analytics_zoo_tpu_torch.serving.cli start  [--dir DIR]
                        [--foreground] [--warmup] [--device cuda|cpu]
    python -m analytics_zoo_tpu_torch.serving.cli fleet  [--dir DIR]
                        [--workers N] [--transport socket://H:P]
                        [--device cuda|cpu]
    python -m analytics_zoo_tpu_torch.serving.cli broker
                        [--transport socket://H:P] [--shards N]
    python -m analytics_zoo_tpu_torch.serving.cli status [--dir DIR]
                        [--watch SEC]
    python -m analytics_zoo_tpu_torch.serving.cli top    [--dir DIR]
                        [--interval SEC]
    python -m analytics_zoo_tpu_torch.serving.cli trace  TRACE_ID [--dir DIR]
    python -m analytics_zoo_tpu_torch.serving.cli stop   [--dir DIR]
    python -m analytics_zoo_tpu_torch.serving.cli restart [--dir DIR]
                        [--device cuda|cpu]
    python -m analytics_zoo_tpu_torch.serving.cli shutdown [--dir DIR]
    python -m analytics_zoo_tpu_torch.serving.cli generate [--dir DIR]
                                                   --prompt "7, 3"
                                                   [--max-new-tokens N]
                                                   [--stop-id ID]
                                                   [--deadline-ms MS]

Model-registry verbs (config has a ``registry:`` section —
docs/model-registry.md).  Against a *running* server they go through the
file-RPC control plane (load + AOT warmup happen in the server, off the
serve path); with no server running they edit the persisted manifest
offline, and the next ``start`` loads the result::

    ... deploy   --path DIR [--model NAME] [--weight W] [--no-activate]
    ... promote  --model NAME --version N
    ... undeploy --model NAME [--version N]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from ..utils import telemetry, yaml_subset

PIDFILE = "cluster-serving.pid"
LOGFILE = "cluster-serving.log"
CONFIG = "config.yaml"
STATSFILE = "stats.json"

CONFIG_TEMPLATE = """\
## Analytics-Zoo-TPU Cluster Serving configuration
## (schema parity: reference scripts/cluster-serving/config.yaml)

model:
  # directory of a saved zoo model (KerasNet.save_model output)
  path: /opt/work/model

data:
  # transport: "file:<dir>" | "socket://<host>:<port>" (network broker,
  # docs/serving-network.md) | "shard://<host>:<p1>,<host>:<p2>,..."
  # (HRW-sharded broker fabric, docs/serving-network.md#sharding) |
  # "<redis-host>:<port>" | empty in-process;
  # `--transport` on the CLI overrides this without editing the file
  src: file:/tmp/zoo-serving-stream
  # C, H, W of the decoded image tensor
  image_shape: 3, 224, 224

params:
  batch_size: 32
  top_n: 5
  stream_maxlen: 10000
  ## pipelined serving engine (docs/serving-pipeline.md):
  # pipelined: true          # false = single-thread baseline loop
  # decode_workers: 2        # threads decoding records alongside compute
  # queue_depth: 64          # bound on each inter-stage queue
  # bucket_sizes: 1,2,4,8,16,32   # padding buckets (default: powers of 2)
  # warmup: false            # pre-compile all buckets before serving
  ## serving fleet + deadline-aware admission (docs/serving-fleet.md):
  # workers: 2               # fleet size for `zoo-serving fleet`
  # health_interval: 1.0     # worker heartbeat period, seconds
  # health_timeout: 10.0     # stale heartbeat -> restart threshold
  # default_deadline_ms: 250 # deadline for records that carry none
  # admission_safety_ms: 2.0 # slop subtracted from every slack estimate
  # linger_ms: 0             # max wait to round batches up to a bucket
  ## backlog-driven autoscaling (docs/serving-network.md#autoscaling);
  ## active when min_workers < max_workers:
  # min_workers: 1           # floor the fleet shrinks to when idle
  # max_workers: 4           # ceiling the fleet grows to under burst
  # autoscale_target_ms: 250 # wait budget scaling defends (default:
  #                          # default_deadline_ms)
  # scale_up_fraction: 0.5   # grow when predicted wait > fraction*target
  # scale_down_idle_s: 3.0   # sustained-empty backlog before shrinking
  # autoscale_interval: 0.5  # supervisor decision period, seconds

## generative serving (docs/serving-generate.md): uncomment to serve a
## `generate` endpoint with KV-cache decode + continuous batching
# generate:
#   slots: 4                 # in-flight sequences (cache slots)
#   continuous: true         # false = static batching (bench baseline)
#   max_len: 1024            # largest prompt+generation a slab can hold
#   max_new_tokens: 32       # default token budget per request
#   stop_id: 0               # default stop token (omit for none)
#   stub_ms_per_step: 1.0    # deterministic stub engine (smoke/bench);
#                            # omit and inject a real engine via
#                            # ClusterServing.set_generate_engine
#   ## generative fast path (docs/serving-generate.md#fast-path)
#   prefill_chunk: 0          # >0: long prompts prefill in chunks of
#                             # this many tokens, interleaved with decode
#   kv_cache: f32             # int8 = Int8KVSlab storage (0.375x bytes;
#                             # applied by build_transformer_engine)
#   prefix_cache_mb: 0        # >0: shared-prefix KV cache budget (MiB)
#   speculative:              # draft-and-verify decode
#     k: 0                    # draft tokens per round (0 = off)
#     draft_ms_per_step: 0.1  # stub draft cost (device drafts are
#                             # injected via set_generate_engine)

## model registry (docs/model-registry.md): uncomment to serve many
## named, versioned models with hot-swap + canary rollout
# registry:
#   root: /tmp/zoo-serving-registry   # manifest + control-plane dir
#   default_model: default       # model routed when records carry none
#   canary_error_threshold: 0.5  # canary error rate that triggers rollback
#   canary_min_requests: 20      # observations before rollback can fire
#   drain_timeout: 10.0          # seconds to drain a retiring version

## SLO engine (docs/observability.md#slo): declarative objectives with
## multi-window error-budget burn-rate alerts, rendered by
## `zoo-serving top` and gated by the bench soak leg
# slo:
#   fast_window_s: 10            # detection window
#   slow_window_s: 60            # blip-immunity window
#   burn_threshold: 2.0          # alert when burn exceeds this in BOTH
#   objectives:
#     - name: latency
#       p99_ms: 250              # 99% of requests within 250ms
#     - name: sheds
#       shed_fraction: 0.05      # at most 5% of requests shed
#   ## multi-tenant SLO classes (docs/multi-tenancy.md): per-(model,
#   ## version) tenants with weighted-fair intake + priority sheds
#   classes:
#     - name: premium
#       model: resnet50          # omit for a catch-all class
#       weight: 3                # deficit-round-robin fair share
#       priority: 0              # lower number sheds LAST
#       objectives:
#         - name: latency
#           p99_ms: 250
#     - name: batch
#       model: embedder
#       weight: 1
#       priority: 1              # first to shed under pressure
#       shed_wait_ms: 150        # shed queued records past this wait
"""


def _paths(workdir: str):
    return (os.path.join(workdir, CONFIG), os.path.join(workdir, PIDFILE),
            os.path.join(workdir, LOGFILE))


def _read_pid(pidfile: str):
    try:
        with open(pidfile) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return None
    except PermissionError:
        pass
    return pid


def cmd_init(workdir: str) -> int:
    os.makedirs(workdir, exist_ok=True)
    cfg, _, _ = _paths(workdir)
    if os.path.exists(cfg):
        print(f"{cfg} already exists; not overwriting")
        return 1
    with open(cfg, "w") as f:
        f.write(CONFIG_TEMPLATE)
    print(f"wrote {cfg}; edit model.path/data.src then "
          f"`cluster-serving-start`")
    return 0


def _build_serving(cfg: str, workdir: str):
    """ClusterServing for plain configs; RoutedClusterServing (registry
    mode: ModelRegistry recovered from its manifest, default model
    deployed from model.path, control server polling) when the config
    has a ``registry:`` section.  Either way a periodic stats snapshot
    lands in <workdir>/stats.json for `zoo-serving status`."""
    from .cluster_serving import ClusterServing, ClusterServingHelper

    helper = ClusterServingHelper(config_path=cfg)
    if not helper.stats_path:
        helper.stats_path = os.path.join(workdir, STATSFILE)
    if not helper.request_log and (helper.telemetry or telemetry.enabled()):
        # committed per-request timings — `zoo-serving trace <id>` scans
        # every requests*.jsonl under the workdir for its waterfall
        helper.request_log = os.path.join(workdir, "requests.jsonl")
    if not helper.registry_root:
        return ClusterServing(helper=helper), None
    from .registry import ModelRegistry, RegistryControlServer
    from .router import RoutedClusterServing

    registry = ModelRegistry(
        root=helper.registry_root,
        default_model=helper.default_model,
        canary_error_threshold=helper.canary_error_threshold,
        canary_min_requests=helper.canary_min_requests)
    serving = RoutedClusterServing(registry, helper=helper)
    registry.recover(load=True, warmup=serving.registry_warmup())
    if helper.model_path and not registry.routed_versions():
        serving.deploy(path=helper.model_path)
    ctl = RegistryControlServer(registry, helper.registry_root,
                                serving=serving).start()
    return serving, ctl


def _serve(cfg: str, warmup: bool = False, workdir: str = ".",
           device: str = "cuda"):
    # the device is met here, in the serving process itself (the
    # daemon's grandchild): a CUDA context made before the fork could
    # not be used after it
    from ..common.nncontext import init_nncontext

    init_nncontext(device=device)
    serving, _ctl = _build_serving(cfg, workdir)
    if serving.helper.telemetry or telemetry.enabled():
        telemetry.configure(enabled=True,
                            trace_dir=serving.helper.trace_dir,
                            service="serving")
    if warmup or serving.helper.warmup:
        # pre-compile every padding-bucket signature before the loop
        # accepts traffic; per-bucket compile time goes to the log
        t0 = time.time()
        times = serving.warmup()
        for bucket in sorted(times):
            print(f"warmup: bucket {bucket} compiled in "
                  f"{times[bucket]:.3f}s", flush=True)
        print(f"warmup: {len(times)}/{len(serving.buckets)} buckets in "
              f"{time.time() - t0:.3f}s", flush=True)

    def _term(sig, _frm):
        telemetry.event("serving/drain", signal=sig)
        telemetry.dump_flight(f"zoo-serving draining on signal {sig}")
        serving._stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    serving.serve_forever()


def cmd_start(workdir: str, foreground: bool = False,
              warmup: bool = False, device: str = "cuda") -> int:
    cfg, pidfile, logfile = _paths(workdir)
    if not os.path.exists(cfg):
        print(f"no {cfg}; run `cluster-serving-init` first",
              file=sys.stderr)
        return 1
    if _read_pid(pidfile) is not None:
        print("Serving is already running!", file=sys.stderr)
        return 1
    if foreground:
        _serve(cfg, warmup=warmup, workdir=workdir, device=device)
        return 0
    # double-fork daemonization, pidfile written by the grandchild;
    # nothing before this point may initialise CUDA
    pid = os.fork()
    if pid > 0:
        # parent: wait for the pidfile so `start && stop` can't race
        for _ in range(100):
            if _read_pid(pidfile) is not None:
                print(f"cluster serving started (pid "
                      f"{_read_pid(pidfile)}), log: {logfile}")
                return 0
            time.sleep(0.1)
        print("serving process did not come up; check " + logfile,
              file=sys.stderr)
        return 1
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    with open(logfile, "ab", buffering=0) as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    try:
        _serve(cfg, warmup=warmup, workdir=workdir, device=device)
    finally:
        try:
            os.remove(pidfile)
        except OSError:
            pass
    os._exit(0)


class _BrokerSet:
    """Shutdown handle over the in-process shard brokers cmd_fleet
    started (mirrors the single-broker handle's interface)."""

    def __init__(self, brokers):
        self.brokers = brokers

    def shutdown(self):
        for b in self.brokers:
            b.shutdown()


def _maybe_local_broker(src):
    """When ``data.src`` is socket:// (or shard://) and its port(s) are
    free locally, start the broker(s) in this process (single-host
    convenience); a bound port means an external broker owns that
    address — use it."""
    src = src or ""
    from .socket_queue import StreamQueueBroker, parse_socket_spec

    if src.startswith("shard://"):
        from .shard_fabric import parse_shard_spec

        endpoints = parse_shard_spec(src)
        started = []
        for host, port in endpoints:
            bind = ("0.0.0.0" if host not in ("localhost", "127.0.0.1")
                    else host)
            try:
                started.append(
                    StreamQueueBroker(host=bind, port=port).start())
            except OSError:
                continue    # shard owned by an external broker
        if not started:
            return None
        print(f"broker: serving {len(started)}/{len(endpoints)} shard(s) "
              f"of {src} in-process", flush=True)
        return _BrokerSet(started)
    if not src.startswith("socket://"):
        return None
    host, port = parse_socket_spec(src)
    bind = "0.0.0.0" if host not in ("localhost", "127.0.0.1") else host
    try:
        broker = StreamQueueBroker(host=bind, port=port).start()
    except OSError:
        return None    # address in use: external broker
    print(f"broker: serving {src} in-process", flush=True)
    return broker


def cmd_broker(src: str, shards: int = None) -> int:
    """Run a standalone stream broker in the foreground
    (docs/serving-network.md) — the front door fleet workers and
    clients on other hosts connect to.  ``--shards N`` (or a shard://
    src) launches the whole fabric locally and prints the shard:// spec
    to point ``data.src`` at (docs/serving-network.md#sharding)."""
    from .socket_queue import StreamQueueBroker, parse_socket_spec

    src = src or "socket://0.0.0.0:6380"
    if src.startswith("shard://") or (shards or 0) > 1:
        from .shard_fabric import parse_shard_spec

        if src.startswith("shard://"):
            endpoints = parse_shard_spec(src)
        else:
            host, port = parse_socket_spec(src)
            endpoints = [(host, port + k if port else 0)
                         for k in range(int(shards))]
        brokers = [StreamQueueBroker(host=h, port=p)
                   for h, p in endpoints]
        spec = "shard://" + ",".join(f"{b.host}:{b.port}"
                                     for b in brokers)
        print(f"broker: fabric of {len(brokers)} shard(s) on {spec}\n"
              f"broker: point data.src (or ZOO_SERVING_TRANSPORT) at "
              f"that spec; Ctrl-C to stop", flush=True)
        handle = _BrokerSet(brokers)
        # server.shutdown() blocks until serve_forever acks — which can
        # never happen on the thread serve_forever runs on, so the
        # handler must hand off to a helper thread.
        signal.signal(signal.SIGTERM, lambda _s, _f: threading.Thread(
            target=handle.shutdown, daemon=True).start())
        for b in brokers[1:]:
            b.start()
        try:
            brokers[0].run_forever()
        except KeyboardInterrupt:
            pass
        finally:
            handle.shutdown()
        return 0
    host, port = parse_socket_spec(src)
    broker = StreamQueueBroker(host=host, port=port)
    print(f"broker: serving on {broker.address}; Ctrl-C to stop",
          flush=True)
    signal.signal(signal.SIGTERM, lambda _s, _f: threading.Thread(
        target=broker.shutdown, daemon=True).start())
    try:
        broker.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        broker.shutdown()
    return 0


def cmd_fleet(workdir: str, workers=None, device: str = "cuda") -> int:
    """Run a supervised multi-worker serving fleet in the foreground
    (docs/serving-fleet.md): N worker processes over the shared
    transport, heartbeat-watched, dead workers restarted — and, with
    min_workers < max_workers, autoscaled against the stream backlog
    (docs/serving-network.md#autoscaling)."""
    cfg, _, _ = _paths(workdir)
    if not os.path.exists(cfg):
        print(f"no {cfg}; run `cluster-serving-init` first",
              file=sys.stderr)
        return 1
    from .cluster_serving import ClusterServingHelper
    from .fleet import ServingFleet

    broker = _maybe_local_broker(ClusterServingHelper(config_path=cfg).src)
    fleet = ServingFleet(cfg, workdir, workers=workers,
                         device=device).start()
    band = (f" (autoscale {fleet.min_workers}..{fleet.max_workers})"
            if fleet.autoscaler else "")
    print(f"fleet: supervising {fleet.workers} worker(s){band}; "
          f"Ctrl-C to stop", flush=True)
    signal.signal(signal.SIGTERM, lambda _s, _f: fleet.stop())
    try:
        fleet.supervise()
    except KeyboardInterrupt:
        fleet.shutdown()
    finally:
        if broker is not None:
            broker.shutdown()
    return 0


def _load_config(workdir: str) -> dict:
    cfg, _, _ = _paths(workdir)
    try:
        with open(cfg) as f:
            return yaml_subset.safe_load(f) or {}
    except OSError:
        return {}


def _registry_root(workdir: str):
    return (_load_config(workdir).get("registry") or {}).get("root")


def _print_stage_percentiles(stats: dict):
    stages = stats.get("stages") or {}
    for name in sorted(stages):
        s = stages[name]
        print(f"  stage {name:10s} p50={s.get('p50', 0):8.2f}ms "
              f"p95={s.get('p95', 0):8.2f}ms "
              f"p99={s.get('p99', 0):8.2f}ms "
              f"(n={s.get('count', 0)})")


def _print_models(models: dict):
    for name in sorted(models):
        m = models[name]
        can = m.get("canary")
        canary = (f", canary v{can['version']} @ {can['weight']:.2f} "
                  f"({can['errors']}/{can['requests']} errors)"
                  if can else "")
        print(f"  model {name}: active=v{m.get('active')}{canary}")
        for v, vs in sorted((m.get("versions") or {}).items(),
                            key=lambda kv: int(kv[0])):
            print(f"    v{v}: {vs.get('state'):9s} "
                  f"requests={vs.get('requests', 0)} "
                  f"errors={vs.get('errors', 0)} "
                  f"inflight={vs.get('inflight', 0)}")


def _print_fleet(workdir: str) -> bool:
    """Per-worker rows from the fleet's health files (fleet mode only);
    returns True when any worker row was printed."""
    from .fleet import fleet_status

    rows = fleet_status(workdir)
    now = time.time()
    for r in rows:
        if r.get("crash_looped"):
            state = "CRASH-LOOP"
        elif not r["alive"] and r.get("backoff_until", 0) > now:
            state = f"backoff({r['backoff_until'] - now:.1f}s)"
        elif r["alive"]:
            state = "up"
        else:
            state = "DOWN"
        if r.get("stale"):
            # alive by signal-0 but the heartbeat/stats file stopped
            # refreshing: wedged, and the supervisor hasn't acted yet
            state = "STALE"
        age = (f"{r['health_age_s']:.1f}s"
               if r.get("health_age_s") is not None else "-")
        dump = (f" flight_dump={r['flight_dump']}"
                if r.get("flight_dump") else "")
        print(f"  worker {r['worker_id']}: pid={r['pid']} {state:4s} "
              f"health_age={age} "
              f"served={r['records_served']} shed={r['shed']} "
              f"restarts={r['restarts']}{dump}")
    return bool(rows)


def _print_fleet_metrics(workdir: str):
    """Merged per-worker telemetry counters/gauges (fleet totals) —
    present only when workers run with telemetry on."""
    from .fleet import fleet_metrics

    view = fleet_metrics(workdir)
    if not view["workers"]:
        return
    ages = ", ".join(f"w{w['worker_id']}={w['age_s']:.1f}s"
                     for w in view["workers"])
    print(f"  metrics snapshots: {ages}")
    for m in view["merged"]:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        lbl = f"{{{lbl}}}" if lbl else ""
        print(f"    {m['name']}{lbl} = {m['value']:g}")


def _effective_src(workdir: str):
    return os.environ.get("ZOO_SERVING_TRANSPORT") or \
        (_load_config(workdir).get("data") or {}).get("src")


def _print_transport(workdir: str):
    """Socket-transport row (docs/serving-network.md): one stats op
    against the broker — connections, claims outstanding, redeliveries,
    stream depth.  Non-socket transports print nothing; an unreachable
    broker prints that instead of hiding the outage.  A shard:// fabric
    prints one row per shard (health included), so a dead shard is
    visible at a glance."""
    src = _effective_src(workdir)
    if (src or "").startswith("shard://"):
        from .shard_fabric import ShardedStreamQueue, parse_shard_spec

        q = ShardedStreamQueue(parse_shard_spec(src), connect_timeout=2.0)
        try:
            st = q.stats()
        finally:
            q.close()
        print(f"  transport {src}: "
              f"healthy={st['healthy']}/{len(st['shards'])} "
              f"failovers={st['failovers']} reenqueued={st['reenqueued']}")
        for row in st["shards"]:
            if row["alive"]:
                print(f"    shard {row['address']}: health=up "
                      f"connections={row['connections']} "
                      f"stream_len={row['stream_len']} "
                      f"claims_outstanding={row['claims_outstanding']} "
                      f"redelivered={row['redelivered']} "
                      f"results_pending={row['results_pending']}")
            else:
                print(f"    shard {row['address']}: health=DOWN "
                      f"(failures={row['failures']})")
        return
    if not (src or "").startswith("socket://"):
        return
    from .socket_queue import SocketStreamQueue, parse_socket_spec

    host, port = parse_socket_spec(src)
    q = SocketStreamQueue(host, port, connect_timeout=2.0)
    try:
        st = q.stats()
    except (OSError, RuntimeError) as e:
        print(f"  transport {src}: UNREACHABLE ({e})")
        return
    finally:
        q.close()
    print(f"  transport {src}: connections={st['connections']} "
          f"consumers={st['consumers']} stream_len={st['stream_len']} "
          f"claims_outstanding={st['claims_outstanding']} "
          f"redelivered={st['redelivered']} "
          f"results_pending={st['results_pending']}")


def _print_autoscale(workdir: str):
    """Autoscale band + most recent scale events (health/autoscale.json,
    written by the supervising fleet)."""
    from .fleet import autoscale_path

    try:
        with open(autoscale_path(workdir)) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return
    events = state.get("events", [])
    print(f"  autoscale: active={state.get('active')} "
          f"band={state.get('min_workers')}..{state.get('max_workers')} "
          f"events={len(events)}")
    for e in events[-3:]:
        print(f"    {time.strftime('%H:%M:%S', time.localtime(e['ts']))} "
              f"{e['action']} -> {e['active']} ({e['reason']})")


def _slo_line(label: str, o: dict):
    mark = "ALERT" if o.get("alerting") else "ok"
    print(f"  slo {label:12s} [{o.get('kind')} <= {o.get('bound'):g}] "
          f"burn fast={o.get('burn_fast', 0):.2f} "
          f"slow={o.get('burn_slow', 0):.2f} "
          f"budget={o.get('budget_remaining', 0) * 100:.1f}% "
          f"alerts={o.get('alerts_fired', 0)} {mark}")


def _print_slo(stats: dict):
    """Per-objective burn-rate/budget lines (present when the config has
    an ``slo:`` section — utils/slo.py), plus per-tenant class burn
    rates and scheduler counters when ``classes:`` are declared
    (docs/multi-tenancy.md)."""
    slo = stats.get("slo") or {}
    for name in sorted(slo):
        _slo_line(name, slo[name])
    classes = stats.get("slo_classes") or {}
    for cname in sorted(classes):
        for oname in sorted(classes[cname]):
            _slo_line(f"{cname}/{oname}", classes[cname][oname])
    tenants = stats.get("tenants") or {}
    for tname in sorted(tenants):
        t = tenants[tname]
        bound = t.get("shed_wait_ms")
        print(f"  tenant {tname}: weight={t.get('weight'):g} "
              f"priority={t.get('priority')} "
              f"queued={t.get('queued')} drained={t.get('drained')} "
              f"shed_capacity={t.get('shed_capacity')}"
              + (f" shed_wait_ms={bound:g}" if bound is not None else ""))


def _read_stats_files(workdir: str):
    """Every live pipeline_stats() snapshot under the workdir:
    ``stats.json`` (single process) plus ``stats-worker-N.json`` (fleet)
    — (source_name, stats_dict) pairs, unreadable files skipped."""
    names = [STATSFILE]
    try:
        names += sorted(n for n in os.listdir(workdir)
                        if n.startswith("stats-worker-")
                        and n.endswith(".json"))
    except FileNotFoundError:
        pass
    out = []
    for name in names:
        try:
            with open(os.path.join(workdir, name)) as f:
                out.append((name, json.load(f)))
        except (OSError, ValueError):
            continue
    return out


def _render_status(workdir: str) -> int:
    """One status frame — the shared render path of ``status``,
    ``status --watch`` and ``top``."""
    _, pidfile, _ = _paths(workdir)
    pid = _read_pid(pidfile)
    if pid is not None:
        print(f"running (pid {pid})")
    fleet_rows = _print_fleet(workdir)
    if fleet_rows:
        _print_fleet_metrics(workdir)
    _print_transport(workdir)
    _print_autoscale(workdir)
    if pid is None and not fleet_rows:
        print("not running")
        return 3
    # pipeline stats: the serving process dumps pipeline_stats() to
    # stats.json every ~2s (atomic rename, safe to read concurrently)
    stats = None
    try:
        with open(os.path.join(workdir, STATSFILE)) as f:
            stats = json.load(f)
    except (OSError, ValueError):
        pass
    if stats:
        print(f"  records_in={stats.get('records_in', 0)} "
              f"results_out={stats.get('results_out', 0)} "
              f"dropped={stats.get('dropped', 0)} "
              f"dead_letters={stats.get('dead_letters', 0)} "
              f"batches={stats.get('batches', 0)}")
        _print_stage_percentiles(stats)
        _print_slo(stats)
        _print_fleet_generation(_read_stats_files(workdir))
        _print_routing_rows(workdir)
        if stats.get("models"):
            _print_models(stats["models"])
            return 0
    elif fleet_rows:
        frames = _read_stats_files(workdir)
        for name, st in frames:
            if name == STATSFILE:
                continue
            _print_slo(st)
        _print_fleet_generation(frames)
        _print_routing_rows(workdir)
    # registry mode but no stats dump yet: fall back to the manifest
    root = _registry_root(workdir)
    if root:
        from .registry import ModelRegistry

        reg = ModelRegistry(root=root).recover(load=False)
        _print_models(reg.stats()["models"])
    return 0


def cmd_status(workdir: str, watch: float = None) -> int:
    if watch is None:
        return _render_status(workdir)
    try:
        while True:
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(f"zoo-serving status  {time.strftime('%H:%M:%S')}  "
                  f"(refresh {watch:g}s, Ctrl-C to exit)")
            _render_status(workdir)
            sys.stdout.flush()
            time.sleep(watch)
    except KeyboardInterrupt:
        pass
    return 0


def _merged_generation(frames) -> Optional[dict]:
    """Fleet-merged generate section over every stats frame carrying
    one: counter sums, weighted prefix hit ratio (Σhits over Σlookups,
    not a mean of per-worker ratios), mean draft acceptance."""
    tot = {"frames": 0, "active": 0, "cap": 0, "queue": 0,
           "pending_steps": 0, "tokens": 0, "joins": 0, "shed": 0,
           "prefills": 0, "hits": 0, "lookups": 0, "bytes": 0,
           "accept_sum": 0.0, "accept_n": 0, "tps_sum": 0.0}
    for _name, st in frames:
        gen = st.get("generation")
        if not gen:
            continue
        tot["frames"] += 1
        tot["active"] += gen.get("active_slots", 0)
        tot["cap"] += gen.get("capacity", 0)
        tot["queue"] += gen.get("queue_depth", 0)
        tot["pending_steps"] += gen.get("pending_steps", 0)
        tot["tokens"] += gen.get("tokens", 0)
        tot["joins"] += gen.get("joins", 0)
        tot["shed"] += gen.get("shed", 0)
        eng = gen.get("engine") or {}
        target = eng.get("target") or {}
        tot["prefills"] += eng.get("prefill_calls",
                                   target.get("prefill_calls", 0)) or 0
        pc = eng.get("prefix_cache") or target.get("prefix_cache")
        if pc:
            tot["hits"] += pc.get("hits", 0)
            tot["lookups"] += pc.get("hits", 0) + pc.get("misses", 0)
            tot["bytes"] += pc.get("bytes", 0)
        if "acceptance_rate" in eng:
            tot["accept_sum"] += eng["acceptance_rate"]
            tot["tps_sum"] += eng.get("tokens_per_step", 1.0)
            tot["accept_n"] += 1
    return tot if tot["frames"] else None


def _print_fleet_generation(frames, tok_per_s: Optional[float] = None):
    """The fleet-level ``generate:`` line — one merged view instead of
    the old per-worker (in practice worker-0-only) lines."""
    m = _merged_generation(frames)
    if not m:
        return
    line = (f"  generate: workers={m['frames']} "
            f"active={m['active']}/{m['cap']}cap "
            f"queue={m['queue']} pending_steps={m['pending_steps']} "
            f"tokens={m['tokens']} joins={m['joins']} shed={m['shed']}")
    if tok_per_s is not None:
        line += f" tok/s={tok_per_s:.1f}"
    if m["prefills"]:
        line += f" prefills={m['prefills']}"
    if m["lookups"]:
        line += (f" prefix_hit={m['hits'] / m['lookups']:.0%}"
                 f"({m['hits']}/{m['lookups']})"
                 f" prefix_mb={m['bytes'] / (1 << 20):.1f}")
    if m["accept_n"]:
        line += (f" draft_accept={m['accept_sum'] / m['accept_n']:.0%}"
                 f" tok/step={m['tps_sum'] / m['accept_n']:.2f}")
    print(line)


def _print_routing_rows(workdir: str):
    """Per-worker routing rows from the heartbeat load reports
    (serving/routing.py): free slots, queued decode steps, routed
    arrivals and how many landed on a warm prefix."""
    from .routing import STALE_AFTER_S, load_reports

    reports = load_reports(workdir)
    now = time.time()
    for wid in sorted(reports):
        r = reports[wid]
        stale = " STALE" if r.age_s(now) > STALE_AFTER_S else ""
        print(f"    route worker-{wid}: free={r.free_slots} "
              f"queued_steps={r.queued_steps:.0f} "
              f"routed_in={r.routed_in} "
              f"affinity_hits={r.affinity_hits} "
              f"keys={len(r.prefix_keys)}{stale}")


def cmd_top(workdir: str, interval: float = 2.0,
            iterations: int = None) -> int:
    """Live fleet view (docs/observability.md#slo): qps (delta of
    results_out between refreshes), stage percentiles, per-objective SLO
    budget, per-worker health — refreshed every ``interval`` seconds.
    ``iterations`` bounds the loop (tests / one-shot snapshots)."""
    prev = {}
    prev_tok = {}
    done = 0
    try:
        while iterations is None or done < iterations:
            frames = _read_stats_files(workdir)
            now = time.time()
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(f"zoo-serving top  {time.strftime('%H:%M:%S')}  "
                  f"(refresh {interval:g}s, Ctrl-C to exit)")
            total_qps = 0.0
            tok_per_s = None
            for name, st in frames:
                out = st.get("results_out", 0)
                qps = None
                if name in prev:
                    p_out, p_t = prev[name]
                    if now > p_t:
                        qps = max(out - p_out, 0) / (now - p_t)
                        total_qps += qps
                prev[name] = (out, now)
                gen = st.get("generation")
                if gen:
                    toks = gen.get("tokens", 0)
                    if name in prev_tok:
                        p_toks, p_t = prev_tok[name]
                        if now > p_t:
                            tok_per_s = (tok_per_s or 0.0) + \
                                max(toks - p_toks, 0) / (now - p_t)
                    prev_tok[name] = (toks, now)
                e2e = (st.get("stages") or {}).get("e2e") or {}
                qps_s = f"{qps:7.1f}" if qps is not None else "      -"
                print(f"  {name:24s} qps={qps_s} served={out} "
                      f"shed={st.get('shed', 0)} "
                      f"p50={e2e.get('p50', 0):.1f}ms "
                      f"p99={e2e.get('p99', 0):.1f}ms")
                _print_slo(st)
            if len(frames) > 1:
                print(f"  fleet qps={total_qps:.1f}")
            _print_fleet_generation(frames, tok_per_s=tok_per_s)
            _print_routing_rows(workdir)
            _print_fleet(workdir)
            sys.stdout.flush()
            done += 1
            if iterations is None or done < iterations:
                time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0


def _request_log_rows(workdir: str):
    """Committed timing payloads from every request log under the
    workdir (``requests.jsonl`` single process, ``requests-worker-N.jsonl``
    fleet, plus their rotated ``.1`` generations) as (source, row)."""
    try:
        names = sorted(n for n in os.listdir(workdir)
                       if n.startswith("requests")
                       and (n.endswith(".jsonl") or n.endswith(".jsonl.1")))
    except FileNotFoundError:
        return
    for name in names:
        try:
            with open(os.path.join(workdir, name)) as f:
                for line in f:
                    try:
                        yield name, json.loads(line)
                    except ValueError:
                        continue
        except OSError:
            continue


def _print_waterfall(row: dict, src: str, width: int = 36):
    """One request's committed timing as an offset bar chart."""
    kind = row.get("kind", "predict")
    print(f"{row.get('trace_id', '?')}  {kind}  uri={row.get('uri')}  "
          f"[{src}]")
    if row.get("error"):
        print(f"  error: {row['error']}")
    if kind == "generate":
        ttft = row.get("ttft_ms")
        decode = row.get("decode_ms")
        stages = [("ttft", 0.0, ttft), ("decode", ttft or 0.0, decode)]
    else:
        transport = row.get("transport_in_ms")
        queue_ms = row.get("queue_ms")
        device = row.get("device_ms")
        server = row.get("server_ms")
        # the writer tail: everything of server_ms not accounted for by
        # queue wait + device time (host transfer already in device_ms)
        write = None
        if server is not None:
            write = max(server - (queue_ms or 0.0) - (device or 0.0), 0.0)
        off = 0.0
        stages = []
        for nm, v in (("transport", transport), ("queue", queue_ms),
                      ("device", device), ("write", write)):
            stages.append((nm, off, v))
            off += v or 0.0
    total = max((off + (v or 0.0)) for _, off, v in stages) or 1.0
    for nm, off, v in stages:
        if v is None:
            continue
        pad = " " * int(width * off / total)
        bar = "#" * max(int(width * v / total), 1)
        print(f"  {nm:10s} {v:9.3f}ms  {pad}{bar}")
    if row.get("server_ms") is not None:
        print(f"  {'server':10s} {row['server_ms']:9.3f}ms")
    if kind == "generate":
        n = row.get("n_tokens")
        tps = row.get("tokens_per_s")
        print(f"  tokens: {n} @ {tps:g} tok/s" if tps is not None
              else f"  tokens: {n}")
        toks = row.get("token_ms") or []
        if toks:
            shown = ", ".join(f"{t:.1f}" for t in toks[:16])
            more = f", … +{len(toks) - 16}" if len(toks) > 16 else ""
            print(f"  token boundaries (ms after join): [{shown}{more}]")


def cmd_trace(workdir: str, trace_id: str) -> int:
    """Render the per-request waterfall for one trace id from the
    committed request logs.  (The full cross-process span tree — every
    queue/decode/dispatch slice with flow arrows — comes from
    ``zoo-trace show <id> --dir <trace-dir>``.)"""
    if not trace_id:
        print("trace needs a trace id (clients print it at enqueue; "
              "`zoo-trace ls --dir <trace-dir>` lists them)",
              file=sys.stderr)
        return 1
    hits = [(src, row) for src, row in _request_log_rows(workdir)
            if row.get("trace_id") == trace_id]
    if not hits:
        print(f"trace id {trace_id!r} not found in any requests*.jsonl "
              f"under {workdir} (was the run telemetry-enabled?)",
              file=sys.stderr)
        return 1
    for src, row in hits:
        _print_waterfall(row, src)
    return 0


def _registry_op(workdir: str, op: str, **kw) -> int:
    """deploy/promote/undeploy/canary: through the control plane when
    the server runs (it loads + warms off the serve path), else offline
    against the manifest (next start picks it up)."""
    reg_cfg = _load_config(workdir).get("registry") or {}
    root = reg_cfg.get("root")
    if not root:
        print("config has no `registry:` section; registry verbs need "
              "one (see docs/model-registry.md)", file=sys.stderr)
        return 1
    _, pidfile, _ = _paths(workdir)
    from .registry import (ModelRegistry, RegistryError, control_request)

    if _read_pid(pidfile) is not None:
        try:
            resp = control_request(root, op, **kw)
        except TimeoutError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1
    reg = ModelRegistry(
        root=root,
        default_model=reg_cfg.get("default_model") or "default",
    ).recover(load=False)
    try:
        if op == "deploy":
            mv = reg.deploy(kw.get("model"), path=kw["path"], load=False,
                            activate=kw.get("activate", True) and
                            kw.get("canary_weight") is None,
                            quantize=bool(kw.get("quantize", False)),
                            calibration=kw.get("calibration"))
            if kw.get("canary_weight") is not None:
                reg.set_canary(mv.name, mv.version,
                               float(kw["canary_weight"]))
            print(f"registered {mv.key} [{mv.dtype}] (offline; loads on "
                  f"next start)")
        elif op == "promote":
            mv = reg.promote(kw["model"], int(kw["version"]), load=False)
            print(f"promoted {mv.key} (offline; loads on next start)")
        else:
            removed = reg.undeploy(
                kw["model"],
                int(kw["version"]) if kw.get("version") is not None
                else None)
            print(f"undeployed {kw['model']} versions {removed}")
    except (RegistryError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def cmd_generate(workdir: str, prompt: str, max_new_tokens=None,
                 stop_id=None, temperature=None, deadline_ms=None,
                 timeout: float = 30.0) -> int:
    """Submit one generate request against the running server's
    transport and print the token stream as JSON (the client-side smoke
    for docs/serving-generate.md)."""
    cfg = _load_config(workdir)
    src = (cfg.get("data") or {}).get("src")
    if not src:
        print("config has no data.src; `generate` needs a shared "
              "transport (file:<dir> or redis)", file=sys.stderr)
        return 1
    from .client import InputQueue, OutputQueue, ServingError

    try:
        tokens = [int(t) for t in prompt.replace(",", " ").split()]
    except ValueError:
        print(f"--prompt must be int token ids, got {prompt!r}",
              file=sys.stderr)
        return 1
    iq = InputQueue(address=src)
    oq = OutputQueue(backend=iq.db)
    uri = f"gen-{os.getpid()}-{time.time_ns()}"
    iq.enqueue_generate(uri, tokens, max_new_tokens=max_new_tokens,
                        stop_id=stop_id, temperature=temperature,
                        deadline_ms=deadline_ms)
    if iq.last_trace_id:
        print(f"trace_id: {iq.last_trace_id}", file=sys.stderr)
    got = oq.wait_all([uri], timeout=timeout)
    res = got.get(uri)
    if res is None:
        print(f"no result for {uri} within {timeout:.0f}s (is the "
              f"server running with a generate engine?)", file=sys.stderr)
        return 1
    if isinstance(res, ServingError):
        out = {"uri": uri, "error": res.message,
               "code": getattr(res, "code", None)}
        partial = getattr(res, "tokens", None)
        if partial is not None:
            out["tokens"] = [int(t) for t in partial]
        print(json.dumps(out), file=sys.stderr)
        return 1
    print(json.dumps({"uri": uri, "tokens": [int(t) for t in res],
                      "finish": res.finish, "timing": res.timing}))
    return 0


def cmd_stop(workdir: str, timeout: float = 10.0) -> int:
    _, pidfile, _ = _paths(workdir)
    pid = _read_pid(pidfile)
    if pid is None:
        print("not running")
        return 0
    # the daemon may exit between any probe and signal: an already-dead
    # target is a successful stop, not a crash
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    try:
        os.remove(pidfile)
    except OSError:
        pass
    print("stopped")
    return 0


def cmd_restart(workdir: str, device: str = "cuda") -> int:
    cmd_stop(workdir)
    return cmd_start(workdir, device=device)


def cmd_shutdown(workdir: str) -> int:
    rc = cmd_stop(workdir)
    _, _, logfile = _paths(workdir)
    for path in (logfile, os.path.join(workdir, STATSFILE)):
        try:
            os.remove(path)
        except OSError:
            pass
    print("shut down")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zoo-serving")
    ap.add_argument("command", choices=["init", "start", "fleet", "broker",
                                        "status", "stop", "restart",
                                        "shutdown", "deploy", "promote",
                                        "undeploy", "generate", "trace",
                                        "top"])
    ap.add_argument("trace_id", nargs="?", default=None,
                    help="trace: the request's trace id (clients print "
                         "it at enqueue)")
    ap.add_argument("--dir", default=".", help="serving working directory")
    ap.add_argument("--watch", default=None, type=float, metavar="SEC",
                    help="status: refresh every SEC seconds until Ctrl-C")
    ap.add_argument("--interval", default=2.0, type=float,
                    help="top: refresh period in seconds")
    ap.add_argument("--iterations", default=None, type=int,
                    help="top: stop after N refreshes (default: forever)")
    ap.add_argument("--workers", default=None, type=int,
                    help="fleet: worker process count (default: config "
                         "params.workers)")
    ap.add_argument("--transport", default=None, metavar="SRC",
                    help="override data.src for this invocation — e.g. "
                         "socket://host:port (the network broker, "
                         "docs/serving-network.md), shard://h:p1,h:p2 "
                         "(broker fabric), file:<dir>, or "
                         "host:port for redis; fleet workers inherit it")
    ap.add_argument("--shards", default=None, type=int,
                    help="broker: launch a local fabric of N shard "
                         "brokers and print its shard:// spec "
                         "(docs/serving-network.md#sharding)")
    ap.add_argument("--foreground", action="store_true",
                    help="start: run in the foreground (containers)")
    ap.add_argument("--device", default="cuda",
                    help="start/restart/fleet: torch device to serve on "
                         "(cuda, or cpu when asked for); without a CUDA "
                         "device a cuda server raises")
    ap.add_argument("--warmup", action="store_true",
                    help="start: pre-compile all padding buckets before "
                         "accepting traffic (logs compile time per bucket)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable telemetry and write Chrome-trace + "
                         "metrics.json files under this directory "
                         "(fleet workers inherit via the environment)")
    ap.add_argument("--model", default=None,
                    help="registry verbs: model name (deploy defaults to "
                         "the registry's default model)")
    ap.add_argument("--path", default=None,
                    help="deploy: saved model directory to load")
    ap.add_argument("--version", default=None, type=int,
                    help="promote/undeploy: version number")
    ap.add_argument("--weight", default=None, type=float,
                    help="deploy: canary weight in [0,1] — deploy as a "
                         "canary at this traffic fraction instead of "
                         "activating")
    ap.add_argument("--no-activate", action="store_true",
                    help="deploy: register + warm but do not route "
                         "traffic (promote later)")
    ap.add_argument("--quantize", action="store_true",
                    help="deploy: load the version as int8 (fused "
                         "requantization chains when calibration scales "
                         "are available) — typically combined with "
                         "--weight for a side-by-side int8 canary")
    ap.add_argument("--calibration", default=None,
                    help="deploy --quantize: exported calibration-scales "
                         "JSON (defaults to calibration.json inside the "
                         "model directory when present)")
    ap.add_argument("--prompt", default=None,
                    help="generate: prompt token ids (comma/space "
                         "separated ints)")
    ap.add_argument("--max-new-tokens", default=None, type=int,
                    help="generate: token budget (default: server config)")
    ap.add_argument("--stop-id", default=None, type=int,
                    help="generate: stop token id")
    ap.add_argument("--temperature", default=None, type=float,
                    help="generate: sampling temperature (0 = greedy)")
    ap.add_argument("--deadline-ms", default=None, type=float,
                    help="generate: end-to-end deadline; unmeetable "
                         "requests are shed with a typed rejection")
    ap.add_argument("--timeout", default=30.0, type=float,
                    help="generate: seconds to wait for the result")
    args = ap.parse_args(argv)
    workdir = os.path.abspath(args.dir)
    if args.transport:
        # ClusterServingHelper reads this ahead of data.src; exporting
        # it (rather than rewriting the yaml) lets daemonized starts
        # and fleet worker subprocesses inherit the override
        os.environ["ZOO_SERVING_TRANSPORT"] = args.transport
    if args.trace_dir:
        # exports ZOO_TPU_TELEMETRY / ZOO_TPU_TRACE_DIR so daemonized
        # starts and fleet worker subprocesses inherit the settings
        telemetry.configure(enabled=True, trace_dir=args.trace_dir,
                            service="serving")
    if args.command == "init":
        return cmd_init(workdir)
    if args.command == "start":
        return cmd_start(workdir, foreground=args.foreground,
                         warmup=args.warmup, device=args.device)
    if args.command == "fleet":
        return cmd_fleet(workdir, workers=args.workers, device=args.device)
    if args.command == "broker":
        return cmd_broker(args.transport or _effective_src(workdir),
                          shards=args.shards)
    if args.command == "status":
        return cmd_status(workdir, watch=args.watch)
    if args.command == "trace":
        return cmd_trace(workdir, args.trace_id)
    if args.command == "top":
        return cmd_top(workdir, interval=args.interval,
                       iterations=args.iterations)
    if args.command == "stop":
        return cmd_stop(workdir)
    if args.command == "restart":
        return cmd_restart(workdir, device=args.device)
    if args.command == "deploy":
        if not args.path:
            print("deploy needs --path <saved-model-dir>", file=sys.stderr)
            return 1
        return _registry_op(workdir, "deploy", model=args.model,
                            path=args.path, canary_weight=args.weight,
                            activate=not args.no_activate,
                            quantize=args.quantize,
                            calibration=args.calibration)
    if args.command == "promote":
        if not args.model or args.version is None:
            print("promote needs --model and --version", file=sys.stderr)
            return 1
        return _registry_op(workdir, "promote", model=args.model,
                            version=args.version)
    if args.command == "undeploy":
        if not args.model:
            print("undeploy needs --model", file=sys.stderr)
            return 1
        return _registry_op(workdir, "undeploy", model=args.model,
                            version=args.version)
    if args.command == "generate":
        if not args.prompt:
            print("generate needs --prompt <token ids>", file=sys.stderr)
            return 1
        return cmd_generate(workdir, args.prompt,
                            max_new_tokens=args.max_new_tokens,
                            stop_id=args.stop_id,
                            temperature=args.temperature,
                            deadline_ms=args.deadline_ms,
                            timeout=args.timeout)
    return cmd_shutdown(workdir)


if __name__ == "__main__":
    sys.exit(main())
