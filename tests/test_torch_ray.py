"""The port's RayContext runtime (``analytics_zoo_tpu_torch.ray``): the
behaviours of ``tests/test_ray_automl.py`` held on the port with
``platform="cpu"`` (tasks, closures, errors, actors, the cross-host
channel, a worker host joining and dying), the pool without cloudpickle,
and the device each worker runs on.

Spawned workers import this module to unpickle the tasks defined here,
so it imports neither JAX nor the JAX package. Every wait on a child
process or socket is bounded (60 s at most) and fails the test when it
runs out.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ray import (RayContext, RemoteTaskError,
                                         get_ray_context)
from analytics_zoo_tpu_torch.ray import raycontext as rc

ROOT = Path(__file__).resolve().parents[1]
WAIT = 60


def _square(x):
    return x * x


def _boom():
    raise ValueError("kaboom")


def _seeded_product(seed, dev="cpu"):
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(seed))
    return (a.to(dev) @ a.to(dev)).cpu()


def _device_matmul(seed):
    """A task on the worker's context device: a seeded product, returned
    with the device it was computed on."""
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    dev = get_nncontext().device
    return _seeded_product(seed, dev), str(dev)


def _serializer_name():
    return rc._serializer().__name__


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value


class Boom:
    def __init__(self):
        raise ValueError("nope")


class PSShard:
    def __init__(self, dim):
        self.w = np.zeros(dim, np.float32)

    def push(self, grad):
        self.w -= 0.5 * np.asarray(grad, np.float32)
        return True

    def pull(self):
        return self.w


def _where(x):
    return x * x, os.environ.get("ZOO_TEST_HOST_TAG")


@pytest.fixture(scope="module")
def ray_ctx():
    ctx = RayContext(num_ray_nodes=2, ray_node_cpu_cores=1, platform="cpu")
    ctx.init()
    yield ctx
    ctx.stop()


def test_remote_tasks_round_trip(ray_ctx):
    sq = ray_ctx.remote(_square)
    refs = [sq.remote(i) for i in range(6)]
    assert ray_ctx.get(refs, timeout=WAIT) == [i * i for i in range(6)]
    assert get_ray_context() is ray_ctx


def test_remote_closure_and_numpy(ray_ctx):
    scale = 3.0
    ref = ray_ctx.remote(lambda a: (a * scale).sum()).remote(
        np.ones((4, 4), np.float32))
    assert ray_ctx.get(ref, timeout=WAIT) == pytest.approx(48.0)


def test_map_convenience(ray_ctx):
    assert ray_ctx.map(_square, [1, 2, 3], timeout=WAIT) == [1, 4, 9]


def test_remote_error_propagates(ray_ctx):
    ref = ray_ctx.remote(_boom).remote()
    with pytest.raises(RemoteTaskError, match="kaboom"):
        ray_ctx.get(ref, timeout=WAIT)
    # the pool survives a failing task
    assert ray_ctx.get(ray_ctx.remote(_square).remote(5), timeout=WAIT) == 25


def test_tasks_run_in_separate_processes_on_the_asked_device(ray_ctx):
    pids = set(ray_ctx.map(lambda _: __import__("os").getpid(),
                           range(8), timeout=WAIT))
    assert os.getpid() not in pids and len(pids) >= 1
    out, dev = ray_ctx.get(ray_ctx.remote(_device_matmul).remote(3),
                           timeout=WAIT)
    assert dev == "cpu"
    assert torch.equal(out, _seeded_product(3))


def test_remote_requires_dot_remote(ray_ctx):
    with pytest.raises(TypeError):
        ray_ctx.remote(_square)(2)


def test_stop_then_submit_raises():
    ctx = RayContext(num_ray_nodes=1, platform="cpu")
    ctx.init()
    ctx.stop()
    with pytest.raises(RuntimeError):
        ctx.remote(_square).remote(1)


def test_worker_platform_maps_to_a_device():
    """None (the default) is the card, as every entry point of the port;
    an unknown platform raises before any worker starts."""
    assert rc._worker_device(None) == "cuda"
    assert rc._worker_device("gpu") == "cuda"
    assert rc._worker_device("cpu") == "cpu"
    assert rc._worker_device("cuda:1") == "cuda:1"
    assert RayContext().platform is None
    with pytest.raises(ValueError, match="unknown worker platform"):
        RayContext(platform="tpu")


def test_a_default_pool_without_a_card_fails_loudly(monkeypatch):
    """Without a card the default workers cannot start: the first wait
    raises, no task hangs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with RayContext(num_ray_nodes=1) as ctx:
        with pytest.raises(RuntimeError, match="all workers died"):
            ctx.get(ctx.remote(_square).remote(2), timeout=WAIT)


def test_actor_stateful_and_kill():
    with RayContext(num_ray_nodes=1, ray_node_cpu_cores=1,
                    platform="cpu") as ctx:
        CounterActor = ctx.remote(Counter)
        c = CounterActor.remote(10)
        refs = [c.incr.remote() for _ in range(5)]
        assert ctx.get(refs, timeout=WAIT) == [11, 12, 13, 14, 15]
        assert ctx.get(c.get.remote(), timeout=WAIT) == 15
        c2 = CounterActor.remote()
        assert ctx.get(c2.get.remote(), timeout=WAIT) == 0
        ctx.kill(c2)
        with pytest.raises(RuntimeError):
            ctx.get(c2.get.remote(), timeout=WAIT)
        with pytest.raises(RemoteTaskError, match="nope"):
            ctx.remote(Boom).remote()


def test_pool_without_cloudpickle(tmp_path, monkeypatch):
    """With cloudpickle hidden in the driver and in the spawned workers,
    module-level functions and classes ship through the standard pickle,
    and a lambda or closure raises a TypeError that names cloudpickle."""
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    (shadow / "cloudpickle.py").write_text(
        "raise ImportError('cloudpickle hidden')\n")
    monkeypatch.syspath_prepend(str(shadow))
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    assert rc._serializer() is rc._StdPickle
    with RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                    platform="cpu") as ctx:
        assert ctx.get(ctx.remote(_serializer_name).remote(),
                       timeout=WAIT) == "_StdPickle"
        assert ctx.map(_square, [2, 3], timeout=WAIT) == [4, 9]
        out, _ = ctx.get(ctx.remote(_device_matmul).remote(1), timeout=WAIT)
        assert torch.equal(out, _seeded_product(1))
        c = ctx.remote(Counter).remote(1)
        assert ctx.get(c.incr.remote(2), timeout=WAIT) == 3
        scale = 2.0
        with pytest.raises(TypeError, match="cloudpickle"):
            ctx.remote(lambda a: a * scale).remote(1)
        # the pool still serves after the refused submit
        assert ctx.get(ctx.remote(_square).remote(7), timeout=WAIT) == 49


# ---------------------------------------------------------------------------
# the cross-host channel
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _join_host(ctx, port, env=None):
    joiner = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.ray.worker_host",
         "--connect", f"127.0.0.1:{port}", "--workers", "2",
         "--platform", "cpu", "--authkey", ctx.cluster_authkey.decode()],
        # the host unpickles this module's tasks by reference
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "tests"), str(ROOT)]), **(env or {})),
        cwd=str(ROOT))
    deadline = time.time() + WAIT
    while not ctx._cluster.hosts and time.time() < deadline:
        if joiner.poll() is not None:
            break
        time.sleep(0.2)
    assert ctx._cluster.hosts, "worker host never joined"
    return joiner


def _stop_host(joiner):
    if joiner.poll() is None:
        joiner.terminate()
        joiner.wait(timeout=WAIT)


def test_cross_host_tasks_and_sharded_actors():
    """A worker host joins over the socket channel: tasks run there, a
    sharded parameter server's actors place on the head and the host with
    sticky state, and the host's death resolves its actor's calls as lost
    while the head's actor keeps serving."""
    port = _free_port()
    with RayContext(num_ray_nodes=1, ray_node_cpu_cores=1, platform="cpu",
                    listen=("127.0.0.1", port)) as ctx:
        joiner = _join_host(ctx, port, {"ZOO_TEST_HOST_TAG": "remote-host"})
        try:
            results = ctx.get([ctx.remote(_where).remote(i)
                               for i in range(8)], timeout=WAIT)
            assert [r[0] for r in results] == [i * i for i in range(8)]
            assert "remote-host" in {r[1] for r in results}

            PS = ctx.remote(PSShard)
            shards = [PS.remote(4) for _ in range(2)]
            kinds = sorted(ctx._actors[h._actor_id][0] for h in shards)
            assert kinds == ["local", "remote"], kinds
            for i, h in enumerate(shards):
                for _ in range(2):
                    ctx.get(h.push.remote(np.full(4, float(i + 1))),
                            timeout=WAIT)
            w = [ctx.get(h.pull.remote(), timeout=WAIT) for h in shards]
            np.testing.assert_allclose(w[0], np.full(4, -1.0))
            np.testing.assert_allclose(w[1], np.full(4, -2.0))
            remote_h, local_h = sorted(
                shards, key=lambda h: ctx._actors[h._actor_id][0] != "remote")
            _stop_host(joiner)
            deadline = time.time() + WAIT
            while ctx._actors[remote_h._actor_id][0] != "lost" and \
                    time.time() < deadline:
                time.sleep(0.2)
            assert ctx._actors[remote_h._actor_id][0] == "lost"
            with pytest.raises(RemoteTaskError, match="lost"):
                ctx.get(remote_h.pull.remote(), timeout=WAIT)
            np.testing.assert_allclose(
                ctx.get(local_h.pull.remote(), timeout=WAIT),
                np.full(4, -1.0 if local_h is shards[0] else -2.0))
        finally:
            _stop_host(joiner)


def test_cluster_listener_survives_bad_connections():
    import queue as queue_mod
    from multiprocessing.connection import Client

    from analytics_zoo_tpu_torch.ray.cluster import (ClusterListener,
                                                     generate_authkey)

    key = generate_authkey()
    listener = ClusterListener(("127.0.0.1", 0), queue_mod.Queue(),
                               authkey=key)
    try:
        addr = listener.address
        socket.create_connection(addr, timeout=WAIT).close()
        time.sleep(0.3)
        assert listener._accept_thread.is_alive()
        try:
            Client(addr, authkey=b"wrong-key")
        except Exception:
            pass
        time.sleep(0.3)
        assert listener._accept_thread.is_alive()
        conn = Client(addr, authkey=key)
        conn.send(("register", 2))
        deadline = time.time() + 10
        while not listener.hosts and time.time() < deadline:
            time.sleep(0.1)
        assert listener.hosts and listener.hosts[0].num_workers == 2
        conn.close()
    finally:
        listener.close()


def test_cluster_wire_is_the_jax_packages():
    """The message tuples the head and a host exchange are JAX's: a JAX
    worker host's registration reads on the port's listener, and the
    authkey is 32 hex characters in both."""
    import queue as queue_mod
    from multiprocessing.connection import Client

    from analytics_zoo_tpu_torch.ray.cluster import (ClusterListener,
                                                     generate_authkey)

    key = generate_authkey()
    assert len(key) == 32 and int(key, 16) >= 0
    result_q = queue_mod.Queue()
    listener = ClusterListener(("127.0.0.1", 0), result_q, authkey=key)
    try:
        conn = Client(listener.address, authkey=key)
        conn.send(("register", 3))
        deadline = time.time() + 10
        while not listener.hosts and time.time() < deadline:
            time.sleep(0.1)
        (host,) = listener.hosts
        host.send_task("t1", b"fn", b"args")
        assert conn.poll(WAIT)
        assert conn.recv() == ("task", "t1", b"fn", b"args")
        conn.send(("result", "t1", True, b"payload"))
        assert result_q.get(timeout=WAIT) == ("t1", True, b"payload")
        assert host.in_flight == {}
        conn.close()
    finally:
        listener.close()
