"""The port's RayContext, cluster and worker host held against the JAX
package's (``analytics_zoo_tpu.ray``), both pools with ``platform="cpu"``:
the same tasks, errors and actor calls through either give the same
results and error lines, and a worker host of either package serves the
other package's head over the socket channel (tasks, remote errors, a
sharded parameter server's actors, the host's death).

Spawned workers import this module to unpickle the tasks defined here, so
it imports the JAX package only inside test functions (its ``ray``
package imports no JAX; its workers import JAX on the CPU). Every wait on
a child process or socket is bounded (60 s) and fails the test when it
runs out.
"""

import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch.ray as port_ray

ROOT = Path(__file__).resolve().parents[1]
WAIT = 60


def _square(x):
    return x * x


def _boom():
    raise ValueError("kaboom")


def _seeded_product(seed):
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(seed))
    return a @ a


def _where(x):
    return x * x, os.environ.get("ZOO_TEST_HOST_TAG")


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
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


def _jax_ray():
    import analytics_zoo_tpu.ray as jax_ray
    return jax_ray


def _first_line(err):
    """An error's first line with actor ids masked: the remote exception's
    ``Type: message`` (the traceback below it names each package's
    files)."""
    return re.sub(r"\b[0-9a-f]{8}\b", "<id>", str(err).splitlines()[0])


def _script(ctx, pkg):
    """One pass of tasks, a closure, a torch result, a task error, actor
    calls, a killed actor and a failing constructor through ``ctx``."""
    out = {"map": ctx.map(_square, range(6), timeout=WAIT)}
    scale = 3.0
    out["closure"] = float(ctx.get(
        ctx.remote(lambda a: (a * scale).sum()).remote(
            np.ones((4, 4), np.float32)), timeout=WAIT))
    out["torch"] = ctx.get(ctx.remote(_seeded_product).remote(3),
                           timeout=WAIT)
    with pytest.raises(pkg.RemoteTaskError) as e:
        ctx.get(ctx.remote(_boom).remote(), timeout=WAIT)
    out["task_error"] = _first_line(e.value)
    c = ctx.remote(Counter).remote(10)
    out["actor"] = ctx.get([c.incr.remote() for _ in range(3)]
                           + [c.incr.remote(by=5)], timeout=WAIT)
    ctx.kill(c)
    with pytest.raises(RuntimeError) as e:
        ctx.get(c.incr.remote(), timeout=WAIT)
    out["killed"] = (type(e.value).__name__, _first_line(e.value))
    with pytest.raises(pkg.RemoteTaskError) as e:
        ctx.remote(Boom).remote()
    out["ctor_error"] = _first_line(e.value)
    out["after_errors"] = ctx.get(ctx.remote(_square).remote(7),
                                  timeout=WAIT)
    return out


def test_tasks_errors_and_actors_match_jax_raycontext():
    """The same script through JAX's RayContext and the port's, each with
    two CPU workers: equal results, tensors, error lines and actor
    states."""
    jax_ray = _jax_ray()
    # both pools boot together; the scripts then run one after the other
    with jax_ray.RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                            platform="cpu") as jax_ctx, \
            port_ray.RayContext(num_ray_nodes=2, ray_node_cpu_cores=1,
                                platform="cpu") as port_ctx:
        jax_out = _script(jax_ctx, jax_ray)
        port_out = _script(port_ctx, port_ray)
    assert torch.equal(port_out.pop("torch"), jax_out.pop("torch"))
    assert port_out == jax_out
    assert port_out["task_error"] == "ValueError: kaboom"
    assert port_out["ctor_error"].endswith("ValueError: nope")
    assert port_out["actor"] == [11, 12, 13, 18]


# ---------------------------------------------------------------------------
# a worker host of one package joined to the other package's head
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _join_host(ctx, port, package, tag):
    env = dict(os.environ, ZOO_TEST_HOST_TAG=tag,
               # the host's workers unpickle this module's tasks by
               # reference
               PYTHONPATH=os.pathsep.join([str(ROOT / "tests"),
                                           str(ROOT)]))
    env.pop("XLA_FLAGS", None)
    joiner = subprocess.Popen(
        [sys.executable, "-m", f"{package}.ray.worker_host",
         "--connect", f"127.0.0.1:{port}", "--workers", "2",
         "--platform", "cpu", "--authkey", ctx.cluster_authkey.decode()],
        env=env, cwd=str(ROOT))
    deadline = time.time() + WAIT
    while not ctx._cluster.hosts and time.time() < deadline:
        if joiner.poll() is not None:
            break
        time.sleep(0.2)
    assert ctx._cluster.hosts, f"{package}'s worker host never joined"
    return joiner


def _stop_host(joiner):
    if joiner.poll() is None:
        joiner.terminate()
        joiner.wait(timeout=WAIT)


def _serve_across(head_pkg, host_package, tag):
    """A head of ``head_pkg`` with one CPU worker and a joined host of
    ``host_package``: tasks reach the host, a task's error comes back with
    its line from either side, a sharded parameter server places one
    actor on each side with sticky state, and the host's death resolves its actor as lost
    while the head's actor keeps serving."""
    port = _free_port()
    with head_pkg.RayContext(num_ray_nodes=1, ray_node_cpu_cores=1,
                             platform="cpu",
                             listen=("127.0.0.1", port)) as ctx:
        joiner = _join_host(ctx, port, host_package, tag)
        try:
            results = ctx.get([ctx.remote(_where).remote(i)
                               for i in range(8)], timeout=WAIT)
            assert [r[0] for r in results] == [i * i for i in range(8)]
            assert tag in {r[1] for r in results}
            products = ctx.get([ctx.remote(_seeded_product).remote(5)
                                for _ in range(4)], timeout=WAIT)
            for p in products:
                assert torch.equal(p, _seeded_product(5))
            # an idle host takes two of the four, the head's worker the
            # rest; the host's own pool wraps its worker's error once more
            lines = set()
            for ref in [ctx.remote(_boom).remote() for _ in range(4)]:
                with pytest.raises(head_pkg.RemoteTaskError) as e:
                    ctx.get(ref, timeout=WAIT)
                lines.add(_first_line(e.value))
            assert lines == {"ValueError: kaboom",
                             "RemoteTaskError: ValueError: kaboom"}

            PS = ctx.remote(PSShard)
            shards = [PS.remote(4) for _ in range(2)]
            kinds = sorted(ctx._actors[h._actor_id][0] for h in shards)
            assert kinds == ["local", "remote"], kinds
            for i, h in enumerate(shards):
                for _ in range(2):
                    ctx.get(h.push.remote(np.full(4, float(i + 1))),
                            timeout=WAIT)
            w = [ctx.get(h.pull.remote(), timeout=WAIT) for h in shards]
            np.testing.assert_array_equal(w[0], np.full(4, -1.0))
            np.testing.assert_array_equal(w[1], np.full(4, -2.0))
            remote_h, local_h = sorted(
                shards, key=lambda h: ctx._actors[h._actor_id][0] != "remote")
            _stop_host(joiner)
            deadline = time.time() + WAIT
            while ctx._actors[remote_h._actor_id][0] != "lost" and \
                    time.time() < deadline:
                time.sleep(0.2)
            assert ctx._actors[remote_h._actor_id][0] == "lost"
            with pytest.raises(head_pkg.RemoteTaskError) as e:
                ctx.get(remote_h.pull.remote(), timeout=WAIT)
            lost = _first_line(e.value)
            np.testing.assert_array_equal(
                ctx.get(local_h.pull.remote(), timeout=WAIT),
                np.full(4, -1.0 if local_h is shards[0] else -2.0))
        finally:
            _stop_host(joiner)
    return lost


def test_jax_worker_host_serves_the_port_head():
    lost = _serve_across(port_ray, "analytics_zoo_tpu", "jax-host")
    assert lost == "actor <id> lost: its worker host died"


def test_port_worker_host_serves_a_jax_head():
    lost = _serve_across(_jax_ray(), "analytics_zoo_tpu_torch", "port-host")
    assert lost == "actor <id> lost: its worker host died"
