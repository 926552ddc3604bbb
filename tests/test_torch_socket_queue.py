"""The port's socket transport against the JAX package's, on the CPU.

- The cases of ``test_socket_queue.py`` on the port's broker and
  client: the claim ledger, redelivery on disconnect, the claim-timeout
  sweep, acks piggybacked on results, the result long-poll, reconnection,
  client-side dedupe and the CLI's transport row.
- Frames byte for byte equal to JAX's ``write_frame`` (the port packs
  them with its own msgpack codec, ``wire.py``).
- A JAX client on the port's broker and a port client on JAX's broker:
  enqueue, claim, ack and results, each record once.

Every check is exact (counts, uris, bytes); the long-poll's wake-up is
held to JAX's window of 0.1-3 s.
"""

import os
import socket
import threading
import time

import pytest

from analytics_zoo_tpu.serving import socket_queue as jsq
from analytics_zoo_tpu_torch.serving import SocketStreamQueue, \
    StreamQueueBroker
from analytics_zoo_tpu_torch.serving import socket_queue as tsq
from analytics_zoo_tpu_torch.serving.socket_queue import parse_socket_spec

PKG = {"jax": jsq, "torch": tsq}


@pytest.fixture
def broker():
    b = StreamQueueBroker(claim_timeout_s=1.0).start()
    yield b
    b.shutdown()


def _rec(i):
    return {"uri": f"u-{i}", "data": b"x" * 8, "shape": [1]}


def test_parse_socket_spec():
    assert parse_socket_spec("socket://10.0.0.5:6006") == ("10.0.0.5", 6006)
    assert parse_socket_spec("socket://broker:81") == ("broker", 81)
    with pytest.raises(ValueError):
        parse_socket_spec("file:/tmp/q")
    with pytest.raises(ValueError):
        parse_socket_spec("socket://noport")


def test_redelivery_on_disconnect(broker):
    prod = SocketStreamQueue("127.0.0.1", broker.port)
    for i in range(8):
        prod.enqueue(_rec(i))

    dead = SocketStreamQueue("127.0.0.1", broker.port)
    claimed = [rec["uri"] for _r, rec in dead.read_batch(4, timeout=2.0)]
    assert claimed == ["u-0", "u-1", "u-2", "u-3"]
    assert broker.stats()["claims_outstanding"] == 4
    dead.close()  # worker dies with unacked claims

    deadline = time.time() + 5.0
    while broker.stats()["redelivered"] < 4:
        assert time.time() < deadline, broker.stats()
        time.sleep(0.02)
    surv = SocketStreamQueue("127.0.0.1", broker.port)
    got = [rec["uri"] for _r, rec in surv.read_batch(16, timeout=2.0)]
    assert got == [f"u-{i}" for i in range(8)]


def test_claim_timeout_sweep(broker):
    prod = SocketStreamQueue("127.0.0.1", broker.port)
    for i in range(4):
        prod.enqueue(_rec(i))
    slow = SocketStreamQueue("127.0.0.1", broker.port)
    assert len(slow.read_batch(4, timeout=2.0)) == 4
    # the connection stays open (a wedged worker, not a dead one): only
    # the 1 s claim_timeout_s sweep can reclaim these
    time.sleep(1.2)
    other = SocketStreamQueue("127.0.0.1", broker.port)
    got = [rec["uri"] for _r, rec in other.read_batch(8, timeout=3.0)]
    assert got == [f"u-{i}" for i in range(4)]
    assert broker.stats()["redelivered"] == 4


def test_ack_via_put_results_clears_claims(broker):
    q = SocketStreamQueue("127.0.0.1", broker.port)
    for i in range(3):
        q.enqueue(_rec(i))
    batch = q.read_batch(3, timeout=2.0)
    assert broker.stats()["claims_outstanding"] == 3
    q.put_results({rec["uri"]: b"done" for _r, rec in batch})
    assert broker.stats()["claims_outstanding"] == 0
    assert broker.stats()["acked"] == 3
    q.close()
    time.sleep(0.1)
    assert broker.stats()["stream_len"] == 0


def test_wait_any_long_poll_wakes_on_result(broker):
    q = SocketStreamQueue("127.0.0.1", broker.port)
    assert q.supports_long_poll
    writer = SocketStreamQueue("127.0.0.1", broker.port)
    timer = threading.Timer(0.25, lambda: writer.put_result("late", b"v"))
    timer.start()
    t0 = time.time()
    got = q.wait_any(["late", "never"], timeout=5.0, pop=True)
    dt = time.time() - t0
    timer.join(timeout=5.0)
    assert not timer.is_alive()
    assert got == {"late": b"v"}
    assert 0.1 < dt < 3.0, f"long-poll did not wake promptly ({dt:.2f}s)"
    assert q.get_result("late") is None


def test_client_reconnects_after_broker_side_drop(broker):
    q = SocketStreamQueue("127.0.0.1", broker.port)
    q.enqueue(_rec(0))
    q._drop_conn()
    q.enqueue(_rec(1))
    assert q.stream_len() == 2


def test_duplicate_serve_is_deduped_client_side(broker):
    prod = SocketStreamQueue("127.0.0.1", broker.port)
    for i in range(4):
        prod.enqueue(_rec(i))
    dead = SocketStreamQueue("127.0.0.1", broker.port)
    dead.read_batch(4, timeout=2.0)
    dead.close()
    surv = SocketStreamQueue("127.0.0.1", broker.port)
    deadline = time.time() + 5.0
    got = []
    while len(got) < 4 and time.time() < deadline:
        got += surv.read_batch(8, timeout=0.5)
    assert [rec["uri"] for _r, rec in got] == [f"u-{i}" for i in range(4)]
    assert surv.consumer_stats()["duplicates"] == 0


def test_cli_status_renders_transport(broker, tmp_path, capsys,
                                      monkeypatch):
    from analytics_zoo_tpu_torch.serving import cli

    (tmp_path / "config.yaml").write_text(
        f"data:\n  src: socket://127.0.0.1:{broker.port}\n")
    monkeypatch.delenv("ZOO_SERVING_TRANSPORT", raising=False)
    q = SocketStreamQueue("127.0.0.1", broker.port)
    q.enqueue(_rec(0))
    cli._print_transport(str(tmp_path))
    out = capsys.readouterr().out
    assert f"transport socket://127.0.0.1:{broker.port}:" in out
    assert "stream_len=1" in out
    assert "claims_outstanding=0" in out
    assert "redelivered=0" in out

    broker.shutdown()
    cli._print_transport(str(tmp_path))
    assert "UNREACHABLE" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

FRAMES = [
    {"op": "enqueue", "records": [_rec(0), {"uri": "é-ü", "n": -3}],
     "toks": ["a" * 32, None]},
    {"op": "read_batch", "consumer": "c0ffee", "max": 16,
     "timeout_ms": 1000.0},
    {"ok": True, "items": [["00000-abc-00000001", {
        "uri": "x", "tensors": {"t": {"data": bytes(range(256)) * 300,
                                       "shape": [3, 224, 224]}},
        "enqueue_ts_ms": 1.7e12, "deadline_ms": None, "flag": False,
        "big": 2 ** 40, "neg": -2 ** 33, "f": 0.1}]]},
    {"ok": False, "error": "ValueError: unknown op 'x'"},
    {"op": "put_results", "results": {"u-1": b"{}", "u-2": b""},
     "consumer": "c", "rids": ["r1", "r2"]},
]


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_frames_are_byte_equal_to_jax(k):
    out = {}
    for pkg, mod in PKG.items():
        a, b = socket.socketpair()
        try:
            mod.write_frame(a, FRAMES[k])
            a.shutdown(socket.SHUT_WR)
            b.settimeout(10.0)          # a short frame fails, not hangs
            buf = b""
            while True:
                chunk = b.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
            out[pkg] = buf
        finally:
            a.close()
            b.close()
    assert out["torch"] == out["jax"]
    # and each package reads the other's frame back to the same object
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        a, b = socket.socketpair()
        try:
            PKG[writer].write_frame(a, FRAMES[k])
            assert PKG[reader].read_frame(b) == FRAMES[k]
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("pair", ["jax_client_torch_broker",
                                  "torch_client_jax_broker"])
def test_cross_package_client_and_broker(pair):
    client_pkg, broker_pkg = (("jax", "torch") if pair.startswith("jax")
                              else ("torch", "jax"))
    b = PKG[broker_pkg].StreamQueueBroker(claim_timeout_s=5.0).start()
    try:
        prod = PKG[client_pkg].SocketStreamQueue("127.0.0.1", b.port)
        cons = PKG[client_pkg].SocketStreamQueue("127.0.0.1", b.port)
        for i in range(12):
            prod.enqueue(_rec(i))
        got = []
        deadline = time.time() + 10.0
        while len(got) < 12 and time.time() < deadline:
            got += cons.read_batch(5, timeout=0.5)
        assert [rec["uri"] for _r, rec in got] == [f"u-{i}"
                                                    for i in range(12)]
        assert all(rec["data"] == b"x" * 8 for _r, rec in got)
        assert b.stats()["claims_outstanding"] == 12
        cons.put_results({rec["uri"]: rec["uri"].encode()
                          for _r, rec in got})
        st = b.stats()
        assert (st["acked"], st["claims_outstanding"], st["stream_len"]) \
            == (12, 0, 0)
        res = prod.wait_any([f"u-{i}" for i in range(12)], timeout=5.0)
        assert res == {f"u-{i}": f"u-{i}".encode() for i in range(12)}
        assert prod.all_results() == {}
        assert cons.consumer_stats()["duplicates"] == 0
        prod.close()
        cons.close()
    finally:
        b.shutdown()


def test_broker_main_serves_standalone(tmp_path):
    """``python -m analytics_zoo_tpu_torch.serving.socket_queue`` is a
    broker a client can reach (the process the shard fabric spawns)."""
    from analytics_zoo_tpu_torch.serving.shard_fabric import (
        spawn_broker_proc, wait_broker_up)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = spawn_broker_proc(port)
    try:
        wait_broker_up("127.0.0.1", port, timeout=30.0)
        q = SocketStreamQueue("127.0.0.1", port)
        q.enqueue(_rec(0))
        assert q.stats()["enqueued"] == 1
        q.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)
    assert proc.poll() is not None
    assert os.path.basename(proc.args[2]) == \
        "analytics_zoo_tpu_torch.serving.socket_queue"
