"""The port's Cluster Serving loop and queues against the JAX package's,
on the CPU.

- The queue conformance cases of ``test_queue_conformance.py`` over the
  port's in-process and file queues.
- The same seeded stream through JAX's ``ClusterServing`` and the port's,
  the port's weights copied from JAX's with ``load_jax_params``: a small
  CNN at ``image_shape 3,16,16`` with ``top_n 5``. The synchronous loop
  with every record queued before it starts reads the same batches in
  both packages, so the result keys, the top-5 ids, the counters and the
  bucket counts are equal and the probabilities within 1e-5 (a float32
  convolution and Dense product summed in another order). The pipelined
  loop's batches depend on thread timing: its rows are held to the same
  tolerance, its counters to the record count.
- Generate records through both loops on a 2-block, 64-wide causal
  ``TransformerLayer`` with copied weights: equal token streams, alone
  and in a stream mixed with predict records.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import serving as js
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jm
from analytics_zoo_tpu.pipeline.api.keras.layers.self_attention import \
    TransformerLayer as JTransformerLayer
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
from analytics_zoo_tpu_torch import serving as ts
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tm
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as TIM
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    HostCopy
from analytics_zoo_tpu_torch.serving import cluster_serving as tcs
from analytics_zoo_tpu_torch.utils import load_jax_params

PROB_TOL = 1e-5
SHAPE = (3, 16, 16)
CLASSES = 10
TOP_N = 5
MOD = {"jax": js, "torch": ts}
COUNTERS = ("records_in", "results_out", "dropped", "dead_letters", "shed",
            "batches", "buckets")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _config(**params):
    return {"data": {"image_shape": "3, 16, 16"},
            "params": {"batch_size": 4, "top_n": TOP_N, **params},
            "generate": {"slots": 2, "max_len": 64, "max_new_tokens": 6}}


def _cnn(layers, models):
    seq = models.Sequential()
    seq.add(layers.Convolution2D(4, 3, 3, activation="relu",
                                 input_shape=SHAPE))
    seq.add(layers.Flatten())
    seq.add(layers.Dense(CLASSES, activation="softmax"))
    return seq


@pytest.fixture(scope="module")
def cnn():
    jmodel = _cnn(jl, jm)
    tmodel = _cnn(tl, tm)
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    return {"jax": jmodel, "torch": tmodel}


def _server(pkg, model, backend, **params):
    mod = MOD[pkg]
    im = (JIM if pkg == "jax" else TIM)().load_keras_net(model)
    return mod.ClusterServing(
        model=im, helper=mod.ClusterServingHelper(config=_config(**params)),
        backend=backend)


def _images(n, seed=0):
    rs = np.random.default_rng(seed)
    return {f"r{i}": rs.standard_normal(SHAPE).astype(np.float32)
            for i in range(n)}


def _serve_stream(pkg, model, records, backend=None, **params):
    """Queue ``records`` ([(kind, uri, payload)]) with ``pkg``'s client
    and build ``pkg``'s loop over the queue (``_run`` starts it)."""
    mod = MOD[pkg]
    backend = backend or mod.InProcessStreamQueue()
    iq = mod.InputQueue(backend=backend)
    for kind, uri, payload in records:
        if kind == "tensor":
            iq.enqueue(uri, t=payload)
        elif kind == "image":
            iq.enqueue_image(uri, payload)
        else:
            iq.enqueue_generate(uri, payload)
    server = _server(pkg, model, backend, **params)
    return server, backend


def _run(server, backend, pkg, uris, wait=30.0):
    server.start()
    try:
        got = MOD[pkg].OutputQueue(backend=backend).wait_all(
            uris, timeout=wait)
    finally:
        server.stop()
    return got


def _assert_rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for uri in want:
        a, b = np.asarray(got[uri]), np.asarray(want[uri])
        assert a.shape == b.shape == (TOP_N, 2), uri
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=0, atol=PROB_TOL)


def _counters(server):
    stats = server.pipeline_stats()
    return {k: stats[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# queue conformance (tests/test_queue_conformance.py over the port's queues)
# ---------------------------------------------------------------------------

@pytest.fixture
def make_queue(tmp_path):
    inproc = ts.InProcessStreamQueue()

    def factory(kind):
        return inproc if kind == "inproc" else \
            ts.FileStreamQueue(str(tmp_path))
    return factory


def _rec(i):
    return {"uri": f"u-{i}", "data": b"x" * 8, "shape": [1]}


@pytest.mark.parametrize("kind", ["inproc", "file"])
def test_fifo_and_dequeue_stamp(kind, make_queue):
    q = make_queue(kind)
    before_ms = time.time() * 1000.0 - 1.0
    for i in range(6):
        rid = q.enqueue(_rec(i))
        assert isinstance(rid, str) and rid
    assert q.stream_len() == 6
    batch = q.read_batch(4, timeout=2.0)
    for rid, rec in batch:
        assert isinstance(rid, str) and rid
        assert rec["dequeue_ts_ms"] >= before_ms
    got = [rec["uri"] for _rid, rec in batch]
    got += [rec["uri"] for _rid, rec in q.read_batch(10, timeout=2.0)]
    assert got == [f"u-{i}" for i in range(6)]


def test_file_consumers_claim_disjoint_records(make_queue):
    a, b = make_queue("file"), make_queue("file")
    for i in range(20):
        a.enqueue(_rec(i))
    seen_a = [rec["uri"] for _r, rec in a.read_batch(7, timeout=2.0)]
    seen_b = [rec["uri"] for _r, rec in b.read_batch(7, timeout=2.0)]
    seen_a += [rec["uri"] for _r, rec in a.read_batch(20, timeout=2.0)]
    assert not set(seen_a) & set(seen_b), "record claimed twice"
    assert sorted(seen_a + seen_b) == sorted(f"u-{i}" for i in range(20))


@pytest.mark.parametrize("kind", ["inproc", "file"])
def test_batched_results_and_pop(kind, make_queue):
    q = make_queue(kind)
    q.put_results({"r-1": b"one", "r-2": b"two"})
    q.put_result("r-3", b"three")
    assert q.get_result("r-1", pop=False) == b"one"
    assert q.get_result("r-1", pop=True) == b"one"
    assert q.get_result("r-1") is None
    assert q.all_results(pop=True) == {"r-2": b"two", "r-3": b"three"}
    assert q.all_results(pop=True) == {}


@pytest.mark.parametrize("kind", ["inproc", "file"])
def test_trim_keeps_newest(kind, make_queue):
    q = make_queue(kind)
    for i in range(10):
        q.enqueue(_rec(i))
    q.trim(keep_last=3)
    assert q.stream_len() == 3
    got = [rec["uri"] for _r, rec in q.read_batch(10, timeout=2.0)]
    assert got == ["u-7", "u-8", "u-9"]


@pytest.mark.parametrize("kind", ["inproc", "file"])
def test_empty_read_respects_timeout(kind, make_queue):
    q = make_queue(kind)
    t0 = time.time()
    assert q.read_batch(4, timeout=0.2) == []
    assert time.time() - t0 < 2.0


def test_file_queue_ledger_counts_duplicates_and_gaps_as_jax(tmp_path):
    counts = {}
    for pkg, mod in MOD.items():
        ledger = mod.DeliveryLedger(window=4, producer_cap=2)
        rids = ["00-p-00000000", "00-p-00000001", "00-p-00000001",
                "00-p-00000004", "00-q-00000000", "00-r-00000003",
                "00-p-00000005"]
        counts[pkg] = ([ledger.note(r) for r in rids], ledger.stats())
    assert counts["jax"] == counts["torch"]


@pytest.mark.parametrize("spec", ["socket://127.0.0.1:1", "shard://a:1,b:2"])
def test_network_transports_are_not_ported_yet(spec):
    """The network transports are ported now (the name is kept from
    when they raised): ``get_queue_backend`` gives the counterpart of
    JAX's class for each spec, without connecting."""
    q = {pkg: mod.get_queue_backend(spec) for pkg, mod in MOD.items()}
    try:
        assert type(q["torch"]).__name__ == type(q["jax"]).__name__
        assert type(q["torch"]).__name__ in ("SocketStreamQueue",
                                             "ShardedStreamQueue")
    finally:
        for v in q.values():
            v.close()


def test_routed_generate_placement_is_not_ported_yet(tmp_path):
    """Routed placement is ported now (the name is kept from when it
    raised): as in JAX, a queue that is not file-rooted leaves
    placement off, and a file-rooted one turns it on."""
    for pkg, mod in MOD.items():
        iq = mod.InputQueue(backend=mod.InProcessStreamQueue(),
                            route_workdir=str(tmp_path))
        assert iq.routing_stats is None, pkg
        fq = mod.FileStreamQueue(str(tmp_path / pkg / "stream"))
        iq = mod.InputQueue(backend=fq, route_workdir=str(tmp_path / pkg))
        assert iq.routing_stats["routed"] == 0, pkg


# ---------------------------------------------------------------------------
# the predict loop against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["inproc", "file"])
def test_sync_loop_matches_jax_on_a_fixed_arrival(cnn, tmp_path, transport):
    images = _images(10)
    records = [("tensor", uri, img) for uri, img in images.items()]
    got, counters = {}, {}
    for pkg in ("jax", "torch"):
        backend = (MOD[pkg].FileStreamQueue(str(tmp_path / pkg))
                   if transport == "file" else None)
        server, backend = _serve_stream(pkg, cnn[pkg], records,
                                        backend=backend, pipelined=False)
        got[pkg] = _run(server, backend, pkg, list(images))
        counters[pkg] = _counters(server)
    _assert_rows_equal(got["torch"], got["jax"])
    assert counters["torch"] == counters["jax"]
    assert counters["torch"]["results_out"] == 10


def test_pipelined_loop_matches_jax_row_for_row(cnn):
    images = _images(23, seed=1)
    records = [("tensor", uri, img) for uri, img in images.items()]
    got, servers = {}, {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(pkg, cnn[pkg], records)
        got[pkg] = _run(server, backend, pkg, list(images))
        servers[pkg] = server
    _assert_rows_equal(got["torch"], got["jax"])
    stats = servers["torch"].pipeline_stats()
    assert stats["records_in"] == stats["results_out"] == 23
    assert stats["dropped"] == stats["shed"] == 0
    assert set(stats["buckets"]) <= {1, 2, 4}
    assert sum(b * n for b, n in stats["buckets"].items()) >= 23
    for stage in ("decode", "dispatch", "compute", "write", "e2e",
                  "device", "queue_wait", "transport"):
        assert stats["stages"][stage]["count"] > 0, stage


@pytest.mark.parametrize("pipelined", [True, False])
def test_bad_records_are_dropped_as_jax_drops_them(cnn, pipelined):
    counters = {}
    for pkg in ("jax", "torch"):
        backend = MOD[pkg].InProcessStreamQueue()
        backend.enqueue({"uri": "bad", "tensors": {
            "x": {"shape": [5], "data": b"xx"}}})
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("tensor", "good", _images(1)["r0"])],
            backend=backend, pipelined=pipelined)
        got = _run(server, backend, pkg, ["good"])
        assert sorted(got) == ["good"]
        counters[pkg] = _counters(server)
    assert counters["torch"]["dropped"] == counters["jax"]["dropped"] == 1
    assert counters["torch"]["results_out"] == 1


def test_cut_image_records_are_dropped_as_jax_drops_them(cnn):
    """An image record whose JPEG was cut inside its data: OpenCV refuses
    it (JAX's server drops the record) and so does the port's codec,
    with a ``ValueError`` the server counts as a dropped record."""
    import cv2

    img = np.random.default_rng(6).integers(0, 255, (30, 41, 3)).astype(
        np.uint8)
    cut = cv2.imencode(".jpg", img)[1].tobytes()[:-40]
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) \
        is None
    counters = {}
    for pkg in ("jax", "torch"):
        backend = MOD[pkg].InProcessStreamQueue()
        iq = MOD[pkg].InputQueue(backend=backend)
        backend.enqueue({"uri": "cut", "image": iq.base64_encode_image(cut)})
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("image", "good", img)], backend=backend,
            pipelined=False)
        got = _run(server, backend, pkg, ["good"])
        assert sorted(got) == ["good"]
        counters[pkg] = _counters(server)
    assert counters["torch"]["dropped"] == counters["jax"]["dropped"] == 1
    assert counters["torch"]["results_out"] == 1


@pytest.mark.parametrize("batch_size", [1, 4, 6, 16])
def test_buckets_match_jax(batch_size):
    assert ts.power_of_two_buckets(batch_size) == \
        js.power_of_two_buckets(batch_size)
    for n in range(1, batch_size + 3):
        buckets = ts.power_of_two_buckets(batch_size)
        assert ts.pick_bucket(n, buckets) == js.pick_bucket(n, buckets)


def test_bucket_sizes_override_matches_jax(cnn):
    servers = {pkg: _server(pkg, cnn[pkg], MOD[pkg].InProcessStreamQueue(),
                            batch_size=8, bucket_sizes="2, 8")
               for pkg in MOD}
    assert servers["torch"].buckets == servers["jax"].buckets == [2, 8]
    assert servers["torch"].helper.bucket_sizes == [2, 8]


def test_helper_parses_the_config_as_jax_does(tmp_path):
    config = {"model": {"path": "/m"},
              "data": {"src": "file:/q", "image_shape": "3, 8, 8"},
              "params": {"batch_size": 6, "top_n": 0, "pipelined": "false",
                         "linger_ms": 2, "default_deadline_ms": 50,
                         "warmup": "yes"},
              "slo": {"objectives": [{"name": "lat", "p99_ms": 20}]},
              "generate": {"slots": 3, "kv_cache": "int8",
                           "prefix_cache_mb": 4,
                           "speculative": {"k": 2}},
              "registry": {"root": "/r", "default_model": "m"}}
    import yaml

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    helpers = {pkg: MOD[pkg].ClusterServingHelper(config_path=str(path))
               for pkg in MOD}
    jvars = {k: v for k, v in vars(helpers["jax"]).items()
             if k not in ("slo_objectives", "slo_classes")}
    tvars = {k: v for k, v in vars(helpers["torch"]).items()
             if k not in ("slo_objectives", "slo_classes")}
    assert tvars == jvars
    assert [vars(o) for o in helpers["torch"].slo_objectives] == \
        [vars(o) for o in helpers["jax"].slo_objectives]


def test_warmup_runs_every_bucket(cnn):
    server = _server("torch", cnn["torch"], ts.InProcessStreamQueue(),
                     batch_size=16)
    times = server.warmup()
    assert sorted(times) == [1, 2, 4, 8, 16] == server.buckets
    assert all(t > 0 for t in times.values())


def test_timing_payload_has_jax_keys(cnn):
    keys = {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("tensor", f"t{i}", img) for i, img in
                            enumerate(_images(5).values())])
        got = _run(server, backend, pkg, [f"t{i}" for i in range(5)])
        keys[pkg] = {uri: sorted(r.timing) for uri, r in got.items()}
        for r in got.values():
            assert r.timing["device_ms"] >= 0.0
            assert r.timing["rtt_ms"] + 1e-6 >= r.timing["server_ms"]
    assert keys["torch"] == keys["jax"]


def test_unmeetable_deadline_is_shed_with_jax_code(cnn):
    codes = {}
    for pkg in ("jax", "torch"):
        mod = MOD[pkg]
        backend = mod.InProcessStreamQueue()
        server = _server(pkg, cnn[pkg], backend)
        server.admission.observe_batch(4, 0.040)
        iq = mod.InputQueue(backend=backend)
        img = _images(1)["r0"]
        iq.enqueue("tight", deadline_ms=1.0, t=img)
        iq.enqueue("free", t=img)
        got = _run(server, backend, pkg, ["tight", "free"])
        assert isinstance(got["tight"], mod.ServingRejected)
        assert not isinstance(got["free"], mod.ServingError)
        codes[pkg] = (got["tight"].code, server.pipeline_stats()["shed"],
                      server.pipeline_stats()["admission"]["shed_deadline"])
    assert codes["torch"] == codes["jax"] == ("shed_deadline", 1, 1)


def test_image_records_through_cv2_match_jax(cnn):
    rs = np.random.default_rng(4)
    imgs = {f"i{i}": rs.integers(0, 255, (20, 24, 3)).astype(np.uint8)
            for i in range(5)}
    got = {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("image", u, im) for u, im in imgs.items()],
            pipelined=False)
        got[pkg] = _run(server, backend, pkg, list(imgs))
    _assert_rows_equal(got["torch"], got["jax"])


def test_image_records_decode_without_cv2(cnn, monkeypatch):
    """The card's machine is not promised OpenCV: with ``cv2`` hidden
    (an import of it raises), the port's client encodes and its server
    decodes and resizes image records through the port's own codec, and
    the record's tensor equals the one OpenCV's decode and resize give
    for the same bytes; the served rows equal JAX's."""
    import sys

    import cv2

    img = np.random.default_rng(5).integers(0, 255, (30, 41, 3)).astype(
        np.uint8)
    blobs = {"jpg": cv2.imencode(".jpg", img)[1].tobytes(),
             "png": cv2.imencode(".png", img)[1].tobytes()}
    want = {k: np.transpose(cv2.resize(
        cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR),
        (SHAPE[2], SHAPE[1])).astype(np.float32), (2, 0, 1))
        for k, b in blobs.items()}
    jserver, jbackend = _serve_stream(
        "jax", cnn["jax"], [("image", "a", img), ("image", "b", img[::-1])],
        pipelined=False)
    jrows = _run(jserver, jbackend, "jax", ["a", "b"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _hidden  # noqa: F401
    backend = ts.InProcessStreamQueue()
    server = _server("torch", cnn["torch"], backend)
    client = ts.InputQueue(backend=backend)
    for k, b in blobs.items():
        rec = {"uri": k, "image": client.base64_encode_image(b)}
        np.testing.assert_array_equal(server._decode_record(rec), want[k])
    records = [("image", "a", img), ("image", "b", img[::-1])]
    tserver, tbackend = _serve_stream("torch", cnn["torch"], records,
                                      pipelined=False)
    _assert_rows_equal(_run(tserver, tbackend, "torch", ["a", "b"]), jrows)


def test_echo_stub_and_host_copy_on_the_cpu():
    stub = ts.EchoStubModel(ms_per_batch=0.0)
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(HostCopy(stub.predict_async(x)).wait(),
                                  js.EchoStubModel(0.0).predict(x))
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    np.testing.assert_array_equal(HostCopy(t.float()).wait(),
                                  t.float().numpy())
    multi = HostCopy([torch.ones(2), np.zeros(3)]).wait()
    assert [a.tolist() for a in multi] == [[1.0, 1.0], [0.0, 0.0, 0.0]]


# ---------------------------------------------------------------------------
# generate records
# ---------------------------------------------------------------------------

GEN_CONFIG = dict(n_block=2, hidden_size=64, n_head=1, vocab=97, seq_len=64)


def _draw_params(template, seed):
    """Numpy weights in the layout of ``template``, at scales that make
    greedy streams move: embeddings N(0, 0.3), matrices N(0,
    2/sqrt(fan_in)), LN gains 1 + N(0, 0.1), biases N(0, 0.1)."""
    rs = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if a.ndim == 2:
            std = 0.3 if "emb" in name else 2.0 / np.sqrt(a.shape[0])
            return rs.normal(0.0, std, a.shape).astype(np.float32)
        if name.endswith("_g"):
            return (1.0 + 0.1 * rs.normal(size=a.shape)).astype(np.float32)
        return (0.1 * rs.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


@pytest.fixture(scope="module")
def decoder():
    jlayer = JTransformerLayer(**GEN_CONFIG)
    template = jlayer.build(jax.random.PRNGKey(0), (None, 64))
    return jlayer, _draw_params(template, seed=2)


def _prompts(n, seed=5):
    rs = np.random.default_rng(seed)
    return {f"g{i}": rs.integers(1, GEN_CONFIG["vocab"], size=int(m))
            for i, m in enumerate(rs.integers(3, 20, size=n))}


def _attach_engine(pkg, server, decoder):
    jlayer, np_params = decoder
    if pkg == "jax":
        server.build_transformer_engine(
            jlayer, jax.tree.map(jax.numpy.asarray, np_params))
    else:
        tlayer = tl.TransformerLayer(**GEN_CONFIG)
        tlayer.build_params(torch.Generator().manual_seed(0), (None, 64))
        server.build_transformer_engine(tlayer, np_params)


def _token_lists(got):
    return {uri: [int(t) for t in np.asarray(r)] for uri, r in got.items()}


@pytest.mark.parametrize("pipelined", [True, False])
def test_generate_streams_match_jax(cnn, decoder, pipelined):
    prompts = _prompts(4)
    streams = {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("generate", u, p) for u, p in prompts.items()],
            pipelined=pipelined)
        _attach_engine(pkg, server, decoder)
        got = _run(server, backend, pkg, list(prompts), wait=120)
        for r in got.values():
            assert isinstance(r, MOD[pkg].GenerationResult)
            assert r.finish == "max_new_tokens" and len(r) == 6
        streams[pkg] = _token_lists(got)
        gen = server.pipeline_stats()["generation"]
        assert gen["committed"] == len(prompts)
    assert streams["torch"] == streams["jax"]


def test_mixed_predict_and_generate_stream_matches_jax(cnn, decoder):
    images = _images(9, seed=7)
    prompts = _prompts(3, seed=8)
    records = []
    for i, (uri, img) in enumerate(images.items()):
        records.append(("tensor", uri, img))
        if i % 3 == 2:
            g = f"g{i // 3}"
            records.append(("generate", g, prompts[g]))
    got = {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(pkg, cnn[pkg], records)
        _attach_engine(pkg, server, decoder)
        got[pkg] = _run(server, backend, pkg,
                        list(images) + list(prompts), wait=120)
        stats = server.pipeline_stats()
        assert stats["results_out"] == len(images) + len(prompts)
        assert stats["dropped"] == stats["shed"] == 0
    _assert_rows_equal({u: got["torch"][u] for u in images},
                       {u: got["jax"][u] for u in images})
    assert _token_lists({u: got["torch"][u] for u in prompts}) == \
        _token_lists({u: got["jax"][u] for u in prompts})


def test_generate_without_an_engine_is_dead_lettered_as_jax(cnn):
    payloads = {}
    for pkg in ("jax", "torch"):
        server, backend = _serve_stream(
            pkg, cnn[pkg], [("generate", "g", [1, 2, 3])], pipelined=False)
        server._process_batch(backend.read_batch(4, timeout=1.0))
        payloads[pkg] = (json.loads(backend.get_result("g")),
                         _counters(server))
    assert payloads["torch"] == payloads["jax"]
    assert payloads["torch"][0]["code"] == "no_engine"


def test_build_transformer_engine_takes_the_layer_as_it_is(decoder):
    jlayer, np_params = decoder
    tlayer = tl.TransformerLayer(**GEN_CONFIG)
    tlayer.build_params(torch.Generator().manual_seed(0), (None, 64))
    load_jax_params(tlayer, {tlayer.name: np_params})
    before = {k: v.clone() for k, v in tlayer.state_dict().items()}
    server = _server("torch", _cnn(tl, tm), ts.InProcessStreamQueue())
    server.build_transformer_engine(tlayer)
    engine = server._gen_engine
    assert isinstance(engine, ts.TransformerDecodeEngine)
    assert engine.device == torch.device("cpu")
    assert engine.buckets == [64]
    for k, v in tlayer.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tcs.ClusterServing.build_transformer_engine.__defaults__[0] is None


def test_load_keras_net_moves_weights_built_at_load():
    """An unbuilt Sequential builds its weights when its graph is first
    asked for; ``load_keras_net`` must build them before the move to the
    device, or they stay on the CPU while the inputs go to the card (the
    meta device stands in for the card here)."""
    model = _cnn(tl, tm)
    assert not any(True for _ in model.parameters())
    im = TIM().load_keras_net(model, device="meta")
    params = list(im.model.model.parameters())
    assert params and {p.device.type for p in params} == {"meta"}


def test_tenants_slo_stats_file_and_request_log_match_jax(cnn, tmp_path):
    """SLO classes, objectives, the stats file and the request log, armed
    from the config: the same stream through both pipelined loops gives
    the same per-tenant intake counts, the same per-class and global SLO
    event counts, a stats file and one request-log row a record."""
    slo = {"objectives": [{"name": "lat", "p99_ms": 60_000}],
           "classes": [{"name": "premium", "model": "a", "weight": 3,
                        "shed_wait_ms": 60_000,
                        "objectives": [{"name": "lat", "p99_ms": 60_000}]},
                       {"name": "rest", "shed_wait_ms": 60_000}]}
    images = _images(12, seed=9)
    seen = {}
    for pkg in ("jax", "torch"):
        mod = MOD[pkg]
        backend = mod.InProcessStreamQueue()
        config = _config(stats_path=str(tmp_path / pkg / "stats.json"),
                         request_log=str(tmp_path / pkg / "requests.jsonl"))
        config["slo"] = slo
        im = (JIM if pkg == "jax" else TIM)().load_keras_net(cnn[pkg])
        server = mod.ClusterServing(
            model=im, helper=mod.ClusterServingHelper(config=config),
            backend=backend)
        iq = mod.InputQueue(backend=backend)
        for i, (uri, img) in enumerate(images.items()):
            iq.enqueue(uri, model="a" if i % 2 else None, t=img)
        got = _run(server, backend, pkg, list(images))
        assert sorted(got) == sorted(images)
        stats = server.pipeline_stats()
        rows = (tmp_path / pkg / "requests.jsonl").read_text().splitlines()
        dumped = json.loads((tmp_path / pkg / "stats.json").read_text())
        seen[pkg] = dict(
            tenants=stats["tenants"],
            slo={k: v["n_slow"] for k, v in stats["slo"].items()},
            classes={c: {k: v["n_slow"] for k, v in s.items()}
                     for c, s in stats["slo_classes"].items()},
            rows=sorted((json.loads(r)["kind"], json.loads(r)["uri"],
                         json.loads(r).get("tenant")) for r in rows),
            dumped=sorted(k for k in dumped if k not in ("stages",
                                                         "queues")))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["tenants"]["premium"]["offered"] == 6
    assert seen["torch"]["slo"] == {"lat": 12}
    assert len(seen["torch"]["rows"]) == 12
