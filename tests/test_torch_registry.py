"""The port's model registry and router against the JAX package's, on the
CPU.

Two versions of a small CNN are saved once (by the JAX package: the port
loads the same directories) and driven through the same sequence on both
registries: deploy v1, deploy v2 as a canary of weight 0.5, serve a
stream through ``RoutedClusterServing``, promote v2, roll back, promote
again and undeploy v1. After every step the manifests are equal (the
deploy times aside), the canary sends the same uris to v2 in both
packages (``crc32`` of the uri), and every routed result equals its own
version's direct ``predict`` and JAX's row (top-3 ids equal,
probabilities within 1e-5: float32 products summed in another order).
"""

import json
import zlib

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import serving as js
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jm
from analytics_zoo_tpu_torch import serving as ts
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as TIM
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    AbstractModel

PROB_TOL = 1e-5
SHAPE = (3, 8, 8)
MOD = {"jax": js, "torch": ts}
N_RECORDS = 40
WEIGHT = 0.5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _cnn():
    seq = jm.Sequential()
    seq.add(jl.Convolution2D(2, 3, 3, activation="relu", input_shape=SHAPE))
    seq.add(jl.Flatten())
    seq.add(jl.Dense(6, activation="softmax"))
    return seq


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Two saved versions: v2 carries v1's weights scaled by 1.5."""
    root = tmp_path_factory.mktemp("models")
    v1 = _cnn()
    v2 = _cnn()
    v2.set_weights([1.5 * w for w in v1.get_weights()])
    paths = []
    for i, model in enumerate((v1, v2), 1):
        path = str(root / f"v{i}")
        model.save_model(path)
        paths.append(path)
    return paths


def _helper(pkg):
    return MOD[pkg].ClusterServingHelper(config={
        "data": {"image_shape": "3, 8, 8"},
        "params": {"batch_size": 4, "top_n": 3}})


def _manifest(root):
    data = json.loads((root / "manifest.json").read_text())
    for m in data["models"].values():
        for v in m["versions"]:
            v.pop("created")
    return data


def _records():
    rs = np.random.default_rng(0)
    return {f"user-{i}/img-{i}.jpg": rs.standard_normal(SHAPE)
            .astype(np.float32) for i in range(N_RECORDS)}


def _serve(pkg, serving, backend, records):
    mod = MOD[pkg]
    iq = mod.InputQueue(backend=backend)
    for uri, x in records.items():
        iq.enqueue(uri, model="cnn", t=x)
    serving.start()
    try:
        return mod.OutputQueue(backend=backend).wait_all(list(records),
                                                         timeout=60)
    finally:
        serving.stop()


def _top3(probs):
    ids = np.argsort(probs)[::-1][:3]
    return ids, probs[ids]


def test_registry_sequence_matches_jax(saved, tmp_path):
    p1, p2 = saved
    records = _records()
    manifests, routed, results, served = {}, {}, {}, {}
    for pkg, mod in MOD.items():
        root = tmp_path / pkg
        registry = mod.ModelRegistry(root=str(root))
        backend = mod.InProcessStreamQueue()
        serving = mod.RoutedClusterServing(registry, helper=_helper(pkg),
                                           backend=backend)
        steps = []
        serving.deploy("cnn", path=p1)
        steps.append(_manifest(root))
        serving.deploy("cnn", path=p2, canary_weight=WEIGHT)
        steps.append(_manifest(root))
        results[pkg] = _serve(pkg, serving, backend, records)
        routed[pkg] = {u: registry.route("cnn", uri=u).version
                       for u in records}
        served[pkg] = {v: registry._models["cnn"][v].requests
                       for v in (1, 2)}
        registry.promote("cnn", 2)
        steps.append(_manifest(root))
        assert registry.rollback("cnn").version == 1
        steps.append(_manifest(root))
        registry.promote("cnn", 2)
        assert registry.undeploy("cnn", 1) == [1]
        steps.append(_manifest(root))
        manifests[pkg] = steps
        assert serving.pipeline_stats()["dead_letters"] == 0
    assert manifests["torch"] == manifests["jax"]
    final = manifests["torch"][-1]["models"]["cnn"]
    assert final["active"] == 2 and final["canary"] is None
    assert [v["version"] for v in final["versions"]] == [2]

    # the canary split: crc32 of the uri under the weight goes to v2
    want = {u: 2 if (zlib.crc32(u.encode()) % 10000) / 10000 < WEIGHT
            else 1 for u in records}
    assert routed["torch"] == routed["jax"] == want
    n2 = sum(v == 2 for v in want.values())
    assert served["torch"] == served["jax"] == {1: N_RECORDS - n2, 2: n2}
    assert 0 < n2 < N_RECORDS

    # each row equals its own version's direct predict, and JAX's row
    direct = {v: TIM().load(p).predict(np.stack(list(records.values())))
              for v, p in ((1, p1), (2, p2))}
    for i, uri in enumerate(records):
        ids, probs = _top3(direct[want[uri]][i])
        for pkg in MOD:
            row = np.asarray(results[pkg][uri])
            np.testing.assert_array_equal(row[:, 0], ids)
            np.testing.assert_allclose(row[:, 1], probs, rtol=0,
                                       atol=PROB_TOL)


def test_port_recovers_a_jax_manifest_with_its_canary(saved, tmp_path):
    p1, p2 = saved
    root = str(tmp_path / "reg")
    jreg = js.ModelRegistry(root=root)
    jreg.deploy("cnn", path=p1)
    jreg.deploy("cnn", path=p2, activate=False)
    jreg.set_canary("cnn", 2, weight=0.25)
    treg = ts.ModelRegistry(root=root).recover(load=True, save=False)
    assert treg.stats()["models"]["cnn"]["canary"] == \
        jreg.stats()["models"]["cnn"]["canary"]
    uris = [f"u-{i}" for i in range(200)]
    assert [treg.route("cnn", uri=u).version for u in uris] == \
        [jreg.route("cnn", uri=u).version for u in uris]
    assert {treg.route("cnn", uri=u).model.model.device.type
            for u in uris} == {"cpu"}


def test_unknown_model_is_dead_lettered_as_jax(saved):
    errors = {}
    for pkg, mod in MOD.items():
        registry = mod.ModelRegistry()
        backend = mod.InProcessStreamQueue()
        serving = mod.RoutedClusterServing(registry, helper=_helper(pkg),
                                           backend=backend)
        serving.deploy("cnn", path=saved[0])
        iq = mod.InputQueue(backend=backend)
        x = np.zeros(SHAPE, np.float32)
        iq.enqueue("lost", model="nope", t=x)
        iq.enqueue("found", model="cnn", t=x)
        serving.start()
        try:
            got = mod.OutputQueue(backend=backend).wait_all(
                ["lost", "found"], timeout=30)
        finally:
            serving.stop()
        assert isinstance(got["lost"], mod.ServingError)
        assert not isinstance(got["found"], mod.ServingError)
        errors[pkg] = (got["lost"].message, got["lost"].model,
                       serving.pipeline_stats()["dead_letters"])
    assert errors["torch"] == errors["jax"]


class _Boom(AbstractModel):
    def predict(self, inputs):
        raise RuntimeError("canary kaboom")


def test_a_failing_canary_rolls_back():
    registry = ts.ModelRegistry(canary_min_requests=5)
    backend = ts.InProcessStreamQueue()
    serving = ts.RoutedClusterServing(registry, helper=_helper("torch"),
                                      backend=backend)
    ok = ts.EchoStubModel(ms_per_batch=0.0)
    good, bad = TIM(), TIM()
    good._install(ok)
    bad._install(_Boom())
    serving.deploy("m", model=good, warmup=False)
    serving.deploy("m", model=bad, canary_weight=1.0, warmup=False)
    iq = ts.InputQueue(backend=backend)
    uris = [f"c-{i}" for i in range(20)]
    for u in uris:
        iq.enqueue(u, model="m", t=np.ones(SHAPE, np.float32))
    serving.start()
    try:
        got = ts.OutputQueue(backend=backend).wait_all(uris, timeout=30)
    finally:
        serving.stop()
    assert len(got) == len(uris)
    assert registry._canary.get("m") is None
    assert registry._models["m"][2].state == "failed"
    assert registry.route("m", uri="x").version == 1
    assert any(isinstance(v, ts.ServingError) for v in got.values())


def test_control_server_deploys_and_reports(saved, tmp_path):
    root = str(tmp_path / "reg")
    registry = ts.ModelRegistry(root=root)
    ctl = ts.RegistryControlServer(registry, root).start()
    try:
        resp = ts.control_request(root, "deploy", model="cnn",
                                  path=saved[0], timeout=60)
        assert resp == {"ok": True, "model": "cnn", "version": 1,
                        "state": "ready", "dtype": "f32"}
        resp = ts.control_request(root, "deploy", model="cnn",
                                  path=saved[1], canary_weight=0.3,
                                  timeout=60)
        assert resp["version"] == 2
        stats = ts.control_request(root, "stats", timeout=30)["stats"]
        assert stats["models"]["cnn"]["canary"]["weight"] == 0.3
        bad = ts.control_request(root, "frobnicate", timeout=30)
        assert bad == {"ok": False, "error": "unknown op 'frobnicate'"}
    finally:
        ctl.stop()


def test_int8_deploys_wait_for_the_quantised_backend(saved):
    """The quantised backend has arrived (ROADMAP A10): an int8 deploy
    loads through ``load_quantized`` and carries ``dtype="int8"``, a
    weight-only one here (no calibration.json in the directory)."""
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        QuantizedModel

    registry = ts.ModelRegistry()
    mv = registry.deploy("cnn", path=saved[0], quantize=True)
    assert mv.dtype == "int8"
    assert isinstance(mv.model.model, QuantizedModel)
    assert not mv.model.model.calibrated
    assert isinstance(TIM().load_quantized(saved[0]).model, QuantizedModel)
    assert registry.stats()["models"]["cnn"]["versions"][1]["dtype"] == \
        "int8"


# -- int8 versions (tests/test_quant_chains.py's serving tests, ported) ------

def _tiny_image_model(pkg):
    L, M = (jl, jm) if pkg == "jax" else (tl, tmodels)
    m = M.Sequential()
    m.add(L.Flatten(input_shape=(3, 8, 8)))
    m.add(L.Dense(5, activation="softmax", name="head"))
    m.compile("sgd", "sparse_categorical_crossentropy")
    return m


def test_serving_int8_version_routing(tmp_path):
    """An int8 deploy rides its own (model, version, dtype) dispatch key
    next to the f32 baseline, serves each record as its version's direct
    predict does, and the dtype and calibration survive manifest
    recovery (the int8 version reloads through ``load_quantized``); the
    JAX package's calibration.json and the int8 rows agree with JAX's."""
    from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        QuantizedModel

    jmodel = _tiny_image_model("jax")
    model_dir = tmp_path / "m"
    jmodel.save_model(str(model_dir))
    rng = np.random.default_rng(3)
    calib = [rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
             for _ in range(3)]
    jinf = JIM().load_keras_net(jmodel, calibration=calib)
    jinf.save_calibration(str(model_dir / TIM.CALIBRATION_FILE))

    root = str(tmp_path / "reg")
    registry = ts.ModelRegistry(root=root)
    backend = ts.InProcessStreamQueue()
    serving = ts.RoutedClusterServing(registry, helper=ts.ClusterServingHelper(
        config={"data": {"image_shape": "3, 8, 8"},
                "params": {"batch_size": 4, "top_n": 0}}), backend=backend)
    mv1 = serving.deploy("m", path=str(model_dir))
    mv2 = serving.deploy("m", path=str(model_dir), quantize=True)
    assert (mv1.dtype, mv2.dtype) == ("f32", "int8")
    assert isinstance(mv2.model.model, QuantizedModel)
    assert mv2.model.model.calibrated        # calibration.json picked up

    serving.start()
    x = rng.standard_normal((3, 8, 8)).astype(np.float32)
    in_q = ts.InputQueue(backend=backend)
    out_q = ts.OutputQueue(backend=backend)
    uris = []
    try:
        for i in range(6):       # explicit pins: both dtypes get traffic
            for v in (1, 2):
                uri = f"q-{v}-{i}"
                uris.append(uri)
                in_q.enqueue(uri, model="m", version=str(v), input=x)
        got = out_q.wait_all(uris, timeout=30.0)
    finally:
        serving.stop()
    assert len(got) == len(uris)
    direct = {v: mv.model.predict(x[None])[0] for v, mv in
              ((1, mv1), (2, mv2))}
    want_int8 = np.asarray(jinf.predict(x[None]))[0]
    np.testing.assert_allclose(direct[2], want_int8, rtol=0, atol=1e-6)
    for uri in uris:
        np.testing.assert_allclose(np.asarray(got[uri]),
                                   direct[int(uri.split("-")[1])],
                                   rtol=0, atol=PROB_TOL)
    keys = list(serving.bucket_counts)
    assert any(k.startswith("m:v1:") and k.endswith(":f32") for k in keys)
    assert any(k.startswith("m:v2:") and k.endswith(":int8") for k in keys)

    reg2 = ts.ModelRegistry(root=root).recover(load=True)
    r1, r2 = reg2._models["m"][1], reg2._models["m"][2]
    assert (r1.dtype, r2.dtype) == ("f32", "int8")
    assert isinstance(r2.model.model, QuantizedModel)
    assert r2.model.model.chains == mv2.model.model.chains
    np.testing.assert_array_equal(r2.model.predict(x[None])[0], direct[2])


def test_registry_stats_report_dtype():
    m = _tiny_image_model("torch")
    reg = ts.ModelRegistry()
    inf = TIM().load_keras_net(m, quantize=True)
    mv = reg.deploy("q", model=inf)
    assert mv.dtype == "int8"                # inferred from the model
    stats = reg.stats()["models"]["q"]["versions"][1]
    assert stats["dtype"] == "int8"
