"""The port's ``QuantizedModel`` and the ``InferenceModel`` int8 surface
against the JAX package on the CPU, and the JAX package's int8 tests
(``tests/test_quant_chains.py``, ``test_inference_model.py``'s
``test_quantized_model_close_to_float``) ported.

Each model is built in both packages with the same layer names and the
JAX weights (and BatchNorm statistics) copied into the port with
``load_jax_params``; calibration batches and inputs come from numpy
seeds. Tolerances, float32:

- the port's own calibration scales within 1e-6 relative of JAX's (the
  max-abs of float32 activations computed in another order);
- ``chains`` equal;
- loaded with JAX's exported scales, the port's int8 outputs within
  1e-6 of JAX's (of the largest output): the int8 activations and int32
  accumulators are equal, the float epilogues and softmax round in
  another order;
- weight-only outputs within 1e-6 likewise;
- ResNet-50 is held at 1e-6 with BatchNorm the identity (unit
  statistics); with seeded statistics within 1e-2 (``SEEDED_RESNET_TOL``:
  the two packages' float BatchNorms between int8 convolutions round
  differently, which can flip an int8 step at a rounding tie).
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.models.image.imageclassification import \
    image_classifier as jic
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    image_classifier as tic
from analytics_zoo_tpu_torch.ops import quant
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import base as tbase
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    QuantizedModel
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils.op_census import OpCensus

SCALE_RTOL = 1e-6
OUT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


# -- the models, built the same way in both packages ----------------------

def _chained_cnn(L, Seq):
    """``tests/test_quant_chains.py``'s chained CNN."""
    m = Seq()
    m.add(L.Convolution2D(8, 3, 3, activation="relu", border_mode="same",
                          input_shape=(3, 16, 16), name="c1"))
    m.add(L.MaxPooling2D(pool_size=(2, 2), name="mp"))
    m.add(L.Convolution2D(8, 3, 3, activation="relu", name="c2"))
    m.add(L.Flatten(name="fl"))
    m.add(L.Dropout(0.2, name="dr"))
    m.add(L.Dense(16, activation="relu", name="d1"))
    m.add(L.Dense(4, activation="relu", name="out"))
    return m


def _fanout(L, M):
    """``tests/test_quant_chains.py``'s fan-out graph."""
    inp = L.Input(shape=(8,))
    h = L.Dense(16, activation="relu", name="fan_d1")(inp)
    a = L.Dense(8, activation="relu", name="fan_a")(h)
    b = L.Dense(8, activation="relu", name="fan_b")(h)
    out = L.Dense(2, name="fan_out")(L.merge([a, b], mode="concat"))
    return M(inp, out)


def _bench_mlp(L, Seq):
    """``bench.py``'s ``bench_quant`` MLP, 512-1024-1024-128."""
    m = Seq()
    m.add(L.Dense(1024, activation="relu", input_shape=(512,), name="qd1"))
    m.add(L.Dense(1024, activation="relu", name="qd2"))
    m.add(L.Dense(128, activation="relu", name="qout"))
    return m


def _bench_cnn(L, Seq):
    """``bench.py``'s ``bench_quant`` CNN on 3 x 64 x 64."""
    m = Seq()
    m.add(L.Convolution2D(32, 3, 3, activation="relu", border_mode="same",
                          input_shape=(3, 64, 64), name="qc1"))
    m.add(L.Convolution2D(32, 3, 3, activation="relu", subsample=(2, 2),
                          name="qc2"))
    m.add(L.Flatten(name="qfl"))
    m.add(L.Dense(64, activation="relu", name="qcd1"))
    m.add(L.Dense(10, activation="relu", name="qcout"))
    return m


def _relu_layer_cnn(L, Seq):
    """A relu ``Activation`` layer and a max pooling between two kernels:
    int8 flows through both."""
    m = Seq()
    m.add(L.Convolution2D(6, 3, 3, input_shape=(2, 10, 10), name="rc1"))
    m.add(L.Activation("relu", name="rrelu"))
    m.add(L.MaxPooling2D((2, 2), border_mode="same", name="rmp"))
    m.add(L.Flatten(name="rfl"))
    m.add(L.Dense(5, activation="softmax", name="rout"))
    return m


GRAPHS = {   # case -> (builder, package args, input shape, chains)
    "chained_cnn": (_chained_cnn, "seq", (3, 16, 16),
                    [("c1", "c2"), ("c2", "d1"), ("d1", "out")]),
    "fanout": (_fanout, "model", (8,), []),
    "relu_layer": (_relu_layer_cnn, "seq", (2, 10, 10), [("rc1", "rout")]),
    "bench_mlp": (_bench_mlp, "seq", (512,),
                  [("qd1", "qd2"), ("qd2", "qout")]),
    "bench_cnn": (_bench_cnn, "seq", (3, 64, 64),
                  [("qc1", "qc2"), ("qc2", "qcd1"), ("qcd1", "qcout")]),
}


def _graph_pair(case):
    build, kind, shape, chains = GRAPHS[case]
    jm = build(jl, JSequential if kind == "seq" else JModel)
    tm = build(tl, Sequential if kind == "seq" else Model)
    jm.compile(optimizer="sgd", loss="mse")
    tm.compile(optimizer="sgd", loss="mse")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))
    return jm, tm, shape, chains


#: moving variance whose sum with BatchNormalization's epsilon (1e-3) is
#: 1.0 in float32: with a zero mean, gamma 1 and beta 0 the inference
#: BatchNorm is then the identity in both packages, bit for bit
UNIT_VAR = np.float32(1.0) - np.float32(1e-3)


def _image_pair(name, shape, class_num=10, statistics="seeded"):
    """ImageClassifier ``name`` in both packages with the same layer names
    (fresh name counters), the port's weights and moving statistics in
    both: seeded, or "unit" (BatchNorm the identity, see ``UNIT_VAR``)."""
    jbase._name_counters.clear()
    tbase._name_counters.clear()
    jclf = jic.ImageClassifier(class_num=class_num, model_name=name,
                               input_shape=shape)
    tclf = tic.ImageClassifier(class_num=class_num, model_name=name,
                               input_shape=shape)
    rs = np.random.default_rng(11)
    pairs = list(zip(jclf.model.graph_function().layers,
                     tclf.model.graph_function().layers))
    assert all(j.name == t.name for j, t in pairs)
    params = {t.name: {k: v.detach().numpy().copy()
                       for k, v in t.param_tree().items()}
              for _, t in pairs if t.param_tree()}
    assert UNIT_VAR + np.float32(1e-3) == np.float32(1.0)

    def stat(k, shape):
        if statistics == "unit":
            return np.full(shape, 0.0 if "mean" in k else UNIT_VAR,
                           np.float32)
        return (rs.uniform(-0.2, 0.2, shape) if "mean" in k
                else rs.uniform(0.5, 1.5, shape)).astype(np.float32)

    state = {t.name: {k: stat(k, v.shape) for k, v in
                      t.state_tree().items()}
             for _, t in pairs if t.state_tree()}
    jclf.model._built_params = (params, state)
    load_jax_params(tclf.model, params, state=state)
    return jclf.model, tclf.model, shape, None


def _calib(shape, seed=0, n=3, batch=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch,) + shape).astype(np.float32)
            for _ in range(n)]


def _held(jm, tm, shape, chains, x_rows=3):
    """Calibrate both, hold scales, chains and outputs; returns the
    port's calibrated InferenceModel."""
    calib = _calib(shape)
    jinf = JIM().load_keras_net(jm, calibration=calib)
    tinf = InferenceModel().load_keras_net(tm, calibration=calib)
    jscales = jinf.model.export_calibration()
    tscales = tinf.model.export_calibration()
    assert set(tscales) == set(jscales)
    for k, v in jscales.items():
        assert tscales[k] == pytest.approx(v, rel=SCALE_RTOL), k
    assert tinf.model.chains == jinf.model.chains
    if chains is not None:
        assert tinf.model.chains == chains

    x = np.random.default_rng(1).standard_normal(
        (x_rows,) + shape).astype(np.float32)
    want = np.asarray(jinf.predict(x))
    on_jax_scales = InferenceModel().load_keras_net(tm, scales=jscales)
    assert on_jax_scales.model.chains == jinf.model.chains
    got = on_jax_scales.predict(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())

    jw = np.asarray(JIM().load_keras_net(jm, quantize=True).predict(x))
    tw = InferenceModel().load_keras_net(tm, quantize=True).predict(x)
    np.testing.assert_allclose(tw, jw, rtol=0,
                               atol=OUT_TOL * np.abs(jw).max())
    return tinf


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_quantized_graphs_match_jax(case):
    _held(*_graph_pair(case))


@pytest.mark.parametrize("name,shape,statistics", [
    ("vgg-16", (3, 32, 32), None), ("vgg-16", (3, 64, 64), None),
    ("resnet-50", (3, 32, 32), "unit"), ("resnet-50", (3, 64, 64), "unit")])
def test_quantized_image_classifiers_match_jax(name, shape, statistics):
    """VGG-16 (15 chains) and ResNet-50 (54 kernels, no chain: BatchNorm
    follows every convolution). ResNet-50's BatchNorms run in float
    between its int8 convolutions, and the two packages' BatchNorms
    round differently (1/sqrt against XLA's rsqrt, other orders): an ulp
    near a rounding tie of the next quantize flips one int8 step, which
    the random-weight network carries to its output. With unit
    statistics BatchNorm is the identity on both sides, so the int8
    path is held at 1e-6 over ResNet-50's whole topology;
    ``test_resnet_with_seeded_statistics_stays_close`` holds seeded ones."""
    tinf = _held(*_image_pair(name, shape, statistics=statistics),
                 x_rows=2)
    qm = tinf.model
    n_kernels = len(qm.kernels)
    if name == "vgg-16":
        # every conv and the first two Dense layers requantize for the
        # next kernel
        assert (n_kernels, len(qm.chains)) == (16, 15)
    else:
        assert (n_kernels, qm.chains) == (54, [])


#: ResNet-50 with seeded BatchNorm statistics, the port's int8 output
#: against JAX's from the same scales: an int8 step flipped at a rounding
#: tie of one quantize (see above) moved a probability by 2.1e-3 at 3 x 64
#: x 64 in the first reading; rows with no flip agree within 1e-6
SEEDED_RESNET_TOL = 1e-2


def test_resnet_with_seeded_statistics_stays_close():
    jm, tm, shape, _ = _image_pair("resnet-50", (3, 64, 64))
    calib = _calib(shape)
    jinf = JIM().load_keras_net(jm, calibration=calib)
    jscales = jinf.model.export_calibration()
    tinf = InferenceModel().load_keras_net(tm, calibration=calib)
    for k, v in jscales.items():
        assert tinf.model.export_calibration()[k] == pytest.approx(
            v, rel=SCALE_RTOL), k
    x = np.random.default_rng(1).standard_normal(
        (2,) + shape).astype(np.float32)
    want = np.asarray(jinf.predict(x))
    got = InferenceModel().load_keras_net(tm, scales=jscales).predict(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=SEEDED_RESNET_TOL)


# -- tests/test_quant_chains.py, ported --------------------------------------

def _calibrated(m, shape, n=3, seed=0):
    return InferenceModel().load_keras_net(m, calibration=_calib(
        shape, seed, n))


def test_cnn_chain_plan_and_int8_exchange():
    """Chains thread conv->pool->conv->flatten->dropout->dense->dense;
    the forward runs one int32-accumulating product per kernel, one
    rounding per chain edge plus the entry quantize, and exactly one
    division."""
    m = _chained_cnn(tl, Sequential)
    m.compile(optimizer="sgd", loss="mse")
    inf = _calibrated(m, (3, 16, 16))
    qm = inf.model
    assert qm.chains == [("c1", "c2"), ("c2", "d1"), ("d1", "out")]
    x = np.random.default_rng(1).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    with OpCensus() as census:
        got = inf.predict(x)
    s = census.int8_summary()
    assert s["int32_products"] == 4 and s["float_products"] == 0, s
    assert s["roundings"] == len(qm.chains) + 1, s
    assert s["divisions"] == 1, s
    ref = InferenceModel().load_keras_net(m).predict(x)
    denom = float(np.mean(np.abs(ref))) or 1.0
    assert float(np.mean(np.abs(got - ref))) / denom < 0.5


def test_fanout_stops_chain():
    m = _fanout(tl, Model)
    m.compile(optimizer="sgd", loss="mse")
    qm = _calibrated(m, (8,)).model
    starts = {src for src, _ in qm.chains}
    assert not starts & {"fan_d1", "fan_a", "fan_b"}
    k = qm.kernels["['fan_d1']['kernel']"]
    assert isinstance(k, quant.QuantTensor) and k.requant is None


def test_chain_parity_accuracy_gate():
    """<0.1% absolute accuracy drop against float32 on a classifier the
    chains fully cover (the reference's OpenVINO-int8 acceptance bar)."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((3, 8)) * 3.0
    ytr = rng.integers(0, 3, 600).astype(np.int32)
    xtr = (centers[ytr] + rng.standard_normal((600, 8))).astype(np.float32)
    yte = rng.integers(0, 3, 300).astype(np.int32)
    xte = (centers[yte] + rng.standard_normal((300, 8))).astype(np.float32)

    m = Sequential(seed=7)
    m.add(tl.Dense(32, activation="relu", input_shape=(8,), name="g1"))
    m.add(tl.Dense(32, activation="relu", name="g2"))
    m.add(tl.Dense(3, activation="softmax", name="gout"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    m.fit(xtr, ytr, batch_size=64, nb_epoch=12)
    f32_acc = np.mean(np.argmax(m.predict(xte, batch_size=300), 1) == yte)
    assert f32_acc > 0.9, f"golden model underfit: {f32_acc}"

    inf = InferenceModel()
    inf.load_keras_net(m, calibration=[xtr[i:i + 64]
                                       for i in range(0, 256, 64)])
    assert inf.model.chains == [("g1", "g2"), ("g2", "gout")]
    int8_acc = np.mean(np.argmax(inf.predict(xte), 1) == yte)
    assert f32_acc - int8_acc <= 0.001, (f32_acc, int8_acc)


def test_calibration_round_trip_file(tmp_path):
    """calibrate -> save_calibration -> load_quantized (the directory's
    calibration.json found by itself, or a path) re-plans the same
    chains with no replay and reproduces predictions bit for bit."""
    m = _chained_cnn(tl, Sequential)
    m.compile(optimizer="sgd", loss="mse")
    inf = _calibrated(m, (3, 16, 16))
    x = np.random.default_rng(2).standard_normal(
        (4, 3, 16, 16)).astype(np.float32)
    want = inf.predict(x)
    chains = list(inf.model.chains)

    model_dir = tmp_path / "saved"
    m.save_model(str(model_dir))
    inf.save_calibration(str(model_dir / InferenceModel.CALIBRATION_FILE))
    inf2 = InferenceModel().load_quantized(str(model_dir))
    assert inf2.model.calibrated and inf2.model.chains == chains
    np.testing.assert_array_equal(inf2.predict(x), want)

    side = tmp_path / "scales.json"
    side.write_text(json.dumps(inf.model.export_calibration()))
    inf3 = InferenceModel().do_load_openvino(str(model_dir),
                                             calibration_path=str(side))
    np.testing.assert_array_equal(inf3.predict(x), want)
    inf4 = InferenceModel().load_keras_net(m, quantize=True)
    assert not inf4.model.calibrated
    inf4.load_calibration(str(side))
    assert inf4.model.chains == chains
    np.testing.assert_array_equal(inf4.predict(x), want)
    with pytest.raises(RuntimeError, match="calibrated"):
        InferenceModel().load_keras_net(m, quantize=True).save_calibration(
            str(tmp_path / "none.json"))
    with pytest.raises(RuntimeError, match="quantized"):
        InferenceModel().load_keras_net(m).calibrate([x])


def test_jax_calibration_file_loads_in_the_port(tmp_path):
    """The calibration keys are the JAX param paths: a model saved and
    calibrated by the JAX package loads as int8 in the port with the
    same chains and outputs."""
    jm = _chained_cnn(jl, JSequential)
    jm.compile(optimizer="sgd", loss="mse")
    jinf = JIM().load_keras_net(jm, calibration=_calib((3, 16, 16)))
    jm.save_model(str(tmp_path / "m"))
    jinf.save_calibration(str(tmp_path / "m" / "calibration.json"))
    tinf = InferenceModel().load_quantized(str(tmp_path / "m"))
    assert tinf.model.chains == jinf.model.chains
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jinf.predict(x))
    np.testing.assert_allclose(tinf.predict(x), want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())


def test_the_callers_model_is_left_as_it_was():
    """The float model and its int8 version side by side: quantizing and
    calibrating swap none of the caller's parameters, and its float
    predictions do not move."""
    m = _chained_cnn(tl, Sequential)
    m.compile(optimizer="sgd", loss="mse")
    x = np.random.default_rng(4).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    f32 = InferenceModel().load_keras_net(m)
    before = f32.predict(x)
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    q = _calibrated(m, (3, 16, 16))
    q.predict(x)
    for n, p in m.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(),
                                                        params[n]), n
    np.testing.assert_array_equal(f32.predict(x), before)
    sizes = q.model.param_bytes()
    assert sizes["int8"] < sizes["float32"] / 3


def test_quantized_kernels_of_other_layers_are_dequantized():
    """A kernel leaf of a layer that does not route through the op (an
    Embedding's table here is not one; a LSTM's ``W`` is) reaches it
    dequantized, as in the JAX package."""
    jm, tm = JSequential(), Sequential()
    for L, m in ((jl, jm), (tl, tm)):
        m.add(L.LSTM(6, input_shape=(5, 4), name="rnn"))
        m.add(L.Dense(3, name="head"))
        m.compile(optimizer="sgd", loss="mse")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))
    x = np.random.default_rng(5).standard_normal((2, 5, 4)).astype(
        np.float32)
    tq = InferenceModel().load_keras_net(tm, quantize=True)
    assert "['rnn']['W']" in tq.model.kernels
    want = np.asarray(JIM().load_keras_net(jm, quantize=True).predict(x))
    np.testing.assert_allclose(tq.predict(x), want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())
    for n, p in tm.named_parameters():   # the swap was for the call only
        assert p.dtype == torch.float32, n


# -- test_inference_model.py::test_quantized_model_close_to_float ------------

def test_quantized_model_close_to_float():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 10)).astype(np.float32)
    y = (x[:, :1] > 0).astype(np.int32).reshape(-1)
    model = Sequential(seed=0)
    model.add(tl.Dense(16, activation="relu", input_shape=(10,)))
    model.add(tl.Dense(2, activation="softmax"))
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    model.fit(x, y, batch_size=16, nb_epoch=3)
    inf = InferenceModel()
    inf.load_keras_net(model, quantize=True)
    assert isinstance(inf.model, QuantizedModel)
    q = inf.predict(x[:16])
    f = model.predict(x[:16])
    assert np.mean(np.abs(q - f)) < 0.05
    kernels = list(inf.model.kernels.values())
    assert kernels and all(k.q.dtype == torch.int8 for k in kernels)
