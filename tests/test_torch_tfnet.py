"""The port's ``TFNet``, ``Net.load_tf``, ``InferenceModel.load_tf`` and
``export_tf`` against the JAX package on the CPU.

- TFNet end to end: the committed frozen graph (``tools/tf_fixtures``,
  written by TensorFlow) through ``TFNet.from_frozen`` against JAX's and
  against TensorFlow's committed rows; a tf.keras model saved as ``.h5``
  and as a SavedModel with variables through ``from_keras`` /
  ``from_saved_model``, translated and in the host callback
  (``lower=False``, input gradients from ``tf.GradientTape``), against
  JAX's. (The frozen tf.keras ResNet50 is held against JAX's in
  ``test_torch_tfpark_lowering.py``, beside the lowered keras models.)
- A TFNet layer under a Dense head trains step for step with JAX's
  (``Model.fit``), and saves and loads (the architecture by pickle,
  keeping the GraphDef bytes, as the JAX package saves it).
- ``export_tf``: the port's SavedModel of a model holding the same
  weights and moving statistics as a JAX model, and JAX's own
  ``export_tf`` (``jax2tf``), both loaded by ``tf.saved_model.load``:
  rows within 1e-5.
- Without TensorFlow (a subprocess where ``import tensorflow`` fails):
  the port's ``net`` package imports, ``TFNet.from_frozen`` of the fixture
  gives TensorFlow's rows, the port's own export reads back through
  ``InferenceModel.load_tf``, and ``from_keras`` raises naming
  TensorFlow.

Tolerances: float32 rows within 1e-5; ``fit`` losses within 1e-5 and
weights within 2e-5, as ``test_torch_training.py`` holds the native
models.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

tf = pytest.importorskip("tensorflow")

from analytics_zoo_tpu.common import nncontext as jnn  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras import layers as jl  # noqa
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels  # noqa
from analytics_zoo_tpu.pipeline.api.net import TFNet as JTFNet  # noqa
from analytics_zoo_tpu_torch.common import nncontext as tnn  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl  # noqa
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels  # noqa
from analytics_zoo_tpu_torch.pipeline.api.net import (  # noqa: E402
    Net, TFNet)
from analytics_zoo_tpu_torch.pipeline.inference import \
    InferenceModel  # noqa: E402
from analytics_zoo_tpu_torch.utils import load_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tools" / "tf_fixtures"
TOL = 1e-5
WEIGHT_TOL = 2e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                                     devices=jax.devices()[:1]))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _fixture():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    return (str(FIXTURES / manifest["graph"]),
            np.load(FIXTURES / "inputs.npy"), np.load(FIXTURES / "rows.npy"),
            manifest)


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    """A small tf.keras CNN (seeded) saved as .h5 and as a SavedModel with
    variables, its inputs and TensorFlow's rows."""
    root = tmp_path_factory.mktemp("keras")
    tf.keras.utils.set_random_seed(0)
    m = tf.keras.Sequential([
        tf.keras.layers.Input((8, 8, 3)),
        tf.keras.layers.Conv2D(4, 3, strides=2, padding="same",
                               activation="relu"),
        tf.keras.layers.BatchNormalization(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(3, activation="softmax")])
    h5 = str(root / "m.h5")
    m.save(h5)
    saved = str(root / "saved")
    tf.saved_model.save(m, saved)
    x = np.random.default_rng(1).standard_normal((4, 8, 8, 3)).astype(
        np.float32)
    return h5, saved, x, m(x).numpy()


def test_from_frozen_fixture_matches_jax_and_tensorflow():
    pb, x, rows, manifest = _fixture()
    net = TFNet.from_frozen(pb)
    jnet = JTFNet.from_frozen(pb)
    assert net.mode == "torch" and jnet.mode == "jax"
    assert net.graph_fn.input_names == jnet.graph_fn.input_names
    assert net.graph_fn.output_names == jnet.graph_fn.output_names
    assert set(net.graph_fn.ops) == set(manifest["ops"])
    got = net.predict(x)
    np.testing.assert_allclose(got, np.asarray(jnet.predict(x)), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, rows, rtol=TOL, atol=TOL)
    # the float Consts are the layer's parameters, under JAX's keys
    assert sorted(net.param_tree()) == sorted(jnet.build(None, None))
    assert Net.load_tf(pb).mode == "torch"
    im = InferenceModel().load_tf(pb, device="cpu")
    np.testing.assert_allclose(im.predict(x), rows, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["h5", "saved_model"])
def test_keras_and_saved_model_translate_as_jax(keras_files, route):
    h5, saved, x, ref = keras_files
    load = TFNet.from_keras if route == "h5" else TFNet.from_saved_model
    jload = JTFNet.from_keras if route == "h5" else \
        JTFNet.from_saved_model
    net, jnet = load(h5 if route == "h5" else saved), \
        jload(h5 if route == "h5" else saved)
    assert net.mode == "torch" and jnet.mode == "jax"
    got = net.predict(x)
    np.testing.assert_allclose(got, np.asarray(jnet.predict(x)), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # gradients with respect to the imported Consts and the input
    params = {k: v.detach().clone().requires_grad_()
              for k, v in net.param_tree().items()}
    xt = torch.from_numpy(x).requires_grad_()
    (out,) = net.graph_fn(params, xt)
    cot = np.random.default_rng(2).standard_normal(out.shape).astype(
        np.float32)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xt] + list(params.values()))
    jparams = {k: jnp.asarray(v) for k, v in jnet.build(None, None).items()}
    jgx, jgp = jax.grad(lambda xi, p: jnp.sum(
        jnet.graph_fn(p, xi)[0] * cot), argnums=(0, 1))(jnp.asarray(x),
                                                         jparams)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-4)
    for g, k in zip(grads[1:], params):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["h5", "saved_model"])
def test_host_callback_with_input_gradients_matches_jax(keras_files, route):
    h5, saved, x, ref = keras_files
    path = h5 if route == "h5" else saved
    net = TFNet.from_path(path, lower=False)
    jnet = JTFNet.from_path(path, lower=False)
    assert net.mode == jnet.mode == "callback"
    np.testing.assert_allclose(net.predict(x), ref, rtol=TOL, atol=TOL)
    xt = torch.from_numpy(x).requires_grad_()
    (net(xt) ** 2).sum().backward()
    jg = jax.grad(lambda q: jnp.sum(jnet.call({}, [q]) ** 2))(
        jnp.asarray(x))
    assert float(xt.grad.abs().sum()) > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


def test_unsupported_op_takes_the_callback_in_both_packages(tmp_path):
    """A graph with ``Einsum`` (outside both registries) raises
    ``UnsupportedTFGraph`` in translation, and ``TFNet`` runs it in the
    host callback in both packages."""
    v = tf.constant(np.random.default_rng(3).standard_normal((4, 4)).astype(
        np.float32))
    fn = tf.function(lambda x: tf.einsum("bi,ij->bj", x, v))
    concrete = fn.get_concrete_function(tf.TensorSpec((None, 4), tf.float32))
    pb = tmp_path / "einsum.pb"
    pb.write_bytes(concrete.graph.as_graph_def().SerializeToString())
    x = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    net, jnet = TFNet.from_frozen(str(pb)), JTFNet.from_frozen(str(pb))
    assert net.mode == jnet.mode == "callback"
    np.testing.assert_allclose(net.predict(x), np.asarray(jnet.predict(x)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(net.predict(x), x @ v.numpy(), rtol=TOL,
                               atol=TOL)


def _tfnet_models(pb, tb_dir):
    """The fixture graph as a TFNet under a Dense(3) head in both
    packages, the port's head holding JAX's weights; JAX's trainer logs
    every step's loss under ``tb_dir``."""
    jnet, net = JTFNet.from_frozen(pb), TFNet.from_frozen(pb)
    jnet.name = net.name = "tfnet"
    jin, tin = jl.Input(shape=(32, 32, 3)), tl.Input(shape=(32, 32, 3))
    jmodel = jmodels.Model(jin, jl.Dense(3, name="head")(jnet(jin)))
    tmodel = tmodels.Model(tin, tl.Dense(3, name="head")(net(tin)))
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jmodel.set_tensorboard(tb_dir, "jax")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    return jmodel, tmodel


def test_tfnet_layer_fits_step_for_step_with_jax(tmp_path):
    pb, x, _, _ = _fixture()
    jmodel, tmodel = _tfnet_models(pb, str(tmp_path))
    y = np.random.default_rng(6).integers(0, 3, len(x)).astype(np.int32)
    jmodel.fit(x, y, batch_size=4, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tmodel.fit(x, y, batch_size=4, nb_epoch=2)
    assert len(jlosses) == len(tmodel.trainer.step_losses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=TOL, atol=TOL)
    jparams = jax.tree.map(np.asarray, jmodel.get_params())
    tparams = tmodel.get_params()
    for layer in ("tfnet", "head"):
        for k, w in jparams[layer].items():
            np.testing.assert_allclose(tparams[layer][k].detach().numpy(),
                                       w, rtol=WEIGHT_TOL, atol=WEIGHT_TOL)
    # a model holding a TFNet saves its architecture by pickle (the
    # GraphDef bytes kept) and loads back with its trained weights
    path = str(tmp_path / "saved")
    tmodel.save_model(path)
    assert os.path.exists(os.path.join(path, "architecture.pkl"))
    again = tmodels.Model.load_model(path)
    np.testing.assert_allclose(again.predict(x, batch_size=4),
                               tmodel.predict(x, batch_size=4), rtol=0,
                               atol=0)


def _export_pair():
    """A NCHW CNN in both packages with the port's initial weights and
    seeded moving statistics (JAX's through ``_built_params``)."""
    def build(L, M):
        m = M.Sequential()
        m.add(L.Convolution2D(4, 3, 3, activation="relu",
                              border_mode="same", subsample=(2, 2),
                              input_shape=(3, 9, 9)))
        m.add(L.BatchNormalization())
        m.add(L.ZeroPadding2D((1, 1)))
        m.add(L.MaxPooling2D((2, 2), border_mode="same"))
        m.add(L.AveragePooling2D((2, 2), strides=(1, 1),
                                 border_mode="same"))
        m.add(L.Convolution2D(3, 1, 1, dim_ordering="th"))
        m.add(L.Flatten())
        m.add(L.Dropout(0.3))
        m.add(L.Dense(5, activation="softmax"))
        return m

    jm, tm = build(jl, jmodels), build(tl, tmodels)
    pairs = list(zip(jm.graph_function().layers, tm.graph_function().layers))
    params = {j.name: {k: v.detach().numpy().copy()
                       for k, v in t.param_tree().items()}
              for j, t in pairs if t.param_tree()}
    rs = np.random.default_rng(8)
    state = {j.name: {"moving_mean": rs.normal(0, 0.2, 4).astype(
        np.float32), "moving_var": rs.uniform(0.5, 2, 4).astype(np.float32)}
        for j, t in pairs if t.state_tree()}
    load_jax_params(tm, params, state=state)
    jm.compile(optimizer="sgd", loss="mse")
    jm._built_params = (params, state)
    return jm, tm


def test_export_tf_rows_in_tensorflow_match_jax_export(tmp_path):
    jm, tm = _export_pair()
    x = np.random.default_rng(9).standard_normal((4, 3, 9, 9)).astype(
        np.float32)
    tm.export_tf(str(tmp_path / "port"))
    jm.export_tf(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["saved_model.pb",
                                                    "variables"]
    rows = {}
    for which in ("port", "jax"):
        sig = tf.saved_model.load(str(tmp_path / which)).signatures[
            "serving_default"]
        rows[which] = list(sig(tf.constant(x)).values())[0].numpy()
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tm.predict(x, batch_size=4), rows["port"],
                               rtol=TOL, atol=TOL)
    back = TFNet.from_saved_model(str(tmp_path / "port"))
    assert back.mode == "torch" and "Transpose" in back.graph_fn.ops
    np.testing.assert_allclose(back.predict(x), rows["port"], rtol=TOL,
                               atol=TOL)


def test_export_tf_names_a_layer_it_cannot_write(tmp_path):
    m = tmodels.Sequential()
    m.add(tl.LSTM(4, input_shape=(3, 2)))
    with pytest.raises(NotImplementedError, match="LSTM"):
        m.export_tf(str(tmp_path / "lstm"))


_NO_TF = r"""
import sys
sys.modules["tensorflow"] = None
import numpy as np
import analytics_zoo_tpu_torch.pipeline.api.net as net
from analytics_zoo_tpu_torch.common import nncontext
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
nncontext.init_nncontext(device="cpu")
pb, saved, keras = sys.argv[1:4]
x = np.load(sys.argv[4]); rows = np.load(sys.argv[5])
tfnet = net.TFNet.from_frozen(pb)
assert tfnet.mode == "torch"
assert np.abs(tfnet.predict(x) - rows).max() <= 1e-5
im = InferenceModel().load_tf(saved, device="cpu")
assert im.predict(np.load(sys.argv[6])).shape == (2, 5)
try:
    net.Net.load_keras(keras)
except ImportError as e:
    assert "TensorFlow" in str(e), e
else:
    raise AssertionError("from_keras ran without TensorFlow")
assert sys.modules["tensorflow"] is None
print("ok")
"""


def test_without_tensorflow_frozen_and_exported_graphs_load(tmp_path,
                                                            keras_files):
    pb, x, rows, _ = _fixture()
    _, tm = _export_pair()
    tm.export_tf(str(tmp_path / "port"))
    xe = np.random.default_rng(10).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    np.save(tmp_path / "xe.npy", xe)
    res = subprocess.run(
        [sys.executable, "-c", _NO_TF, pb, str(tmp_path / "port"),
         keras_files[0], str(FIXTURES / "inputs.npy"),
         str(FIXTURES / "rows.npy"), str(tmp_path / "xe.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr
