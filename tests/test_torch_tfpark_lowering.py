"""The port's tfpark lowering bridge (``lower_tf_callable``,
``lower_keras_model``, ``LoweredTF``) and what stands on it
(``KerasModel``, ``TFOptimizer``, ``TFEstimator``) against the JAX
package on the CPU, mirroring ``tests/test_tfpark.py``.

Both packages lower the same TensorFlow objects: two tf.keras models (or
tf.Variables) built from one seed, so they start equal. Each trains
through its own engine, step for step on the same batches (one device on
the JAX side); the per-step losses agree within 1e-5 and the weights each
writes back into its TensorFlow variables within 1e-4. Predictions
within 1e-5. Variables whose ``trainable`` is False (a BatchNorm's moving
statistics) stay baked in both.

``tf.keras.applications.ResNet50(weights=None, input_shape=(64, 64, 3),
classes=10)``, frozen, goes through both packages' ``TFGraphFunction``:
rows within 1e-4 (53 convolutions summed in other orders).
"""

import os

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

tf = pytest.importorskip("tensorflow")

from analytics_zoo_tpu import tfpark as jtfpark  # noqa: E402
from analytics_zoo_tpu.common import nncontext as jnn  # noqa: E402
from analytics_zoo_tpu.common.zoo_trigger import \
    MaxEpoch as JMaxEpoch  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras import \
    optimizers as jopt  # noqa: E402
from analytics_zoo_tpu.pipeline.api.net.tf_graph import \
    TFGraphFunction as JGraph  # noqa: E402
from analytics_zoo_tpu_torch import tfpark  # noqa: E402
from analytics_zoo_tpu_torch.common import nncontext as tnn  # noqa: E402
from analytics_zoo_tpu_torch.common.zoo_trigger import MaxEpoch  # noqa
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    optimizers as topt  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.net import \
    TFGraphFunction  # noqa: E402

RESNET_TOL = 1e-4
LOSS_TOL = 1e-5
WEIGHT_TOL = 1e-4
TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                                     devices=jax.devices()[:1]))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _keras_mlp(seed=0, classes=2, dim=6, bn=False):
    tf.keras.utils.set_random_seed(seed)
    layers = [tf.keras.layers.Input((dim,)),
              tf.keras.layers.Dense(16, activation="relu")]
    if bn:
        layers.append(tf.keras.layers.BatchNormalization())
    layers.append(tf.keras.layers.Dense(classes, activation="softmax"))
    m = tf.keras.Sequential(layers)
    m.compile(optimizer=tf.keras.optimizers.Adam(1e-2),
              loss="sparse_categorical_crossentropy")
    return m


def _toy_data(n=128, dim=6, classes=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    w = rng.standard_normal((dim, classes))
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _jax_losses(zoo_model):
    return [v for _, _, _, v in zoo_model.get_train_summary("Loss")]


def _same_weights(tf_a, tf_b):
    wa, wb = tf_a.get_weights(), tf_b.get_weights()
    assert len(wa) == len(wb) > 0
    for a, b in zip(wa, wb):
        np.testing.assert_allclose(a, b, rtol=WEIGHT_TOL, atol=WEIGHT_TOL)


def test_lowered_keras_model_matches_jax_and_tensorflow():
    m = _keras_mlp(bn=True)
    x, _ = _toy_data(16)
    low, jlow = tfpark.lower_keras_model(m), jtfpark.lower_keras_model(m)
    assert sorted(low.graph_fn.param_names) == \
        sorted(jlow.graph_fn.param_names)
    # the BatchNorm's moving statistics are captures, not parameters
    assert len(low.graph_fn.param_names) == len(m.trainable_variables)
    (got,) = low(low.init_params(), torch.from_numpy(x))
    (want,) = jlow(jlow.init_params(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.detach().numpy(), m(x).numpy(),
                               rtol=TOL, atol=TOL)


def test_keras_model_fit_steps_with_jax_and_writes_back(tmp_path):
    m_j, m_t = _keras_mlp(seed=1), _keras_mlp(seed=1)
    _same_weights(m_j, m_t)
    x, y = _toy_data(128, seed=1)
    jk, tk = jtfpark.KerasModel(m_j), tfpark.KerasModel(m_t)
    np.testing.assert_allclose(tk.predict(x, batch_per_thread=32),
                               np.asarray(jk.predict(x, batch_per_thread=32)),
                               rtol=TOL, atol=TOL)
    jk._zoo_model.trainer = None
    jk._zoo_model.set_tensorboard(str(tmp_path), "jax")
    jk.fit(x, y, batch_size=32, epochs=2)
    tk.fit(x, y, batch_size=32, epochs=2)
    jl = _jax_losses(jk._zoo_model)
    assert len(jl) == len(tk._zoo_model.trainer.step_losses) == 8
    np.testing.assert_allclose(tk._zoo_model.trainer.step_losses, jl,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    # write-back: each live tf.keras model holds its engine's weights
    _same_weights(m_j, m_t)
    np.testing.assert_allclose(tk.predict(x), m_t(x).numpy(), rtol=TOL,
                               atol=TOL)
    ev = tk.evaluate(x, y, batch_per_thread=32)
    jev = jk.evaluate(x, y, batch_per_thread=32)
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=1e-5)


def test_keras_model_tfdataset_path_matches_jax():
    m_j, m_t = _keras_mlp(seed=2), _keras_mlp(seed=2)
    x, y = _toy_data(128, seed=2)
    jk, tk = jtfpark.KerasModel(m_j), tfpark.KerasModel(m_t)
    jk.fit(jtfpark.TFDataset.from_ndarrays((x, y), batch_size=32), epochs=2)
    tk.fit(tfpark.TFDataset.from_ndarrays((x, y), batch_size=32), epochs=2)
    _same_weights(m_j, m_t)


def test_tf_optimizer_from_loss_steps_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 4)).astype(np.float32)
    y = x @ np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    w_j = tf.Variable(np.full((4, 1), 0.1, np.float32), name="w")
    w_t = tf.Variable(np.full((4, 1), 0.1, np.float32), name="w")

    def loss_of(w):
        return lambda a, b: tf.reduce_mean(tf.square(tf.matmul(a, w) - b))

    jo = jtfpark.TFOptimizer.from_loss(
        loss_of(w_j), jtfpark.TFDataset.from_ndarrays((x, y), batch_size=32),
        variables=[w_j], optim_method=jopt.Adam(lr=0.1))
    to = tfpark.TFOptimizer.from_loss(
        loss_of(w_t), tfpark.TFDataset.from_ndarrays((x, y), batch_size=32),
        variables=[w_t], optim_method=topt.Adam(lr=0.1))
    jo._ensure_model().set_tensorboard(str(tmp_path), "jax")
    jo.optimize(end_trigger=JMaxEpoch(3))
    to.optimize(end_trigger=MaxEpoch(3))
    jl = _jax_losses(jo._zoo_model)
    assert len(jl) == len(to._zoo_model.trainer.step_losses) == 12
    np.testing.assert_allclose(to._zoo_model.trainer.step_losses, jl,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(w_t.numpy(), w_j.numpy(), rtol=WEIGHT_TOL,
                               atol=WEIGHT_TOL)
    assert not np.allclose(w_t.numpy(), 0.1)


def test_tf_optimizer_from_keras_matches_jax():
    m_j, m_t = _keras_mlp(seed=3), _keras_mlp(seed=3)
    x, y = _toy_data(128, seed=3)
    jtfpark.TFOptimizer.from_keras(
        m_j, jtfpark.TFDataset.from_ndarrays((x, y), batch_size=32)
    ).optimize()
    tfpark.TFOptimizer.from_keras(
        m_t, tfpark.TFDataset.from_ndarrays((x, y), batch_size=32)
    ).optimize()
    _same_weights(m_j, m_t)


def _model_fn(w0):
    def model_fn(features, labels, mode, params):
        logits = tf.keras.layers.Dense(
            2, name="head",
            kernel_initializer=tf.keras.initializers.Constant(w0))(features)
        preds = tf.nn.softmax(logits)
        loss = tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=tf.cast(labels, tf.int32), logits=logits))
        return tfpark.TFEstimatorSpec(mode, predictions=preds, loss=loss)
    return model_fn


def test_tf_estimator_train_evaluate_predict_match_jax(tmp_path):
    x, y = _toy_data(128, dim=6, seed=4)
    w0 = np.random.default_rng(4).normal(0, 0.3, (6, 2)).astype(np.float32)
    jest = jtfpark.TFEstimator(_model_fn(w0), optimizer="adam")
    est = tfpark.TFEstimator(_model_fn(w0), optimizer="adam")
    jds = jtfpark.TFDataset.from_ndarrays((x, y), batch_size=32)
    ds = tfpark.TFDataset.from_ndarrays((x, y), batch_size=32)
    jest._trace(jds)
    jest._zoo.set_tensorboard(str(tmp_path), "jax")
    before = est.evaluate(ds)["loss"]
    np.testing.assert_allclose(before, jest.evaluate(jds)["loss"],
                               rtol=1e-5)
    jest.train(jds, end_trigger=JMaxEpoch(3))
    est.train(ds, end_trigger=MaxEpoch(3))
    jl = _jax_losses(jest._zoo)
    assert len(jl) == len(est._zoo.trainer.step_losses) == 12
    np.testing.assert_allclose(est._zoo.trainer.step_losses, jl,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    after = est.evaluate(ds)["loss"]
    assert after < before
    np.testing.assert_allclose(after, jest.evaluate(jds)["loss"], rtol=1e-5)
    preds = est.predict(ds)
    assert preds.shape == (128, 2)
    np.testing.assert_allclose(preds, jest.predict(jds), rtol=1e-5,
                               atol=1e-5)
    # the trained values were written back into the traced variables
    (kernel,) = [v for k, v in est._lowered.var_map.items()
                 if v is not None and "kernel" in v.name]
    np.testing.assert_allclose(
        kernel.numpy(), est._tfnet.param_tree()[next(
            k for k, v in est._lowered.var_map.items() if v is kernel)]
        .detach().numpy())
    assert sorted(tfpark.ModeKeys.__dict__) == sorted(
        jtfpark.ModeKeys.__dict__)


def test_keras_resnet50_frozen_matches_jax():
    tf.keras.utils.set_random_seed(0)
    m = tf.keras.applications.ResNet50(weights=None, input_shape=(64, 64, 3),
                                       classes=10)
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2
    frozen = convert_variables_to_constants_v2(tf.function(
        lambda x: m(x, training=False)).get_concrete_function(
        tf.TensorSpec((None, 64, 64, 3), tf.float32)))
    graph = frozen.graph.as_graph_def()
    names = ([t.name for t in frozen.inputs],
             [t.name for t in frozen.outputs])
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jfn = JGraph(graph, *names)
    want = np.asarray(jax.jit(lambda p, xi: jfn(p, xi)[0])(
        jfn.init_params(), x))
    tfn = TFGraphFunction(graph.SerializeToString(), *names)
    with torch.no_grad():
        (got,) = tfn(tfn.init_params(), torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RESNET_TOL,
                               atol=RESNET_TOL)
    assert {"Conv2D", "Pad", "MaxPool", "Mean", "MatMul", "Softmax"} <= \
        set(tfn.ops)
