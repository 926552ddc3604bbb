"""The port's autograd module against the JAX package on the CPU: the
dual-dispatch math (eager on tensors, graph nodes on Variables, with
JAX's shape rules), ``Parameter``/``ParameterLayer``, ``CustomLoss`` and
``MultiLoss`` through ``fit``, and the pickled architecture of a graph
that holds callables.

Tolerances: the eager ops within 1e-6 (the same float32 elementwise
math, reductions summed in other orders); the symbolic graph's
``predict`` within 1e-5; ``fit`` losses step for step within 1e-5, as
the repo's other training parity tests. A graph saved and loaded by the
port predicts bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api import autograd as ja
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import objectives as jo
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api import autograd as ta
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as to
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import model_io
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (KerasNet,
                                                               Sequential)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.utils import load_jax_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


#: op name -> f(A, x, y, z) over the module A; x, y (2, 3, 4), z (4, 5)
OPS = {
    "neg": lambda A, x, y, z: A.neg(x),
    "abs": lambda A, x, y, z: A.abs(x),
    "square": lambda A, x, y, z: A.square(x),
    "sqrt": lambda A, x, y, z: A.sqrt(A.abs(x)),
    "exp": lambda A, x, y, z: A.exp(x),
    "log": lambda A, x, y, z: A.log(A.abs(x) + 0.5),
    "erf": lambda A, x, y, z: A.erf(x),
    "softsign": lambda A, x, y, z: A.softsign(x),
    "softplus": lambda A, x, y, z: A.softplus(x),
    "relu": lambda A, x, y, z: A.relu(x),
    "sigmoid": lambda A, x, y, z: A.sigmoid(x),
    "tanh": lambda A, x, y, z: A.tanh(x),
    "sum": lambda A, x, y, z: A.sum(x, axis=1),
    "sum_all_keep": lambda A, x, y, z: A.sum(x, axis=None, keepdims=True),
    "mean_keep": lambda A, x, y, z: A.mean(x, axis=-1, keepdims=True),
    "maximum": lambda A, x, y, z: A.maximum(x, y),
    "minimum_const": lambda A, x, y, z: A.minimum(x, 0.1),
    "clip": lambda A, x, y, z: A.clip(x, -0.5, 0.5),
    "pow": lambda A, x, y, z: A.pow(A.abs(x) + 0.1, 1.7),
    "mm": lambda A, x, y, z: A.mm(x, z),
    "mm_axes": lambda A, x, y, z: A.mm(x, y, axes=(2, 2)),
    "batch_dot": lambda A, x, y, z: A.batch_dot(x, y, axes=(2, 2)),
    "batch_dot_axes1": lambda A, x, y, z: A.batch_dot(x, y, axes=(1, 1)),
    "batch_dot_normalize": lambda A, x, y, z: A.batch_dot(
        x, y, axes=(2, 2), normalize=True),
    "l2_normalize": lambda A, x, y, z: A.l2_normalize(x, axis=1),
    "stack": lambda A, x, y, z: A.stack([x, y], axis=2),
    "concatenate": lambda A, x, y, z: A.concatenate([x, y], axis=1),
    "expand_dims": lambda A, x, y, z: A.expand_dims(x, -1),
    "squeeze": lambda A, x, y, z: A.squeeze(A.expand_dims(x, 1), 1),
    "index_select": lambda A, x, y, z: A.index_select(x, 1, 2),
    "slice": lambda A, x, y, z: A._slice_dim(x, 2, 1, 2),
    "getitem": lambda A, x, y, z: A._slice_variable(x, (slice(None), 0)),
    "contiguous": lambda A, x, y, z: A.contiguous(x),
}


def _xyz(seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((2, 3, 4)).astype(np.float32)
    y = rs.standard_normal((2, 3, 4)).astype(np.float32)
    z = rs.standard_normal((4, 5)).astype(np.float32)
    return x, y, z


@pytest.mark.parametrize("op", sorted(OPS))
def test_eager_op_matches_jax(op):
    x, y, z = _xyz()
    want = OPS[op](ja, *map(jnp.asarray, (x, y, z)))
    got = OPS[op](ta, *map(torch.from_numpy, (x, y, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


#: ops whose graph node mixes the batch rows (a sum over every axis, a
#: contraction of two batched Variables without a batch dim), or, for mm
#: against a constant, which JAX's shape rule does not take (it needs two
#: Variables): held eagerly above only
SYMBOLIC = sorted(set(OPS) - {"sum_all_keep", "mm_axes", "mm"})


@pytest.mark.parametrize("op", SYMBOLIC)
def test_symbolic_op_has_jax_shape_and_value(op):
    """On Variables the op records a node with JAX's shape rule; a Model
    over it predicts what JAX's does."""
    x, y, z = _xyz(1)

    def build(pkg):
        A, m = (ja, jl) if pkg == "jax" else (ta, tl)
        vx = m.Input(shape=(3, 4), name="x")
        vy = m.Input(shape=(3, 4), name="y")
        out = OPS[op](A, vx, vy, z if pkg == "jax" else torch.from_numpy(z))
        return out, (JModel if pkg == "jax" else TModel)([vx, vy], out)

    (jout, jmodel), (tout, tmodel) = build("jax"), build("torch")
    assert tout.shape == jout.shape
    tnn.init_nncontext(device="cpu")
    want = np.asarray(jmodel.predict([x, y], batch_size=2))
    got = tmodel.predict([x, y], batch_size=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_variable_operators_and_parameter_graph_match_jax():
    def build(pkg):
        A, m = (ja, jl) if pkg == "jax" else (ta, tl)
        M = JModel if pkg == "jax" else TModel
        x = m.Input(shape=(3, 4), name="x")
        y = m.Input(shape=(3, 4), name="y")
        w = A.Parameter((4, 5), name="w")
        h = A.mm(x, w)
        e = A.l2_normalize(h, axis=-1) + 1.0
        f = A.concatenate([A.batch_dot(x, y, axes=(2, 2)), e], axis=-1)
        g = A.clip(f, -0.9, 0.9) ** 2 - A.exp(-A.abs(f)) * 0.5
        s = A.sum(g, axis=1)
        t = A.stack([s, A.mean(g, axis=1)], axis=1)
        u = A.index_select(t, 1, 0) + A.squeeze(A.expand_dims(s, 1), 1)
        v = u[:, 1:5]
        out = (2.0 - v) / A.maximum(A.softplus(v), 0.5) + x.slice(1, 0, 1) \
            .squeeze(1)
        return out, M([x, y], out)

    (jout, jmodel), (tout, tmodel) = build("jax"), build("torch")
    assert tout.shape == jout.shape == (None, 4)
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    x, y, _ = _xyz(2)
    tnn.init_nncontext(device="cpu")
    np.testing.assert_allclose(tmodel.predict([x, y], batch_size=2),
                               np.asarray(jmodel.predict([x, y],
                                                         batch_size=2)),
                               rtol=1e-5, atol=1e-5)


def test_a_frozen_parameter_takes_no_gradient():
    layer = ta.ParameterLayer((2, 3), init_weight=np.ones((2, 3)),
                              trainable=False)
    layer.build_params(torch.Generator(), [])
    assert layer([]).requires_grad is False
    live = ta.ParameterLayer((2, 3), init_weight=np.ones((2, 3)))
    live.build_params(torch.Generator(), [])
    live([]).sum().backward()
    assert torch.equal(live.weight.grad, torch.ones(2, 3))


# -- CustomLoss and MultiLoss through fit ----------------------------------

def _jax_custom(y_true, y_pred):
    d = y_true - y_pred
    return ja.mean(ja.abs(d) + ja.square(d) * 0.5, axis=1)


def _port_custom(y_true, y_pred):
    d = y_true - y_pred
    return ta.mean(ta.abs(d) + ta.square(d) * 0.5, axis=1)


def _double(x):
    return x * 2.0


def _regressor(pkg, outputs=1):
    m = jl if pkg == "jax" else tl
    x = m.Input(shape=(5,), name="x")
    h = m.Dense(6, activation="tanh")(x)
    if outputs == 1:
        out = m.Dense(3)(h)
    else:
        out = [m.Dense(3)(h), m.Dense(1)(h)]
    return (JModel if pkg == "jax" else TModel)(x, out)


def _fit_both(tmp_path, jloss, tloss, outputs=1):
    jmodel, tmodel = _regressor("jax", outputs), _regressor("torch", outputs)
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    jmodel.compile(optimizer="sgd", loss=jloss)
    tmodel.compile(optimizer="sgd", loss=tloss)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path), "jax")
    # batches of 8: JAX's CPU mesh has 8 devices, and a batch it pads to
    # them adds zero-weight rows, which a CustomLoss (weights unused in
    # both packages) would average in
    rs = np.random.default_rng(0)
    x = rs.standard_normal((16, 5)).astype(np.float32)
    y = rs.standard_normal((16, 3)).astype(np.float32)
    if outputs > 1:
        y = [y, rs.standard_normal((16, 1)).astype(np.float32)]
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tnn.init_nncontext(device="cpu")
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    assert len(tmodel.trainer.step_losses) == len(jlosses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses, rtol=0,
                               atol=1e-5)
    return jmodel, tmodel, x


def test_custom_loss_fits_step_for_step(tmp_path):
    _fit_both(tmp_path, ja.CustomLoss(_jax_custom),
              ta.CustomLoss(_port_custom))
    y_true, y_pred = np.ones((3, 2), np.float32), np.zeros((3, 2),
                                                           np.float32)
    assert ta.CustomLoss(_port_custom).forward(y_true, y_pred) == \
        pytest.approx(ja.CustomLoss(_jax_custom).forward(y_true, y_pred))


@pytest.mark.parametrize("weights", [None, [0.3, 2.0]])
def test_multi_loss_fits_step_for_step(tmp_path, weights):
    if weights is None:
        jloss, tloss = ["mse", "mae"], ["mse", "mae"]
    else:
        jloss = jo.MultiLoss(["mse", "mae"], weights)
        tloss = to.MultiLoss(["mse", "mae"], weights)
    _fit_both(tmp_path, jloss, tloss, outputs=2)
    with pytest.raises(ValueError, match="matching"):
        to.MultiLoss(["mse", "mae"])(torch.zeros(2, 3), torch.zeros(2, 3))


# -- the pickled architecture ----------------------------------------------

def test_a_lambda_graph_saves_and_loads_by_pickle(tmp_path):
    tnn.init_nncontext(device="cpu")
    model = Sequential()
    model.add(tl.Dense(4, input_shape=(3,)))
    model.add(ta.Lambda(_double))
    model.add(tl.Dense(2, activation=_double))
    model.compile(optimizer="sgd", loss=ta.CustomLoss(_port_custom))
    x = np.random.default_rng(3).standard_normal((5, 3)).astype(np.float32)
    model.fit(x, np.zeros((5, 2), np.float32), batch_size=5, nb_epoch=1)
    want = model.predict(x, batch_size=5)
    model.save_model(str(tmp_path / "m"))
    assert (tmp_path / "m" / "architecture.pkl").exists()
    assert not (tmp_path / "m" / "architecture.json").exists()
    back = KerasNet.load_model(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.predict(x, batch_size=5), want)


def test_the_port_refuses_a_jax_pickle_without_importing_jax(tmp_path):
    jmodel = JSequential()
    jmodel.add(jl.Dense(2, input_shape=(3,)))
    jmodel.add(ja.Lambda(_double))
    jmodel.save_model(str(tmp_path / "jax"))
    assert (tmp_path / "jax" / "architecture.pkl").exists()
    code = (
        "import sys\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras.models import "
        "KerasNet\n"
        "try:\n"
        f"    KerasNet.load_model({str(tmp_path / 'jax')!r})\n"
        "except Exception as e:\n"
        "    print(type(e).__name__, e)\n"
        "print('loaded:', sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'analytics_zoo_tpu'}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "UnpicklingError" in res.stdout and "JAX package" in \
        res.stdout, res.stdout
    assert "loaded: []" in res.stdout, res.stdout


def test_the_restricted_unpickler_refuses_the_operating_system():
    import os
    import pickle

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    raw = pickle.dumps({"format": model_io.PICKLE_FORMAT, "spec": Evil(),
                        "arrays": {}})
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        model_io.load_pickled_spec(raw, "evil.pkl")
    # a dotted name through an allowed module to another module's object
    dotted = b"\x80\x04ctorch.serialization\nos.system\n."
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        model_io.load_pickled_spec(dotted, "dotted.pkl")
    # what the loader would refuse is refused when saving (torch.tanh
    # pickles through builtins.getattr)
    model = Sequential()
    model.add(tl.Dense(2, activation=torch.tanh, input_shape=(3,)))
    with pytest.raises(model_io.UnserializableConfig, match="getattr"):
        model_io.dump_pickled_spec(model.graph_function(), "tanh")
