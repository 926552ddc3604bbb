"""The port's TorchNet, TorchCriterion, KerasLayerWrapper and the ``Net``
facade against the JAX package's on the CPU.

JAX's ``TorchNet`` lowers the module to jax through ``torch.fx`` (its
"jax" mode) or runs it in a host callback; the port calls the module
itself through ``torch.func.functional_call``. The same seeded module
goes through both: forward rows, parameter gradients, a loss through
``TorchCriterion`` and its gradient, a graph that holds a ``TorchNet``
fitted step for step, ``InferenceModel.load_torch`` of a module and of a
TorchScript file, and ``KerasLayerWrapper`` in a graph.

Tolerances: rows and gradients within 1e-5 absolute and relative
(float32, other summation orders); fit's per-step losses within 1e-5 and
weights within 2e-5.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu.pipeline.api.net import TorchCriterion as JCrit
from analytics_zoo_tpu.pipeline.api.net import TorchNet as JTorchNet
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.pipeline.api.net import (Net, TorchCriterion,
                                                      TorchFxConverter,
                                                      TorchNet)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.utils import load_jax_params

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


def _module(seed=0):
    torch.manual_seed(seed)
    m = nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1), nn.BatchNorm2d(4), nn.ReLU(),
        nn.MaxPool2d(2), nn.Flatten(), nn.Linear(4 * 4 * 4, 5))
    with torch.no_grad():
        m[1].running_mean.normal_()
        m[1].running_var.uniform_(0.5, 2.0)
        m[1].weight.normal_()
    return m.eval()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_forward_matches_jax_fx_lowering_and_torch():
    m = _module()
    x = _x((2, 3, 8, 8), 1)
    jnet = JTorchNet.from_pytorch(m)
    assert jnet.mode == "jax"
    net = TorchNet.from_pytorch(m)
    assert net.mode == "torch"
    got = net.predict(x)
    np.testing.assert_allclose(got, np.asarray(jnet.predict(x)), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, m(torch.from_numpy(x)).detach().numpy(),
                               rtol=TOL, atol=TOL)
    # the module's tensors are the layer's, under JAX's callback names
    assert [n for n, _ in net.named_parameters()] == [
        "0_weight", "0_bias", "1_weight", "1_bias", "5_weight", "5_bias"]
    assert net.get_parameter("0_weight") is m[0].weight


def test_parameter_gradients_match_jax():
    m = _module(1)
    x = _x((2, 3, 8, 8), 2)
    jnet = JTorchNet.from_pytorch(m)
    params = jnet.build(None, None)
    jgrads = jax.grad(lambda p: jnp.sum(
        jnet.call(p, [jnp.asarray(x)]) ** 2))(params)
    net = TorchNet.from_pytorch(m)
    loss = (net(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    short = {"weight": "w", "bias": "b"}
    for key, p in net.named_parameters():
        path, leaf = key.rsplit("_", 1)
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(jgrads[f"{path}_{short[leaf]}"]),
            rtol=TOL, atol=TOL, err_msg=key)
    # gradients reach the module's own parameters
    assert m[5].weight.grad is not None


def test_torch_criterion_and_its_gradient_match_jax():
    rs = np.random.default_rng(3)
    y = rs.standard_normal((4, 3)).astype(np.float32)
    p = rs.standard_normal((4, 3)).astype(np.float32)
    jcrit = JCrit.from_pytorch(nn.MSELoss())
    want = float(jcrit(jnp.asarray(y), jnp.asarray(p)))
    jg = jax.grad(lambda q: jcrit(jnp.asarray(y), q))(jnp.asarray(p))
    crit = TorchCriterion.from_pytorch(nn.MSELoss())
    tp = torch.from_numpy(p).requires_grad_(True)
    loss = crit(torch.from_numpy(y), tp)
    loss.backward()
    np.testing.assert_allclose(float(loss), want, rtol=TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)


def _graph(pkg, head):
    lib, model_cls = (jl, JModel) if pkg == "jax" else (tl, TModel)
    inp = lib.Input(shape=(6,))
    h = lib.Dense(8, activation="tanh")(inp)
    return model_cls(inp, head(h))


def test_graph_with_a_torchnet_fits_step_for_step_as_jax(tmp_path):
    torch.manual_seed(4)
    head = nn.Linear(8, 3)
    # a copy: on the CPU JAX's fx import can alias the module's memory,
    # and its fit donates the buffers it updates
    jmodel = _graph("jax", JTorchNet.from_pytorch(copy.deepcopy(head)))
    tmodel = _graph("torch", TorchNet.from_pytorch(head))
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="mse")
    jmodel.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    rs = np.random.default_rng(5)
    x = rs.standard_normal((16, 6)).astype(np.float32)
    y = rs.standard_normal((16, 3)).astype(np.float32)
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=0, atol=1e-5)
    jw = jax.tree.map(np.asarray, jmodel.get_params())
    (jname,) = [k for k in jw if k.startswith("torchnet")]
    net = tmodel.graph_function().layers[-1]
    for key, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jw[jname][key],
                                   rtol=0, atol=2e-5, err_msg=key)
    # fit trained the module itself
    np.testing.assert_array_equal(head.weight.detach().numpy(),
                                  net.get_parameter("weight")
                                  .detach().numpy())


def test_torch_criterion_trains_a_graph_through_compile():
    """``compile(loss=TorchCriterion)``: the port's loss is the torch
    loss of (predictions, labels) and its gradient reaches the
    predictions (ROADMAP C: JAX's callable-loss wrapper hands the
    criterion its arguments the other way round)."""
    torch.manual_seed(6)
    model = _graph("torch", TorchNet.from_pytorch(nn.Linear(8, 3)))
    model.compile(optimizer="sgd",
                  loss=TorchCriterion.from_pytorch(nn.MSELoss()))
    rs = np.random.default_rng(7)
    x = rs.standard_normal((16, 6)).astype(np.float32)
    y = rs.standard_normal((16, 3)).astype(np.float32)
    twin = _graph("torch", TorchNet.from_pytorch(nn.Linear(8, 3)))
    twin.compile(optimizer="sgd", loss="mse")
    twin.graph_function()
    model.graph_function()
    with torch.no_grad():
        for (_, a), (_, b) in zip(model.named_parameters(),
                                  twin.named_parameters()):
            b.copy_(a)
    model.fit(x, y, batch_size=8, nb_epoch=1)
    twin.fit(x, y, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(model.trainer.step_losses,
                               twin.trainer.step_losses, rtol=1e-6)
    for (_, a), (_, b) in zip(model.named_parameters(),
                              twin.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_inference_model_load_torch_module_and_script(tmp_path):
    m = nn.Sequential(nn.Linear(6, 4), nn.Tanh()).eval()
    x = _x((3, 6), 8)
    want = np.asarray(JInferenceModel(supported_concurrent_num=2)
                      .load_torch(m).predict(x))
    im = InferenceModel(supported_concurrent_num=2).load_torch(m)
    np.testing.assert_allclose(im.predict(x), want, rtol=TOL, atol=TOL)
    path = str(tmp_path / "m.pt")
    torch.jit.save(torch.jit.script(m), path)
    script = InferenceModel().do_load_pytorch(path)
    assert script.model.mode == "script"
    np.testing.assert_allclose(script.predict(x), want, rtol=TOL, atol=TOL)


def _affine(x):
    return x * 2.0 + 1.0


@pytest.mark.parametrize("kind", ["function", "module"])
def test_keras_layer_wrapper_in_a_graph_matches_jax(kind):
    def build(pkg):
        lib, model_cls = (jl, JModel) if pkg == "jax" else (tl, TModel)
        fn = _affine if kind == "function" else \
            (jnp.tanh if pkg == "jax" else nn.Tanh())
        inp = lib.Input(shape=(5,))
        h = lib.Dense(4)(inp)
        h = lib.KerasLayerWrapper(function=fn)(h)
        return model_cls(inp, lib.Dense(2)(h))

    jmodel, tmodel = build("jax"), build("torch")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    x = _x((4, 5), 9)
    np.testing.assert_allclose(tmodel.predict(x, batch_size=4),
                               np.asarray(jmodel.predict(x, batch_size=4)),
                               rtol=TOL, atol=TOL)
    (wrapper,) = [l for l in tmodel.graph_function().layers
                  if isinstance(l, tl.KerasLayerWrapper)]
    assert wrapper.compute_output_shape((None, 4)) == (None, 4)


def test_keras_layer_wrapper_in_a_graph_saves_pickled(tmp_path):
    inp = tl.Input(shape=(5,))
    h = tl.KerasLayerWrapper(function=_affine)(tl.Dense(4)(inp))
    model = TModel(inp, tl.Dense(2)(h))
    x = _x((4, 5), 10)
    want = model.predict(x, batch_size=4)
    model.save_model(str(tmp_path / "w"))
    again = KerasNet.load_model(str(tmp_path / "w"))
    np.testing.assert_array_equal(again.predict(x, batch_size=4), want)


def test_net_facade_and_fx_converter(tmp_path):
    m = _module(11)
    x = torch.from_numpy(_x((2, 3, 8, 8), 12))
    net = Net.load_torch(m)
    assert isinstance(net, TorchNet) and Net.loadTorch is Net.load_torch
    path = str(tmp_path / "s.pt")
    torch.jit.save(torch.jit.trace(m, x), path)
    scripted = Net.load_torch(path)
    assert scripted.mode == "script"
    np.testing.assert_allclose(scripted.predict(x.numpy()),
                               m(x).detach().numpy(), rtol=TOL, atol=TOL)
    fn, params = TorchFxConverter(m).convert()
    assert set(params) >= {"0_weight", "1_running_mean", "5_bias"}
    np.testing.assert_allclose(fn(params, x).detach().numpy(),
                               m(x).detach().numpy(), rtol=TOL, atol=TOL)
    # the TF loaders are ported (ROADMAP A14.8): a frozen graph loads as
    # a TFNet with no TensorFlow, a missing file raises
    assert Net.loadTF is Net.load_tf and Net.loadKeras is Net.load_keras
    pb = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "tf_fixtures", "classifier.pb")
    assert type(Net.load_tf(pb)).__name__ == "TFNet"
    assert type(InferenceModel().load_tf(pb, device="cpu").model
                ).__name__ == "TFNet"
    for load in (Net.load_tf, InferenceModel().load_tf):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "model.pb"))
