"""Gradient accumulation (``ZooConfig.grad_accum_steps``) in the port
against its own full batch and against the JAX package's accumulation,
on the CPU.

The port's counterparts of ``tests/test_fused_eval_grad_accum.py``'s
accumulation tests, plus one accumulated step against JAX's
``_accumulated_grads`` from copied weights, with sample weights (each
microbatch weighted by its weight mass, not a mean of microbatch means)
and with BatchNorm (its moving statistics updated once per microbatch,
in order). Tolerances, float32:

- accumulation 4 against the full batch over 3 epochs of SGD: 1e-4
  relative and 1e-6 absolute on the weights (the JAX test's: the same
  weighted-mean gradient summed in another order);
- one accumulated step against JAX: 1e-6 on the loss, 1e-6 of the
  largest gradient magnitude on every gradient (the bias before a
  BatchNorm has a gradient of 0 up to rounding, ~1e-9), 1e-6 on the
  moving statistics (float32 sums over 8-row microbatches, in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import base
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.engine import GradientClipping
from analytics_zoo_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _data(n=100, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = (x[:, :1] * x[:, 1:2] > 0).astype(np.float32)
    return x, y


def _ctx(**cfg):
    tnn.set_nncontext(None)
    tnn.set_nncontext(tnn.ZooContext(tnn.ZooConfig(**cfg), device="cpu"))


def _model(pkg="torch", batchnorm=False, seed=None):
    layers = tl if pkg == "torch" else jl
    model = Sequential(seed=seed) if pkg == "torch" else JSequential()
    model.add(layers.Dense(16, input_shape=(8,)))
    if batchnorm:
        model.add(layers.BatchNormalization())
    model.add(layers.Activation("relu"))
    model.add(layers.Dense(1, activation="sigmoid"))
    model.compile(optimizer="sgd", loss="binary_crossentropy")
    return model


def _fit_weights(n_epochs=3, **cfg):
    _ctx(**cfg)
    x, y = _data(256, seed=1)
    model = _model(seed=7)
    model.fit(x, y, batch_size=64, nb_epoch=n_epochs)
    return model


def _weights_in_graph_order(model):
    """The model's weights layer by layer in graph order: ``get_weights``
    sorts by layer name as a string, so two models whose auto-names
    straddle a power of ten (``dense_9``, ``dense_10``) list theirs in
    different orders."""
    return [np.asarray(p.detach()) for layer in
            model.graph_function().layers
            for _, p in layer.named_parameters()]


def test_grad_accum_matches_full_batch(monkeypatch):
    """grad_accum_steps=4 follows the full-batch trajectory: the same
    weighted-mean gradient up to float32 summation order. The layers are
    auto-named; the comparison pairs them by position, so it holds
    whatever number of Dense layers the process built before (after 8,
    the first model's two are ``dense_9`` and ``dense_10``, which
    ``get_weights`` lists in reverse)."""
    for built_before in (8, 9, 10):
        monkeypatch.setitem(base._name_counters, "dense", built_before)
        m1 = _fit_weights(grad_accum_steps=1)
        m4 = _fit_weights(grad_accum_steps=4)
        assert m1.trainer.step == m4.trainer.step == 12
        w1, w4 = _weights_in_graph_order(m1), _weights_in_graph_order(m4)
        assert [w.shape for w in w1] == [w.shape for w in w4]
        for a, b in zip(w1, w4):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_grad_accum_composes_with_freeze_and_clipping():
    _ctx(grad_accum_steps=2)
    x, y = _data(256, seed=1)
    model = Sequential()
    model.add(tl.Dense(16, activation="relu", input_shape=(8,),
                       name="frozen_dense"))
    model.add(tl.Dense(1, activation="sigmoid", name="head"))
    model.compile(optimizer="sgd", loss="binary_crossentropy")
    model.freeze(["frozen_dense"])
    trainer = model._ensure_trainer()
    trainer.clipping = GradientClipping(l2_norm=0.5)
    trainer.ensure_initialized()
    params = trainer.params()
    frozen_before = params["frozen_dense.kernel"].detach().clone()
    head_before = params["head.kernel"].detach().clone()
    model.fit(x, y, batch_size=64, nb_epoch=2)
    assert torch.equal(frozen_before, params["frozen_dense.kernel"])
    assert (params["head.kernel"] - head_before).abs().max() > 0


def test_grad_accum_must_divide_batch_size():
    _ctx(grad_accum_steps=3)
    x, y = _data(64)
    model = _model()
    with pytest.raises(ValueError, match="grad_accum_steps"):
        model.fit(x, y, batch_size=32, nb_epoch=1)
    assert model.trainer.step == 0


def _one_accumulated_step(batchnorm, weights):
    """One accumulated step (4 microbatches of 8) from the same weights in
    both packages: (port loss, port grads by name, port moving stats) and
    JAX's."""
    x, y = _data(32, seed=3)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(grad_accum_steps=4)))
    jmodel = _model("jax", batchnorm)
    jtrainer = jmodel._ensure_trainer()
    jtrainer.ensure_initialized()
    params = jax.tree.map(np.asarray, jtrainer.params)
    state = jax.tree.map(np.asarray, jtrainer.net_state or {})
    if batchnorm:   # moving statistics away from their (0, 1) start
        rs = np.random.default_rng(5)
        state = {k: {"moving_mean": rs.standard_normal(16).astype(
                     np.float32) * 0.1,
                     "moving_var": rs.uniform(0.5, 1.5, 16).astype(
                         np.float32)} for k in state}
    batch = ([jnp.asarray(x)], jnp.asarray(y), jnp.asarray(weights))
    jloss, jgrads, jstate = jtrainer._accumulated_grads(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, state), batch, jax.random.key(0), 4)

    _ctx(grad_accum_steps=4)
    tmodel = _model("torch", batchnorm)
    load_jax_params(tmodel, params, state=state if batchnorm else None)
    trainer = tmodel._ensure_trainer()
    trainer.ensure_initialized()
    tloss = trainer.loss_and_grads(trainer.put_batch(([x], y, weights)))
    return (float(tloss), {k: p.grad.numpy() for k, p in
                           tmodel.named_parameters()},
            {f"{l}.{k}": v.numpy() for l, d in tmodel.state_tree().items()
             for k, v in d.items()}), \
        (float(jloss), jax.tree.map(np.asarray, jgrads),
         jax.tree.map(np.asarray, jstate)), tmodel


def _pair(tmodel, jtree, with_what):
    """{port "layer.leaf": JAX leaf}, the layers paired by class and
    creation order (``load_jax_params``' rule)."""
    from analytics_zoo_tpu_torch.utils.jax_weights import _pair_layers
    layers = [l for l in tmodel.graph_function().layers
              if any(True for _ in getattr(l, with_what)())]
    out = {}
    for layer, name in _pair_layers(layers, list(jtree)):
        for k, v in jtree[name].items():
            out[f"{layer.name}.{k}"] = v
    return out


def _close_grads(got, want):
    assert set(want) == set(got)
    scale = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-6 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_one_accumulated_step_matches_jax(weighted):
    """Sample weights make the weighted sum and a mean of microbatch
    means differ; the port follows JAX's weighted sum."""
    w = np.ones(32, np.float32)
    if weighted:
        w = np.random.default_rng(4).uniform(0.0, 3.0, 32).astype(
            np.float32)
        w[8:16] *= 4.0
    (tloss, tgrads, _), (jloss, jgrads, _), tmodel = \
        _one_accumulated_step(False, w)
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-6)
    want = _pair(tmodel, jgrads, "parameters")
    _close_grads(tgrads, want)
    if weighted:
        x, y = _data(32, seed=3)
        # the mean of the four microbatch means is another number
        trainer = tmodel.trainer
        means = []
        for i in range(4):
            sl = slice(8 * i, 8 * i + 8)
            loss, _ = trainer._loss_and_preds(trainer.put_batch(
                ([x[sl]], y[sl], w[sl])), None, False)
            means.append(float(loss.detach()))
        assert abs(np.mean(means) - tloss) > 1e-3


def test_accumulation_updates_batchnorm_once_per_microbatch():
    (tloss, tgrads, tstate), (jloss, jgrads, jstate), tmodel = \
        _one_accumulated_step(True, np.ones(32, np.float32))
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-6)
    want = _pair(tmodel, jgrads, "parameters")
    _close_grads(tgrads, want)
    want_state = _pair(tmodel, jstate, "buffers")
    assert set(want_state) == set(tstate) and tstate
    for k, v in tstate.items():
        np.testing.assert_allclose(v, want_state[k], rtol=0, atol=1e-6,
                                   err_msg=k)
