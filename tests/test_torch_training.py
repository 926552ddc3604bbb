"""The port's training slice against the JAX package on the CPU: losses,
metrics and optimizers (value for value), and ``Model.fit`` /
``evaluate`` on a small BERT classifier from copied weights.

Tolerances, float32 on both sides unless noted:
- losses: 1e-6 relative and absolute on values and gradients (one
  reduction over a handful of elements);
- metrics: 1e-6 (means of 0/1 or small sums);
- optimizers: 1e-6 on the parameters after each of 10 steps on identical
  gradients (the port computes the schedules and bias corrections in
  float64 on the host where optax computes them in float32: about 1e-7
  relative);
- ``fit``: 1e-5 on each step's loss and 2e-5 on the final weights after
  4 Adam steps at lr 1e-3. Two blocks of float32 matmuls summed in
  another order (XLA's CPU dots against PyTorch's BLAS) give gradients
  some 1e-6 apart; Adam's normalised step keeps each weight's drift a
  small multiple of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import metrics as jm
from analytics_zoo_tpu.pipeline.api.keras import objectives as jo
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.pipeline import engine as teng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics as tm
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as to
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


# ---------------------------------------------------------------------------
# (e) losses, metrics, optimizers
# ---------------------------------------------------------------------------

def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _loss_case(name, rs, b=6):
    """(y_pred, y_true) the loss takes, as float32 numpy."""
    f = np.float32
    if name in ("mse", "mae", "mape", "msle", "poisson"):
        return (rs.uniform(0.1, 2.0, (b, 3)).astype(f),
                rs.uniform(0.1, 2.0, (b, 3)).astype(f))
    if name == "binary_crossentropy":
        return (rs.uniform(0.01, 0.99, (b, 3)).astype(f),
                rs.integers(0, 2, (b, 3)).astype(f))
    if name in ("categorical_crossentropy", "kld"):
        return (_softmax(rs.standard_normal((b, 4))),
                _softmax(2 * rs.standard_normal((b, 4))))
    if name == "sparse_categorical_crossentropy":
        return (_softmax(rs.standard_normal((b, 4))),
                rs.integers(0, 4, (b,)).astype(f))
    if name in ("hinge", "squared_hinge"):
        return (rs.standard_normal((b, 3)).astype(f),
                np.sign(rs.standard_normal((b, 3))).astype(f))
    if name == "softmax_crossentropy_with_logits":
        return (rs.standard_normal((b, 5)).astype(f),
                rs.integers(0, 5, (b, 1)).astype(f))
    if name == "sigmoid_crossentropy_with_logits":
        return (rs.standard_normal((b, 3)).astype(f),
                rs.integers(0, 2, (b, 3)).astype(f))
    if name == "identity":
        return rs.standard_normal((b,)).astype(f), np.zeros((b,), f)
    return (rs.standard_normal((b, 3)).astype(f),     # cosine, rank_hinge
            rs.standard_normal((b, 3)).astype(f))


LOSSES = ["mse", "mae", "mape", "msle", "binary_crossentropy",
          "categorical_crossentropy", "sparse_categorical_crossentropy",
          "hinge", "squared_hinge", "kld", "poisson", "cosine_proximity",
          "rank_hinge", "softmax_crossentropy_with_logits",
          "sigmoid_crossentropy_with_logits", "identity"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_gradient_match_jax(name, weighted):
    rs = np.random.default_rng(LOSSES.index(name))
    y_pred, y_true = _loss_case(name, rs)
    w = np.array([1, 0, 2, 0.5, 1, 3], np.float32) if weighted else None
    jloss, tloss = jo.get_loss(name), to.get_loss(name)
    want, jgrad = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(y_true),
                        None if w is None else jnp.asarray(w)))(
        jnp.asarray(y_pred))
    tp = torch.from_numpy(y_pred).requires_grad_()
    got = tloss(tp, torch.from_numpy(y_true),
                None if w is None else torch.from_numpy(w))
    (grad,) = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)


def test_class_nll_and_one_based_labels_match_jax():
    rs = np.random.default_rng(0)
    logp = np.log(_softmax(rs.standard_normal((5, 4))))
    labels = rs.integers(1, 5, (5, 1)).astype(np.float32)
    want = jo.ClassNLLCriterion(zeroBasedLabel=False)(jnp.asarray(logp),
                                                      jnp.asarray(labels))
    got = to.ClassNLLCriterion(zeroBasedLabel=False)(torch.from_numpy(logp),
                                                     torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_losses_not_ported_yet_raise():
    assert type(to.get_loss("crf")).__name__ == \
        type(jo.get_loss("crf")).__name__ == "CRFLoss"
    multi = to.get_loss(["mse", "mae"])
    assert type(multi).__name__ == "MultiLoss" and \
        [type(l).__name__ for l in multi.losses] == \
        [type(l).__name__ for l in jo.get_loss(["mse", "mae"]).losses]
    with pytest.raises(ValueError, match="Unknown loss"):
        to.get_loss("nope")
    wrapped = to.get_loss(lambda p, t: ((p - t) ** 2).sum())
    assert wrapped(torch.ones(3, 2), torch.zeros(3, 2)).item() == 6.0


def _metric_case(name, rs, b=9):
    f = np.float32
    if name in ("binary_accuracy",):
        return rs.uniform(0, 1, (b, 1)).astype(f), \
            rs.integers(0, 2, (b, 1)).astype(f)
    if name == "categorical_accuracy":
        return _softmax(rs.standard_normal((b, 4))), \
            np.eye(4, dtype=f)[rs.integers(0, 4, b)]
    if name == "top5accuracy":
        return _softmax(rs.standard_normal((b, 7))), \
            rs.integers(0, 7, (b,)).astype(f)
    if name in ("mae", "mse"):
        return rs.standard_normal((b, 3)).astype(f), \
            rs.standard_normal((b, 3)).astype(f)
    if name == "auc":
        return _softmax(rs.standard_normal((b, 2))), \
            rs.integers(0, 2, (b,)).astype(f)
    return _softmax(rs.standard_normal((b, 4))), \
        rs.integers(0, 4, (b,)).astype(f)


METRICS = ["accuracy", "sparse_categorical_accuracy", "binary_accuracy",
           "categorical_accuracy", "top5accuracy", "mae", "mse", "auc",
           "loss"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    rs = np.random.default_rng(METRICS.index(name))
    batches = [_metric_case(name, rs) for _ in range(3)]
    w = np.array([1, 0, 2, 1, 1, 0.5, 1, 1, 3], np.float32)
    jmet = jm.get_metric(name, jo.get_loss("sparse_categorical_crossentropy"))
    tmet = tm.get_metric(name, to.get_loss("sparse_categorical_crossentropy"))
    assert tmet.name == jmet.name
    jacc = tacc = None
    for p, t in batches:
        jn, jd = jmet.batch_stats(jnp.asarray(p), jnp.asarray(t),
                                  jnp.asarray(w))
        tn, td = tmet.batch_stats(torch.from_numpy(p), torch.from_numpy(t),
                                  torch.from_numpy(w))
        jacc = (np.asarray(jn), np.asarray(jd)) if jacc is None else \
            (jacc[0] + np.asarray(jn), jacc[1] + np.asarray(jd))
        tacc = (tn.numpy(), td.numpy()) if tacc is None else \
            (tacc[0] + tn.numpy(), tacc[1] + td.numpy())
    np.testing.assert_allclose(tmet.finalize(*tacc), jmet.finalize(*jacc),
                               rtol=1e-6, atol=1e-6)


OPTIMIZERS = [
    ("adam", {}),
    ("adam_poly", dict(lr=1e-2, schedule=("PolyEpochDecay", (2.0, 5, 2)))),
    ("adam_decay_clipnorm", dict(lr=1e-2, decay=0.1, clipnorm=0.5)),
    ("adam_clipvalue", dict(lr=1e-2, clipvalue=0.05)),
    ("sgd", dict(lr=0.1)),
    ("sgd_nesterov_wd", dict(lr=0.1, momentum=0.9, nesterov=True,
                             weight_decay=1e-2)),
    ("sgd_warmup", dict(lr=0.1, momentum=0.9,
                        schedule=("Warmup", (0.01,)))),
    ("sgd_plateau", dict(lr=0.1, schedule=("Plateau", ()))),
    ("adamweightdecay", dict(lr=1e-2)),
    ("adamweightdecay_onecycle", dict(lr=1e-2, total=10)),
    ("rmsprop", dict(lr=1e-2)),
    ("adagrad", dict(lr=0.1)),
    ("adadelta", dict(lr=1.0)),
    ("adamax", dict(lr=1e-2)),
    ("ftrl", dict(lr=0.1)),
]


def _build_optimizer(module, key, kw):
    kw = dict(kw)
    if "schedule" in kw:
        cls, args = kw["schedule"]
        kw["schedule"] = getattr(module, cls)(*args)
    cls = {"adam": "Adam", "sgd": "SGD",
           "adamweightdecay": "AdamWeightDecay", "rmsprop": "RMSprop",
           "adagrad": "Adagrad", "adadelta": "Adadelta", "adamax": "Adamax",
           "ftrl": "Ftrl"}[key.split("_")[0]]
    return getattr(module, cls)(**kw)


@pytest.mark.parametrize("key,kw", OPTIMIZERS)
def test_optimizers_match_optax_over_ten_steps(key, kw):
    rs = np.random.default_rng(0)
    params = {"a": rs.standard_normal((3, 4)).astype(np.float32),
              "b": rs.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rs.standard_normal(v.shape) * 2.0).astype(np.float32)
              for k, v in params.items()} for _ in range(10)]
    jtx = _build_optimizer(jopt, key, kw).to_optax()
    ttx = _build_optimizer(topt, key, kw).transformation()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, tstate, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_lr_schedules_match_jax():
    for jo_, to_ in ((jopt.Adam(lr=0.1, decay=0.5), topt.Adam(lr=0.1,
                                                              decay=0.5)),
                     (jopt.AdamWeightDecay(lr=0.1, total=20),
                      topt.AdamWeightDecay(lr=0.1, total=20)),
                     (jopt.SGD(lr=0.1, schedule=jopt.PolyEpochDecay(1.0, 4)),
                      topt.SGD(lr=0.1, schedule=topt.PolyEpochDecay(1.0,
                                                                    4)))):
        js, ts = jo_.lr_schedule(), to_.lr_schedule()
        for step in range(25):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                       atol=1e-9)


def test_gradient_clipping_matches_jax():
    from analytics_zoo_tpu.pipeline.engine import GradientClipping as JGC
    rs = np.random.default_rng(1)
    grads = {"a": rs.standard_normal((4, 3)).astype(np.float32) * 3,
             "b": rs.standard_normal((7,)).astype(np.float32)}
    for kw in (dict(l2_norm=1.5), dict(min_value=-0.5, max_value=0.2),
               dict(l2_norm=100.0)):
        want, jnorm = JGC(**kw).apply_with_norm(
            {k: jnp.asarray(v) for k, v in grads.items()})
        got, tnorm = teng.GradientClipping(**kw).apply_with_norm(
            {k: torch.from_numpy(v) for k, v in grads.items()})
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
        assert (jnorm is None) == (tnorm is None)


# ---------------------------------------------------------------------------
# (f) Model.fit / evaluate on a small BERT classifier
# ---------------------------------------------------------------------------

L, HID, VOCAB = 64, 128, 100


def _classifier(pkg, p_drop=0.0):
    """bench.py's classifier at a small size: 2 blocks, hidden 128, 2
    heads (d = 64), L = 64."""
    layers = jl if pkg == "jax" else tl
    bert_cls = jsa.BERT if pkg == "jax" else tl.BERT
    bert = bert_cls(vocab=VOCAB, hidden_size=HID, n_block=2, n_head=2,
                    seq_len=L, intermediate_size=2 * HID,
                    hidden_p_drop=p_drop, attn_p_drop=p_drop,
                    output_all_block=False)
    ins = [layers.Input(shape=(L,), name="tokens"),
           layers.Input(shape=(L,), name="positions"),
           layers.Input(shape=(L,), name="segments"),
           layers.Input(shape=(1, 1, L), name="mask")]
    _, pooled = bert(ins)
    probs = layers.Dense(2, activation="softmax")(pooled)
    model_cls = JModel if pkg == "jax" else TModel
    return model_cls(ins, probs)


def _data(seed, n):
    rs = np.random.default_rng(seed)
    lengths = rs.integers(8, L + 1, size=n)
    pos = np.arange(L)[None, :]
    labels = rs.integers(0, 2, size=n)
    tokens = rs.integers(3, VOCAB, size=(n, L))
    tokens[:, 0] = 1 + labels          # a [CLS]-like token that carries it
    x = [tokens.astype(np.float32),
         np.repeat(pos.astype(np.float32), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(np.float32),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, labels.astype(np.float32)


def _jax_fit(jmodel, x, y, epochs, batch):
    """JAX fit; the per-step losses from its train summary."""
    jmodel.fit(x, y, batch_size=batch, nb_epoch=epochs)
    return [v for _, _, _, v in jmodel.get_train_summary("Loss")]


def _paired_models(tmp_path):
    """The classifier in both packages, the port holding the JAX model's
    initial weights; the JAX trainer logs every step's loss."""
    jmodel, tmodel = _classifier("jax"), _classifier("torch")
    jmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    tmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path), "jax")
    params = jmodel.get_params()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    tnn.init_nncontext(device="cpu")
    return jmodel, tmodel


def _jax_leaves_by_port_name(jmodel, tmodel):
    """JAX weights keyed by the port's parameter names."""
    jparams = jax.tree.map(np.asarray, jmodel.get_params())
    jnames = list(jparams)
    out = {}
    for (tname, _), jname in zip(
            [(l.name, l) for l in tmodel.graph_function().layers], jnames):
        flat = jax.tree_util.tree_flatten_with_path(jparams[jname])[0]
        for path, leaf in flat:
            key = ".".join(str(getattr(p, "key", p)) for p in path)
            out[f"{tname}.{key}"] = leaf
    return out


def test_fit_matches_jax_step_for_step(tmp_path):
    jmodel, tmodel = _paired_models(tmp_path)
    x, y = _data(0, 16)
    jlosses = _jax_fit(jmodel, x, y, epochs=2, batch=8)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    tlosses = tmodel.trainer.step_losses
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=1e-5)
    jw = _jax_leaves_by_port_name(jmodel, tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jw[name], rtol=0,
                                   atol=2e-5, err_msg=name)
    # the model's own parameters trained in place: predict serves them
    probs = tmodel.predict(x, batch_size=8)
    want = np.asarray(jmodel.predict(x, batch_size=8))
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
    # evaluate agrees with JAX's
    jres = jmodel.evaluate(x, y, batch_size=6)
    tres = tmodel.evaluate(x, y, batch_size=6)
    assert set(tres) == set(jres) == {"accuracy", "loss"}
    np.testing.assert_allclose(tres["loss"], jres["loss"], atol=1e-5)
    assert tres["accuracy"] == pytest.approx(jres["accuracy"], abs=1e-6)


def test_a_frozen_layer_does_not_move(tmp_path):
    jmodel, tmodel = _paired_models(tmp_path)
    bert_t = tmodel.graph_function().layers[0].name
    bert_j = jmodel.graph_function().layers[0].name
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    x, y = _data(1, 8)
    jmodel.freeze([bert_j])
    jlosses = _jax_fit(jmodel, x, y, epochs=2, batch=8)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    tmodel.freeze([bert_t])
    assert tmodel.frozen_layers() == [bert_t]
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses, atol=1e-5)
    moved = {k for k, v in tmodel.named_parameters()
             if not torch.equal(v.detach(), before[k])}
    assert moved and all(not k.startswith(bert_t + ".") for k in moved)
    jw = _jax_leaves_by_port_name(jmodel, tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jw[name], atol=2e-5,
                                   err_msg=name)
    tmodel.unfreeze()
    assert tmodel.frozen_layers() == []
    with pytest.raises(ValueError, match="unknown layers"):
        tmodel.freeze(["nope"])


def test_training_with_dropout_draws_from_the_step_generator():
    """Dropout on, from the same initial weights (the context's seed): the
    same trainer seed draws the same masks, another seed does not, the
    kernels' plain versions carry it on the CPU, and no launch is
    counted."""
    from analytics_zoo_tpu_torch.ops import _kernels
    tnn.init_nncontext(device="cpu")
    x, y = _data(2, 8)
    runs = []
    for seed in (0, 0, 1):
        model = _classifier("torch", p_drop=0.1)
        model.compile(optimizer="adam",
                      loss="sparse_categorical_crossentropy")
        model._ensure_trainer().seed = seed
        model.fit(x, y, batch_size=4, nb_epoch=1)
        runs.append(model.trainer.step_losses)
    # the same masks: equal up to the CPU BLAS's summation order, which
    # may change between runs in one process (1e-6); other masks move
    # the losses by far more
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-6)
    assert np.abs(np.subtract(runs[0], runs[2])).max() > 1e-4
    assert np.isfinite(runs[0]).all()
    assert _kernels.LAUNCHES.snapshot() == {}
    assert teng.step_seed(0, 1) != teng.step_seed(0, 2) != \
        teng.step_seed(1, 1)


def test_fit_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """Gradient accumulation, checkpoint triggers and the sharded
    checkpoint format (ROADMAP A12) train now; what stays refused says
    why: a graph whose config holds a callable that pickle cannot store
    (a lambda) is refused by the pickled save."""
    from analytics_zoo_tpu_torch.common.zoo_trigger import SeveralIteration
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine.model_io import \
        UnserializableConfig
    monkeypatch.setenv("ZOO_TPU_GRAD_ACCUM_STEPS", "2")
    tnn.init_nncontext(device="cpu")
    model = _classifier("torch")
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    x, y = _data(3, 4)
    model.fit(x, y, batch_size=4, nb_epoch=1)
    assert model.trainer.step == 1 and len(model.trainer.step_losses) == 1
    model.set_checkpoint(str(tmp_path / "ckpt"))
    model.fit(x, y, batch_size=4, checkpoint_trigger=SeveralIteration(1),
              nb_epoch=1)
    assert (tmp_path / "ckpt" / "latest").read_text() == "ckpt-2"
    # the sharded format is ported now (ROADMAP A12): it writes a commit
    monkeypatch.setenv("ZOO_TPU_SHARDED_CHECKPOINT", "1")
    model.fit(x, y, batch_size=4, checkpoint_trigger=SeveralIteration(1),
              nb_epoch=1)
    assert (tmp_path / "ckpt" / "sharded.commit").read_text() == "s3"
    bad = tl.Dense(2, activation=lambda t: t * 2.0)
    inp = tl.Input(shape=(3,))
    with pytest.raises(UnserializableConfig, match="cannot be pickled"):
        TModel(inp, bad(inp)).save_model(str(tmp_path / "m"))


def test_fit_on_an_array_feature_set_with_validation_and_clipping():
    """A FeatureSet goes in as it is, validation runs each epoch, and the
    clipping setters reach the trainer; the epoch order is the JAX
    package's."""
    tnn.init_nncontext(device="cpu")
    model = _classifier("torch")
    model.compile(optimizer=topt.SGD(lr=0.05),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.set_gradient_clipping_by_l2_norm(0.1)
    x, y = _data(4, 12)
    data = ArrayFeatureSet(x, y)
    model.fit(data, batch_size=4, nb_epoch=2, validation_data=(x, y))
    assert model.trainer.epoch == 2 and model.trainer.step == 6
    assert model.trainer.clipping.l2_norm == 0.1
    order = [b[1] for b in data.batches(4, shuffle=True, seed=0)]
    idx = np.arange(12)
    np.random.default_rng(0).shuffle(idx)
    np.testing.assert_array_equal(np.concatenate(order), y[idx])
    res = model.evaluate(x, y, batch_size=5)
    assert np.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0
