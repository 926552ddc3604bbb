"""The recommendation slice of the port against the JAX package on the
CPU: the layers NeuralCF and WideAndDeep are made of, NeuralCF at
bench.py's full widths (MovieLens-1M's 6040 users and 3706 items, 5
classes, embeddings of 20, hidden 40-20-10) with and without its MF
branch, WideAndDeep in all three types, ``Sequential`` and graph
surgery, and ``predict`` on a feature set (fault C3). JAX's weights are
copied into the port with ``load_jax_params``; inputs come from numpy
seeds.

Tolerances, float32 on both sides:
- a layer's forward 1e-6, its gradients (``jax.grad`` against autograd
  through the sum of the output times a seeded cotangent) within 1e-5
  of the gradient's norm;
- NeuralCF: 1e-5 relative on each of 4 ``fit`` steps' loss (Adam at
  lr 1e-3; small products and a 5-way softmax summed in another order
  by XLA's CPU dots and PyTorch's BLAS, some 1e-7 apart), 1e-5 on
  ``predict``; classes, pairs and recommendations equal, probabilities
  within 1e-5;
- WideAndDeep: forward 1e-6; one ``fit`` step's loss 1e-5 relative and
  the weights after it within 1e-5 of each tensor's norm;
- ``Sequential``: 1e-5 on the losses of 4 steps and on ``predict``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature.feature_set import \
    ArrayFeatureSet as JArrayFeatureSet
from analytics_zoo_tpu.feature.feature_set import Sample as JSample
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import (ArrayFeatureSet,
                                                         FeatureSet, Sample)
from analytics_zoo_tpu_torch.models import ZooModel
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
from analytics_zoo_tpu_torch.utils import load_jax_params

FWD_TOL = 1e-6
GRAD_REL_TOL = 1e-5
# bench.py's NeuralCF (bench.py:155-162)
N_USERS, N_ITEMS, N_CLASSES = 6040, 3706, 5
NCF_KW = dict(user_embed=20, item_embed=20, hidden_layers=[40, 20, 10],
              mf_embed=20)


@pytest.fixture(autouse=True)
def _contexts():
    # every JAX step logs its loss (read back from the train summary)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# layers, forward and gradient
# ---------------------------------------------------------------------------

def _ids(rs):
    """(5, 3) float ids into a 10-row table: in range, negative in range
    (counted from the end), fractional (truncated), and out of range on
    both sides (NaN rows)."""
    ids = rs.integers(0, 10, (5, 3)).astype(np.float32)
    ids[0] = [-1, -10, 2.7]
    ids[1] = [10, 12, -11]
    return ids


LAYER_CASES = {
    "embedding": (lambda m: m.Embedding(10, 4), [(None, 3)],
                  lambda rs: [_ids(rs)]),
    "select_dim1": (lambda m: m.Select(1, 0), [(None, 3, 5)], None),
    "select_last_dim_negative_index": (lambda m: m.Select(-1, -2),
                                       [(None, 3, 5)], None),
    "select_dim1_negative_index": (lambda m: m.Select(1, -1),
                                   [(None, 3, 5)], None),
    "flatten_1d": (lambda m: m.Flatten(), [(None,)],
                   lambda rs: [rs.standard_normal((4,)).astype(np.float32)]),
    "flatten_nd": (lambda m: m.Flatten(), [(None, 3, 5)], None),
    "activation_relu": (lambda m: m.Activation("relu"), [(None, 3, 5)],
                        None),
    "activation_softmax": (lambda m: m.Activation("softmax"),
                           [(None, 3, 5)], None),
    "activation_gelu": (lambda m: m.Activation("gelu"), [(None, 3, 5)],
                        None),
    "concatenate_layer": (lambda m: m.Concatenate(axis=1),
                          [(None, 3, 5), (None, 2, 5)], None),
    "add_layer": (lambda m: m.Add(), [(None, 3, 5)] * 3, None),
    "multiply_layer": (lambda m: m.Multiply(), [(None, 3, 5)] * 2, None),
    "average_layer": (lambda m: m.Average(), [(None, 3, 5)] * 2, None),
    "maximum_layer": (lambda m: m.Maximum(), [(None, 3, 5)] * 2, None),
}
for _mode in ("sum", "add", "sub", "mul", "max", "min", "ave", "concat",
              "dot", "cos"):
    LAYER_CASES[f"merge_{_mode}"] = (
        lambda m, mode=_mode: m.Merge(mode=mode),
        [(None, 3, 5)] * (2 if _mode in ("sub", "dot", "cos") else 3), None)


def _inputs(case, rs):
    make, shapes, gen = LAYER_CASES[case]
    if gen is not None:
        return gen(rs)
    return [rs.standard_normal((4,) + s[1:]).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_forward_and_gradient_match_jax(case):
    make, shapes, _ = LAYER_CASES[case]
    rs = np.random.default_rng(sorted(LAYER_CASES).index(case))
    xs = _inputs(case, rs)
    in_shape = shapes[0] if len(shapes) == 1 else list(shapes)
    jlayer, tlayer = make(jl), make(tl)
    jparams = jlayer.build(jax.random.PRNGKey(0), in_shape)
    tlayer.build_params(torch.Generator().manual_seed(0), in_shape)
    if jparams:
        load_jax_params(tlayer, {tlayer.name: _np_tree(jparams)})
    differentiable = case != "embedding"

    def jax_out(params, *args):
        return jlayer.call(params, args[0] if len(args) == 1 else list(args))

    want = np.asarray(jax_out(jparams, *[jnp.asarray(x) for x in xs]))
    ct = rs.standard_normal(want.shape).astype(np.float32)

    def jax_loss(params, *args):
        out = jax_out(params, *args)
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * ct)

    argnums = tuple(range(1 + len(xs))) if differentiable else (0,)
    jgrads = jax.grad(jax_loss, argnums=argnums)(
        jparams, *[jnp.asarray(x) for x in xs])

    txs = [torch.from_numpy(x.copy()).requires_grad_(differentiable)
           for x in xs]
    got = tlayer(txs[0] if len(txs) == 1 else txs)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_TOL)
    if case == "embedding":
        # out-of-range ids give NaN rows on both sides, and nothing else
        assert np.isnan(want[1]).all() and np.isnan(want[0, 2]).sum() == 0
        assert np.isnan(want).sum() == 3 * 4
    if case == "merge_cos":
        assert want.shape == (4, 1, 1)
    if case == "merge_dot":
        assert want.shape == (4, 1)
    loss = (torch.where(torch.isnan(got), 0.0, got) *
            torch.from_numpy(ct)).sum()
    tparams = dict(tlayer.named_parameters())
    targets = list(tparams.values()) + (txs if differentiable else [])
    tgrads = torch.autograd.grad(loss, targets) if targets else ()
    pairs = [(tgrads[i], np.asarray(jgrads[0][name]))
             for i, name in enumerate(tparams)]
    if differentiable:
        pairs += [(g, np.asarray(w)) for g, w in
                  zip(tgrads[len(tparams):], jgrads[1:])]
    assert len(pairs) == len(tparams) + (len(xs) if differentiable else 0)
    for g, w in pairs:
        err = np.linalg.norm(g.numpy() - w)
        assert err <= GRAD_REL_TOL * max(np.linalg.norm(w), 1e-12), \
            (case, err, np.linalg.norm(w))


def test_layer_output_shapes_match_jax():
    for case, (make, shapes, _) in LAYER_CASES.items():
        in_shape = shapes[0] if len(shapes) == 1 else list(shapes)
        assert make(tl).compute_output_shape(in_shape) == \
            make(jl).compute_output_shape(in_shape), case


# ---------------------------------------------------------------------------
# NeuralCF at bench.py's full widths
# ---------------------------------------------------------------------------

def _ncf_data(seed, n):
    """bench.py's make_data at n rows: float32 (user, item) ids from 1,
    labels 0-4."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, N_USERS + 1, n),
                  rng.integers(1, N_ITEMS + 1, n)],
                 axis=1).astype(np.float32)
    y = rng.integers(0, N_CLASSES, n).astype(np.int32)
    return x, y


def _jax_step_losses(model, x, y, batch, tmp_path, name):
    """JAX ``fit`` for one epoch (of a model compiled since its trainer
    was last made); each step's loss from its train summary."""
    model.set_tensorboard(str(tmp_path), name)
    model.fit(x, y, batch_size=batch, nb_epoch=1)
    return [v for _, _, _, v in model.model.get_train_summary("Loss")]


def _ncf_pair(include_mf):
    jncf = jrec.NeuralCF(N_USERS, N_ITEMS, N_CLASSES, include_mf=include_mf,
                         **NCF_KW)
    tncf = trec.NeuralCF(N_USERS, N_ITEMS, N_CLASSES, include_mf=include_mf,
                         **NCF_KW)
    load_jax_params(tncf.model, _np_tree(jncf.model.get_params()))
    return jncf, tncf


def _user_item_features(pkg_sample, x):
    cls = jrec.UserItemFeature if pkg_sample is JSample else \
        trec.UserItemFeature
    return [cls(int(u), int(i), pkg_sample(np.array([u, i], np.float32)))
            for u, i in x]


def _pred_tuples(preds):
    return [(p.user_id, p.item_id, p.prediction) for p in preds], \
        np.array([p.probability for p in preds])


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_fit_predict_and_recommend_match_jax(include_mf, tmp_path):
    jncf, tncf = _ncf_pair(include_mf)
    for m in (jncf, tncf):
        m.compile(optimizer=(JAdam if m is jncf else Adam)(lr=1e-3),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    x, y = _ncf_data(0, 2048)
    jlosses = _jax_step_losses(jncf, x, y, 512, tmp_path, "ncf")
    tncf.fit(x, y, batch_size=512, nb_epoch=1)
    tlosses = tncf.model.trainer.step_losses
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)

    xq, _ = _ncf_data(1, 700)
    want = np.asarray(jncf.predict(xq, batch_size=256))
    got = tncf.predict(xq, batch_size=256)
    assert got.shape == (700, N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for zero_based in (True, False):
        np.testing.assert_array_equal(
            tncf.predict_classes(xq, batch_size=256,
                                 zero_based_label=zero_based),
            np.asarray(jncf.predict_classes(xq, batch_size=256,
                                            zero_based_label=zero_based)))
    # the trained weights evaluate alike
    jres = jncf.evaluate(x, y, batch_size=300)
    tres = tncf.evaluate(x, y, batch_size=300)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    assert tres["accuracy"] == pytest.approx(jres["accuracy"], abs=1e-6)

    # a few users, many items each: recommendation lists to rank
    rs = np.random.default_rng(2)
    pairs = np.stack([rs.integers(1, 11, 200), rs.integers(1, N_ITEMS + 1,
                                                           200)],
                     1).astype(np.float32)
    jfeat = _user_item_features(JSample, pairs)
    tfeat = _user_item_features(Sample, pairs)
    for fn, args in (("predict_user_item_pair", ()),
                     ("recommend_for_user", (5,)),
                     ("recommend_for_item", (1,))):
        jt, jp = _pred_tuples(getattr(jncf, fn)(jfeat, *args))
        tt, tp = _pred_tuples(getattr(tncf, fn)(tfeat, *args))
        assert tt == jt, fn
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5, err_msg=fn)
    recs = tncf.recommend_for_user(tfeat, 5)
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append(r.probability)
    assert all(len(p) <= 5 and p == sorted(p, reverse=True)
               for p in by_user.values())
    assert all(1 <= p.prediction <= N_CLASSES for p in recs)


def test_predict_takes_a_feature_set():
    """Fault C3: ``predict`` on an ArrayFeatureSet (and on anything with
    ``to_feature_set``) equals ``predict`` on the array, and JAX's; the
    padded last batch is cut off."""
    jncf, tncf = _ncf_pair(True)
    x, _ = _ncf_data(3, 300)
    want = np.asarray(jncf.predict(JArrayFeatureSet(x), batch_size=128))
    on_array = tncf.predict(x, batch_size=128)
    on_set = tncf.predict(ArrayFeatureSet(x), batch_size=128)

    class Wrapped:
        def to_feature_set(self):
            return ArrayFeatureSet(x)

    on_wrapped = tncf.model.predict(Wrapped(), batch_size=128)
    assert on_set.shape == (300, N_CLASSES)
    np.testing.assert_array_equal(on_set, on_array)
    np.testing.assert_array_equal(on_wrapped, on_array)
    np.testing.assert_allclose(on_set, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tncf.model.predict_classes(ArrayFeatureSet(x), batch_size=128,
                                   zero_based_label=False),
        np.asarray(jncf.model.predict_classes(JArrayFeatureSet(x),
                                              batch_size=128,
                                              zero_based_label=False)))
    # FeatureSet.samples stacks Samples as the JAX package does
    fs = FeatureSet.samples([Sample(r, np.float32(i)) for i, r in
                             enumerate(x[:5])])
    np.testing.assert_array_equal(fs.features[0], x[:5])
    np.testing.assert_array_equal(fs.labels[0], np.arange(5))


def test_zoo_model_persistence_is_not_ported_yet(tmp_path):
    """Zoo-model persistence is ported now: a NeuralCF saved and loaded
    back predicts bit for bit as before, over the same 8 weight arrays
    (``tests/test_torch_model_io.py`` holds it against JAX)."""
    tncf = trec.NeuralCF(20, 10, 2, user_embed=4, item_embed=4,
                         hidden_layers=[8], mf_embed=4)
    tnn.init_nncontext(device="cpu")
    x = np.array([[1, 2], [20, 10], [5, 7]], np.float32)
    want = tncf.predict(x, batch_size=2)
    tncf.save_model(str(tmp_path / "m"))
    back = ZooModel.load_model(str(tmp_path / "m"))
    assert isinstance(back, trec.NeuralCF) and back.user_count == 20
    np.testing.assert_array_equal(back.predict(x, batch_size=2), want)
    assert len(tncf.get_weights()) == len(back.get_weights()) == 4 + 2 * 2


# ---------------------------------------------------------------------------
# WideAndDeep
# ---------------------------------------------------------------------------

def _wnd_columns(rec):
    """The JAX test's column info (tests/test_models_recommendation.py)."""
    return rec.ColumnFeatureInfo(
        wide_base_cols=["a", "b"], wide_base_dims=[5, 7],
        wide_cross_cols=["ab"], wide_cross_dims=[10],
        indicator_cols=["c"], indicator_dims=[4],
        embed_cols=["u", "v"], embed_in_dims=[20, 30],
        embed_out_dims=[8, 8], continuous_cols=["age"])


def _wnd_data(n):
    rng = np.random.default_rng(1)
    wide = rng.random((n, 5 + 7 + 10)).astype(np.float32)
    ind = (rng.random((n, 4)) > 0.5).astype(np.float32)
    emb = np.stack([rng.integers(1, 20, n), rng.integers(1, 30, n)],
                   1).astype(np.float32)
    cont = rng.random((n, 1)).astype(np.float32)
    y = (wide.sum(-1) + cont[:, 0] > wide.sum(-1).mean() +
         0.5).astype(np.int32)
    return {"wide": wide, "deep": [ind, emb, cont],
            "wide_n_deep": [wide, ind, emb, cont]}, y


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_matches_jax(model_type, tmp_path):
    jw = jrec.WideAndDeep(2, _wnd_columns(jrec), model_type=model_type,
                          hidden_layers=[16, 8])
    tw = trec.WideAndDeep(2, _wnd_columns(trec), model_type=model_type,
                          hidden_layers=[16, 8])
    load_jax_params(tw.model, _np_tree(jw.model.get_params()))
    data, y = _wnd_data(64)
    x = data[model_type]
    want = np.asarray(jw.predict(x, batch_size=64))
    got = tw.predict(x, batch_size=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    # one fit step from the same weights
    jw.compile(optimizer=JAdam(lr=0.01),
               loss="sparse_categorical_crossentropy")
    tw.compile(optimizer=Adam(lr=0.01),
               loss="sparse_categorical_crossentropy")
    jlosses = _jax_step_losses(jw, x, y, 64, tmp_path, model_type)
    tw.fit(x, y, batch_size=64, nb_epoch=1)
    np.testing.assert_allclose(tw.model.trainer.step_losses, jlosses,
                               rtol=1e-5)
    # JAX's trained weights, loaded into a copy of the port model, pair
    # each port parameter with its JAX counterpart
    want_w = copy.deepcopy(tw.model)
    load_jax_params(want_w, _np_tree(jw.model.get_params()))
    want_w = dict(want_w.named_parameters())
    for name, p in tw.model.named_parameters():
        w = want_w[name].detach().numpy()
        assert np.linalg.norm(p.detach().numpy() - w) <= \
            1e-5 * np.linalg.norm(w), name


# ---------------------------------------------------------------------------
# Sequential, to_model, new_graph, freeze_up_to
# ---------------------------------------------------------------------------

def _sequential(pkg):
    layers = jl if pkg == "jax" else tl
    seq = (jmodels if pkg == "jax" else tmodels).Sequential()
    seq.add(layers.Dense(16, activation="relu", input_shape=(6,)))
    seq.add(layers.Dense(8, activation="tanh"))
    seq.add(layers.Dense(3, activation="softmax"))
    return seq


def test_sequential_fit_and_predict_match_jax(tmp_path):
    jseq, tseq = _sequential("jax"), _sequential("torch")
    load_jax_params(tseq, _np_tree(jseq.get_params()))
    rs = np.random.default_rng(5)
    x = rs.standard_normal((40, 6)).astype(np.float32)
    y = rs.integers(0, 3, 40).astype(np.int32)
    np.testing.assert_allclose(tseq.predict(x, batch_size=16),
                               np.asarray(jseq.predict(x, batch_size=16)),
                               rtol=0, atol=1e-6)
    for m in (jseq, tseq):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jseq.set_tensorboard(str(tmp_path), "seq")
    jseq.fit(x, y, batch_size=10, nb_epoch=1)
    jlosses = [v for _, _, _, v in jseq.get_train_summary("Loss")]
    tseq.fit(x, y, batch_size=10, nb_epoch=1)
    assert len(jlosses) == 4
    np.testing.assert_allclose(tseq.trainer.step_losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(tseq.predict(x, batch_size=16),
                               np.asarray(jseq.predict(x, batch_size=16)),
                               rtol=0, atol=1e-5)
    # to_model shares the layers and weights; new_graph re-roots them
    model = tseq.to_model()
    np.testing.assert_array_equal(model.predict(x), tseq.predict(x))
    second = tseq.layers[1].name
    hidden = tseq.new_graph([second]).predict(x)
    jsub = jseq.to_model().new_graph([jseq.layers[1].name]) \
        .graph_function()
    jparams = jseq.get_params()
    want = jsub.apply({l.name: jparams[l.name] for l in jsub.layers},
                      [jnp.asarray(x)], training=False)
    np.testing.assert_allclose(hidden, np.asarray(want), rtol=0, atol=1e-5)
    assert hidden.shape == (40, 8)
    with pytest.raises(ValueError, match="first layer needs input_shape"):
        tmodels.Sequential().add(tl.Dense(2))


def _graph(pkg):
    """inputs a, b -> Dense each -> merge -> Dense -> Dense."""
    layers = jl if pkg == "jax" else tl
    a, b = layers.Input(shape=(4,)), layers.Input(shape=(3,))
    ha = layers.Dense(5)(a)
    hb = layers.Dense(5)(b)
    m = layers.merge([ha, hb], mode="concat")
    h = layers.Dense(6, activation="relu")(m)
    out = layers.Dense(2, activation="softmax")(h)
    return (jmodels if pkg == "jax" else tmodels).Model([a, b], out)


def test_freeze_up_to_freezes_the_same_layers_as_jax():
    jm, tm = _graph("jax"), _graph("torch")
    jnames = [l.name for l in jm.graph_function().layers]
    tnames = [l.name for l in tm.graph_function().layers]
    for k in (2, 3):   # the merge, then the first Dense after it
        jm.unfreeze()
        tm.unfreeze()
        jm.freeze_up_to(jnames[k])
        tm.freeze_up_to(tnames[k])
        assert sorted(tnames.index(n) for n in tm.frozen_layers()) == \
            sorted(jnames.index(n) for n in jm.frozen_layers())
    with pytest.raises(ValueError, match="unknown layers"):
        tm.freeze_up_to("nope")
