"""The port's sequence models of the zoo against the JAX package on the
CPU: TextClassifier (cnn, lstm and gru encoders, a table or token
features), AnomalyDetector, SessionRecommender (with and without the
history), KNRM (ranking and classification, NDCG and MAP) and Seq2seq
(the three cell types, the bridge types, the embedding encoder, and
``infer``). Each model is built in both packages at small widths, JAX's
weights are copied into the port with ``load_jax_params`` and the same
seeded numpy inputs go through both; ``fit`` runs step for step with
dropout off on both sides (JAX's per-step losses from its train summary).

Tolerances, float32 on both sides:
- ``predict`` within 1e-5 of the output's norm;
- each ``fit`` step's loss within 1e-5 relative, the weights after it
  within 1e-4 of each tensor's norm (recurrences of matmuls summed in
  another order by XLA's CPU dots and PyTorch's BLAS, some 1e-7 apart a
  step, moved by an adaptive optimizer's normalised step);
- KNRM's exact-match kernel (sigma 0.001) is held with an absolute 1e-4
  on its pooled value: a translation-matrix entry 1e-7 off moves
  ``exp(-0.5 d^2 / sigma^2)`` by ~1e-7, where an entry off by the same
  amount in a non-matching cell underflows to 0 on both sides;
- KNRM's ``fit`` with exact matches: each loss within 1e-4 absolute and
  the weights within 1e-3 of their norm. Once a step moves the rows off
  unit norm, an exact match's entry sits ~1e-3 from the kernel's mean,
  where ``exp(-0.5 d^2 / sigma^2)`` has slope d / sigma^2 ~ 1e3: a
  rounding of 1e-7 in the translation matrix moves the pooled value by
  ~1e-4 (the first read: 1.7e-5 on the third step's loss);
- ``infer`` within 1e-5 absolute of JAX's ``infer`` and of the port's
  ``infer_reference``; NDCG and MAP within 1e-6.
"""

import json
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.models.anomalydetection import \
    AnomalyDetector as JAnomalyDetector
from analytics_zoo_tpu.models.common import ZooModel as JZooModel
from analytics_zoo_tpu.models.recommendation import \
    SessionRecommender as JSessionRecommender
from analytics_zoo_tpu.models import seq2seq as js2s
from analytics_zoo_tpu.models.textclassification import \
    TextClassifier as JTextClassifier
from analytics_zoo_tpu.models.textmatching import KNRM as JKNRM
from analytics_zoo_tpu.models.textmatching.knrm import \
    KernelPooling as JKernelPooling
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.feature.feature_set import Sample as JSample
from analytics_zoo_tpu.common.zoo_trigger import \
    SeveralIteration as JSeveralIteration
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import Sample
from analytics_zoo_tpu_torch.models import ZooModel
from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.recommendation import \
    SessionRecommender
from analytics_zoo_tpu_torch.models import seq2seq as ts2s
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.models.textmatching.knrm import KernelPooling
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils.jax_weights import (_pair_layers,
                                                       optimizer_leaves,
                                                       param_order)

OUT_REL_TOL = 1e-5
LOSS_RTOL = 1e-5
WEIGHT_REL_TOL = 1e-4
INFER_TOL = 1e-5
EXACT_KERNEL_TOL = 1e-4
KNRM_FIT_ATOL = 1e-4
KNRM_WEIGHT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel_close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-12), \
        (what, err, np.linalg.norm(want))


def _copy_weights(jm, tm):
    load_jax_params(tm.model, _np_tree(jm.model.get_params()))


def _no_dropout(*models):
    for m in models:
        for layer in m.model.graph_function().layers:
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0


def _compare_weights(jm, tm, tol=WEIGHT_REL_TOL):
    jparams = _np_tree(jm.model.get_params())
    layers = [l for l in tm.model.graph_function().layers
              if any(True for _ in l.parameters())]
    for layer, name in _pair_layers(layers, list(jparams)):
        want = _flat(jparams[name])
        got = {k: p.detach().numpy() for k, p in layer.named_parameters()}
        assert set(got) == set(want), layer.name
        for k in got:
            _rel_close(got[k], want[k], tol, f"{layer.name}.{k}")


def _fit_both(jm, tm, x, y, batch, epochs, tmp_path, optimizer, loss,
              loss_atol=0.0, weight_tol=WEIGHT_REL_TOL):
    """Compile both with ``optimizer(package)`` and ``loss``, fit, and
    hold the step losses and the weights after them."""
    jm.compile(optimizer(jopt), loss)
    tm.compile(optimizer(topt), loss)
    jm.set_tensorboard(str(tmp_path), "jax")
    jm.fit(x, y, batch_size=batch, nb_epoch=epochs)
    jlosses = [v for _, _, _, v in jm.model.get_train_summary("Loss")]
    tm.fit(x, y, batch_size=batch, nb_epoch=epochs)
    tlosses = tm.model.trainer.step_losses
    assert len(tlosses) == len(jlosses) > 0
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL,
                               atol=loss_atol)
    _compare_weights(jm, tm, weight_tol)
    return tlosses


def _predict_close(jm, tm, x, batch=4):
    want = np.asarray(jm.predict(x, batch_size=batch))
    got = tm.predict(x, batch_size=batch)
    _rel_close(got, want, OUT_REL_TOL, "predict")
    return got


# ---------------------------------------------------------------------------
# TextClassifier
# ---------------------------------------------------------------------------

VOCAB, EMBED, SEQ, CLASSES = 30, 8, 12, 3


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (VOCAB, EMBED)).astype(np.float32) * 0.5


def _text_pair(encoder, embedding="table"):
    emb = _table() if embedding == "table" else EMBED
    kw = dict(sequence_length=SEQ, encoder=encoder, encoder_output_dim=10)
    jm = JTextClassifier(CLASSES, emb, **kw)
    tm = TextClassifier(CLASSES, emb, **kw)
    _copy_weights(jm, tm)
    _no_dropout(jm, tm)
    return jm, tm


def _text_data(seed, n, embedding="table"):
    rs = np.random.default_rng(seed)
    y = rs.integers(0, CLASSES, n).astype(np.int32)
    if embedding == "table":
        x = rs.integers(0, VOCAB, (n, SEQ)).astype(np.float32)
    else:
        x = rs.standard_normal((n, SEQ, EMBED)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("encoder,embedding",
                         [("cnn", "table"), ("lstm", "table"),
                          ("gru", "table"), ("lstm", "token_length")])
def test_text_classifier_matches_jax(encoder, embedding, tmp_path):
    jm, tm = _text_pair(encoder, embedding)
    x, y = _text_data(1, 16, embedding)
    probs = _predict_close(jm, tm, x)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    table0 = None if embedding != "table" else \
        tm.model.layers[0].table.detach().clone()
    _fit_both(jm, tm, x, y, 8, 2, tmp_path,
              lambda m: m.Adagrad(lr=0.01),
              "sparse_categorical_crossentropy")
    if table0 is not None:    # the frozen table did not move
        assert torch.equal(tm.model.layers[0].table.detach(), table0)
    jres = jm.evaluate(x, y, batch_size=6)
    tres = tm.evaluate(x, y, batch_size=6)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    _predict_close(jm, tm, x)


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_saves_and_loads_across_packages(encoder, tmp_path):
    jm, tm = _text_pair(encoder)
    x, _ = _text_data(2, 5)
    want = tm.predict(x, batch_size=4)
    tm.save_model(str(tmp_path / "port"))
    jback = JZooModel.load_model(str(tmp_path / "port"))
    assert jback.encoder == encoder and jback.token_length == EMBED
    _rel_close(np.asarray(jback.predict(x, batch_size=4)), want,
               OUT_REL_TOL)
    jback.save_model(str(tmp_path / "jax"))
    back = ZooModel.load_model(str(tmp_path / "jax"))
    assert isinstance(back, TextClassifier)
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)
    spec = json.loads((tmp_path / "port" / "keras" /
                       "architecture.json").read_text())
    assert spec["layers"][0]["class"] == \
        "analytics_zoo_tpu.pipeline.api.keras.layers.embeddings." \
        "WordEmbedding"


# ---------------------------------------------------------------------------
# AnomalyDetector
# ---------------------------------------------------------------------------

def test_anomaly_detector_matches_jax(tmp_path):
    kw = dict(feature_shape=(6, 1), hidden_layers=[4, 5, 3],
              dropouts=[0.0, 0.0, 0.0])
    jm, tm = JAnomalyDetector(**kw), AnomalyDetector(**kw)
    _copy_weights(jm, tm)
    series = np.sin(np.linspace(0, 6 * np.pi, 40, dtype=np.float32))
    feats, labels, _ = tm.unroll(series, 6)
    _predict_close(jm, tm, feats, batch=16)
    _fit_both(jm, tm, feats, labels[:, None], 16, 2, tmp_path,
              lambda m: m.Adam(lr=0.01), "mse")
    pred = tm.predict(feats, batch_size=16).reshape(-1)
    jpred = np.asarray(jm.predict(feats, batch_size=16)).reshape(-1)
    t_out = tm.detect_anomalies(labels, pred, 10)
    j_out = JAnomalyDetector.detect_anomalies(labels, jpred, 10)
    np.testing.assert_array_equal(np.isnan(t_out[2]), np.isnan(j_out[2]))
    tm.save_model(str(tmp_path / "ad"))
    back = JZooModel.load_model(str(tmp_path / "ad"))
    assert back.hidden_layers == [4, 5, 3]
    _rel_close(np.asarray(back.predict(feats, batch_size=16)).reshape(-1),
               pred, OUT_REL_TOL)


def test_anomaly_detector_unroll_and_detect_match_jax():
    data = np.arange(1, 7, dtype=np.float32)   # the reference's doc example
    feats, labels, idx = AnomalyDetector.unroll(data, 2, 1)
    np.testing.assert_array_equal(feats.squeeze(-1),
                                  [[1, 2], [2, 3], [3, 4], [4, 5]])
    np.testing.assert_array_equal(labels, [3, 4, 5, 6])
    np.testing.assert_array_equal(idx, [0, 1, 2, 3])
    rs = np.random.default_rng(4)
    series = rs.standard_normal((50, 3)).astype(np.float32)
    for unroll, step in ((5, 1), (4, 3), (60, 1)):
        for got, want in zip(AnomalyDetector.unroll(series, unroll, step),
                             JAnomalyDetector.unroll(series, unroll, step)):
            np.testing.assert_array_equal(got, np.asarray(want))
    truth, pred = rs.standard_normal(100), rs.standard_normal(100)
    for size in (1, 5, 30):
        got = AnomalyDetector.detect_anomalies(truth, pred, size)
        want = JAnomalyDetector.detect_anomalies(truth, pred, size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = AnomalyDetector.detect_anomalies_by_threshold(truth, pred, 1.0)
    want = JAnomalyDetector.detect_anomalies_by_threshold(truth, pred, 1.0)
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError, match="should be equal"):
        AnomalyDetector((4, 1), hidden_layers=[3, 3], dropouts=[0.1])


# ---------------------------------------------------------------------------
# SessionRecommender
# ---------------------------------------------------------------------------

ITEMS, SESS, HIST = 15, 5, 4


def _session_data(seed, n):
    rs = np.random.default_rng(seed)
    sess = rs.integers(1, ITEMS + 1, (n, SESS)).astype(np.float32)
    hist = rs.integers(1, ITEMS + 1, (n, HIST)).astype(np.float32)
    y = (sess[:, -1] - 1).astype(np.int32)
    return sess, hist, y


@pytest.mark.parametrize("include_history", [False, True])
def test_session_recommender_matches_jax(include_history, tmp_path):
    kw = dict(rnn_hidden_layers=[8, 6], session_length=SESS,
              include_history=include_history, mlp_hidden_layers=[7],
              history_length=HIST if include_history else 0)
    jm = JSessionRecommender(ITEMS, 6, **kw)
    tm = SessionRecommender(ITEMS, 6, **kw)
    _copy_weights(jm, tm)
    sess, hist, y = _session_data(5, 24)
    x = [sess, hist] if include_history else sess
    _predict_close(jm, tm, x, batch=8)
    _fit_both(jm, tm, x, y, 8, 1, tmp_path, lambda m: m.Adam(lr=0.01),
              "sparse_categorical_crossentropy")
    make = (lambda pkg, s, h: pkg([s, h])) if include_history else \
        (lambda pkg, s, h: pkg(s))
    jrecs = jm.recommend_for_session(
        [make(JSample, s, h) for s, h in zip(sess[:6], hist[:6])], 3,
        zero_based_label=False)
    trecs = tm.recommend_for_session(
        [make(Sample, s, h) for s, h in zip(sess[:6], hist[:6])], 3,
        zero_based_label=False)
    assert [[i for i, _ in r] for r in trecs] == \
        [[i for i, _ in r] for r in jrecs]
    np.testing.assert_allclose([[p for _, p in r] for r in trecs],
                               [[p for _, p in r] for r in jrecs],
                               rtol=0, atol=1e-5)
    for row in trecs:
        probs = [p for _, p in row]
        assert probs == sorted(probs, reverse=True) and len(row) == 3
    with pytest.raises(Exception, match="Unsupported"):
        tm.recommend_for_user([], 3)
    if include_history:
        # the Lambda's callable is not saved by definition: the port
        # pickles its own architecture, which only the port reads (the
        # JAX graph holds a lambda, which its pickle refuses)
        tm.save_model(str(tmp_path / "sr"))
        back = ZooModel.load_model(str(tmp_path / "sr"))
        np.testing.assert_array_equal(
            back.predict([sess, hist], batch_size=8),
            tm.predict([sess, hist], batch_size=8))
        return
    tm.save_model(str(tmp_path / "sr"))
    jback = JZooModel.load_model(str(tmp_path / "sr"))
    _rel_close(np.asarray(jback.predict(sess, batch_size=8)),
               tm.predict(sess, batch_size=8), OUT_REL_TOL)
    jback.save_model(str(tmp_path / "sr_jax"))
    back = ZooModel.load_model(str(tmp_path / "sr_jax"))
    np.testing.assert_array_equal(back.predict(sess, batch_size=8),
                                  tm.predict(sess, batch_size=8))


# ---------------------------------------------------------------------------
# KNRM
# ---------------------------------------------------------------------------

L1, L2, KVOCAB, KEMBED = 4, 9, 40, 12


def _unit_rows(seed):
    t = np.random.default_rng(seed).standard_normal((KVOCAB, KEMBED))
    return (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)


def _knrm_pairs(seed, n):
    """Interleaved (relevant, irrelevant) rows: the relevant doc repeats
    the query's tokens (exact matches), the other is random."""
    rs = np.random.default_rng(seed)
    q = rs.integers(1, KVOCAB, (n, L1))
    pos = np.concatenate([q, q, q], axis=1)[:, :L2]
    neg = rs.integers(1, KVOCAB, (n, L2))
    x = np.empty((2 * n, L1 + L2), np.float32)
    x[0::2] = np.concatenate([q, pos], 1)
    x[1::2] = np.concatenate([q, neg], 1)
    y = np.zeros((2 * n, 1), np.float32)
    y[0::2] = 1.0
    return x, y


def test_kernel_pooling_holds_the_exact_match_kernel():
    rs = np.random.default_rng(6)
    emb = _unit_rows(6)[rs.integers(0, KVOCAB, (3, L1 + L2))]
    emb[:, L1:L1 + L1] = emb[:, :L1]        # exact matches
    jlayer, tlayer = JKernelPooling(L1, L2, 5), KernelPooling(L1, L2, 5)
    np.testing.assert_array_equal(tlayer.mus, jlayer.mus)
    np.testing.assert_array_equal(tlayer.sigmas, jlayer.sigmas)
    assert tlayer.mus[-1] == 1.0 and tlayer.sigmas[-1] == np.float32(0.001)
    want = np.asarray(jlayer.call({}, emb))
    got = tlayer(torch.from_numpy(emb)).numpy()
    assert want[:, -1].min() > L1 * np.log(2) - 1e-3   # the kernel fires
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0,
                               atol=EXACT_KERNEL_TOL)
    _rel_close(got[:, :-1], want[:, :-1], OUT_REL_TOL)


@pytest.mark.parametrize("target_mode,loss",
                         [("ranking", "rank_hinge"),
                          ("classification", "binary_crossentropy")])
def test_knrm_matches_jax(target_mode, loss, tmp_path):
    kw = dict(embed_size=KEMBED, embed_weights=_unit_rows(7), kernel_num=7,
              target_mode=target_mode)
    jm, tm = JKNRM(L1, L2, KVOCAB, **kw), KNRM(L1, L2, KVOCAB, **kw)
    _copy_weights(jm, tm)
    x, y = _knrm_pairs(8, 16)
    out = _predict_close(jm, tm, x, batch=8)
    if target_mode == "classification":
        assert ((out >= 0) & (out <= 1)).all()
    _fit_both(jm, tm, x, y, 8, 1, tmp_path, lambda m: m.Adam(lr=0.01), loss,
              loss_atol=KNRM_FIT_ATOL, weight_tol=KNRM_WEIGHT_TOL)
    groups = [(x[i:i + 6], y[i:i + 6]) for i in range(0, 24, 6)]
    groups.append((x[1:6:2], np.zeros((3, 1), np.float32)))  # no positive
    for k in (1, 3, 10):
        assert tm.evaluate_ndcg(groups, k) == pytest.approx(
            jm.evaluate_ndcg(groups, k), abs=1e-6)
    assert tm.evaluate_map(groups) == pytest.approx(jm.evaluate_map(groups),
                                                    abs=1e-6)
    assert tm.evaluate_ndcg([], 3) == 0.0


def test_ranking_a_text_set_names_its_roadmap_item():
    """``Ranker`` takes a TextSet since ROADMAP A11.1 landed: each
    feature's sample is one query group, as a list of groups gives it
    (``tests/test_torch_text.py`` holds the TextSet route against JAX)."""
    from analytics_zoo_tpu_torch.feature.feature_set import Sample
    from analytics_zoo_tpu_torch.feature.text import TextFeature, TextSet

    tm = KNRM(L1, L2, KVOCAB, embed_size=KEMBED, kernel_num=3)
    x, y = _knrm_pairs(3, 6)
    groups = [(x[i:i + 4], y[i:i + 4]) for i in range(0, 12, 4)]
    features = []
    for feats, labels in groups:
        tf = TextFeature(uri=str(len(features)))
        tf[TextFeature.sample] = Sample(feats, labels)
        features.append(tf)
    text_set = TextSet.array(features)
    assert tm.evaluate_map(text_set) == tm.evaluate_map(groups)
    assert tm.evaluate_ndcg(text_set, 3) == tm.evaluate_ndcg(groups, 3)
    assert tm.evaluate_map(TextSet.array([])) == 0.0
    with pytest.raises(ValueError, match="target_mode"):
        KNRM(L1, L2, KVOCAB, target_mode="regression")


# ---------------------------------------------------------------------------
# Seq2seq
# ---------------------------------------------------------------------------

FEAT, HIDDEN, T_IN, T_OUT = 4, 6, 5, 3


def _seq2seq(pkg, rnn, bridge_type, nlayers=2, generator=True,
             embedding=False):
    mod = js2s if pkg is jl else ts2s
    emb = pkg.Embedding(20, FEAT) if embedding else None
    enc = mod.RNNEncoder.initialize(rnn, nlayers, HIDDEN, embedding=emb)
    dec = mod.RNNDecoder.initialize(rnn, nlayers, HIDDEN)
    if bridge_type == "customized":
        n = nlayers * (2 if rnn == "lstm" else 1)
        bridge = mod.Bridge.initialize_from_keras_layer(
            pkg.Dense(n * HIDDEN, activation="tanh"))
    elif bridge_type is None:
        bridge = None
    else:
        bridge = mod.Bridge.initialize(bridge_type, HIDDEN)
    gen = pkg.TimeDistributed(pkg.Dense(FEAT)) if generator else None
    in_shape = [T_IN] if embedding else [T_IN, FEAT]
    feat = FEAT if generator else HIDDEN
    return mod.Seq2seq(enc, dec, in_shape, [T_OUT, feat], bridge=bridge,
                       generator=gen)


def _s2s_pair(*args, **kw):
    jm, tm = _seq2seq(jl, *args, **kw), _seq2seq(tl, *args, **kw)
    _copy_weights(jm, tm)
    return jm, tm


def _s2s_data(seed, n, embedding=False, feat=FEAT):
    rs = np.random.default_rng(seed)
    x_enc = rs.integers(0, 20, (n, T_IN)).astype(np.float32) if embedding \
        else rs.standard_normal((n, T_IN, FEAT)).astype(np.float32)
    x_dec = rs.standard_normal((n, T_OUT, feat)).astype(np.float32)
    y = rs.standard_normal((n, T_OUT, feat)).astype(np.float32)
    return [x_enc, x_dec], y


S2S_CASES = [("lstm", "dense", False), ("gru", "densenonlinear", False),
             ("simplernn", "customized", False), ("lstm", None, False),
             ("gru", "dense", True)]


@pytest.mark.parametrize("rnn,bridge_type,embedding", S2S_CASES)
def test_seq2seq_matches_jax(rnn, bridge_type, embedding, tmp_path):
    jm, tm = _s2s_pair(rnn, bridge_type, embedding=embedding)
    enc = tm.model.graph_function().layers[0]
    assert isinstance(enc, ts2s.RNNEncoder)
    want_keys = {"l0.W", "l0.U", "l0.b", "l1.W", "l1.U", "l1.b"} | \
        ({"embedding.table"} if embedding else set())
    assert {k for k, _ in enc.named_parameters()} == want_keys
    x, y = _s2s_data(9, 8, embedding)
    out = _predict_close(jm, tm, x)
    assert out.shape == (8, T_OUT, FEAT)
    _fit_both(jm, tm, x, y, 4, 1, tmp_path, lambda m: m.Adam(lr=0.01),
              "mse")
    src = x[0][:3]
    start = np.random.default_rng(10).standard_normal(FEAT).astype(
        np.float32)
    want = js2s.Seq2seq.infer(jm, src, start, max_seq_len=4)
    got = tm.infer(src, start, max_seq_len=4)
    assert got.shape == want.shape == (3, 5, FEAT)
    np.testing.assert_allclose(got, want, rtol=0, atol=INFER_TOL)


@pytest.mark.parametrize("rnn", ["lstm", "gru", "simplernn"])
def test_cached_infer_matches_the_reference_loop(rnn):
    """``infer`` (states carried, one decoder step a token) equals
    ``infer_reference`` (the whole model re-run per token), start sign
    included (tests/test_seq2seq_decode.py's cases, nlayers 1)."""
    tm = _seq2seq(tl, rnn, "dense", nlayers=1)
    rs = np.random.default_rng(0)
    x = rs.standard_normal((T_IN, FEAT)).astype(np.float32)
    start = rs.standard_normal((FEAT,)).astype(np.float32)
    old = tm.infer_reference(x, start, max_seq_len=6)
    new = tm.infer(x, start, max_seq_len=6)
    assert old.shape == new.shape == (1, 7, FEAT)
    assert float(np.abs(old - new).max()) < INFER_TOL


def test_cached_infer_stop_sign_and_build_output_parity():
    tm = _seq2seq(tl, "lstm", "dense", nlayers=2, generator=False)
    rs = np.random.default_rng(1)
    x = rs.standard_normal((T_IN, FEAT)).astype(np.float32)
    start = rs.standard_normal((HIDDEN,)).astype(np.float32)
    stop = tm.infer_reference(x, start, max_seq_len=4)[0, 2]
    old = tm.infer_reference(x, start, max_seq_len=8, stop_sign=stop)
    new = tm.infer(x, start, max_seq_len=8, stop_sign=stop)
    assert old.shape == new.shape == (1, 3, HIDDEN)
    assert float(np.abs(old - new).max()) < INFER_TOL

    def build_output(seq):
        return np.tanh(np.asarray(seq)) * 0.5

    old = tm.infer_reference(x, start, max_seq_len=4,
                             build_output=build_output)
    new = tm.infer(x, start, max_seq_len=4, build_output=build_output)
    assert old.shape == new.shape
    assert float(np.abs(old - new).max()) < INFER_TOL


def test_cached_infer_batched_stop_freezes_rows():
    """B > 1 with a stop sign: a finished row repeats its stop token while
    the other decodes on, as the JAX ``infer`` does."""
    jm, tm = _s2s_pair("lstm", "dense", nlayers=1, generator=False)
    rs = np.random.default_rng(3)
    x = rs.standard_normal((2, T_IN, FEAT)).astype(np.float32)
    start = rs.standard_normal((HIDDEN,)).astype(np.float32)
    free = tm.infer(x, start, max_seq_len=5)
    stop = free[0, 2]
    out = tm.infer(x, start, max_seq_len=5, stop_sign=stop)
    want = js2s.Seq2seq.infer(jm, x, start, max_seq_len=5, stop_sign=stop)
    np.testing.assert_allclose(out, want, rtol=0, atol=INFER_TOL)
    assert out.shape == free.shape
    np.testing.assert_array_equal(out[0, 3:], np.repeat(stop[None], 3, 0))
    np.testing.assert_allclose(out[1], free[1], rtol=0, atol=1e-6)


def test_seq2seq_saves_and_loads_across_packages(tmp_path):
    """Without a bridge, both ways. With one, JAX cannot rebuild the
    saved graph (its Bridge needs Seq2seq to set the state count;
    ROADMAP C7); the port takes the count from the encoder's outputs, so
    it loads both its own file and JAX's."""
    x, _ = _s2s_data(11, 3)
    jm, tm = _s2s_pair("lstm", None)
    want = tm.predict(x, batch_size=4)
    tm.save_model(str(tmp_path / "plain"))
    jback = JZooModel.load_model(str(tmp_path / "plain"))
    _rel_close(np.asarray(jback.predict(x, batch_size=4)), want,
               OUT_REL_TOL)
    jback.save_model(str(tmp_path / "plain_jax"))
    back = ZooModel.load_model(str(tmp_path / "plain_jax"))
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)

    jm, tm = _s2s_pair("gru", "dense")
    want = tm.predict(x, batch_size=4)
    tm.save_model(str(tmp_path / "bridge"))
    back = ZooModel.load_model(str(tmp_path / "bridge"))
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)
    with pytest.raises(AssertionError, match="Bridge"):
        JZooModel.load_model(str(tmp_path / "bridge"))
    jm.save_model(str(tmp_path / "bridge_jax"))
    back = ZooModel.load_model(str(tmp_path / "bridge_jax"))
    _rel_close(back.predict(x, batch_size=4),
               np.asarray(jm.predict(x, batch_size=4)), OUT_REL_TOL)


def test_seq2seq_shapes_and_errors_match_jax():
    for rnn, bridge_type, embedding in S2S_CASES:
        jm = _seq2seq(jl, rnn, bridge_type, embedding=embedding)
        tm = _seq2seq(tl, rnn, bridge_type, embedding=embedding)
        jshapes = [v.shape for v in jm.model.outputs]
        tshapes = [v.shape for v in tm.model.outputs]
        assert tshapes == jshapes
    with pytest.raises(ValueError, match="rnn_type"):
        ts2s.RNNEncoder.initialize("transformer", 1, 4)
    with pytest.raises(ValueError, match="bridge_type"):
        ts2s.Bridge("conv", 4)
    with pytest.raises(TypeError, match="cannot be None"):
        ts2s.Seq2seq(ts2s.RNNEncoder.initialize("gru", 1, 4),
                     ts2s.RNNDecoder.initialize("gru", 1, 4), None, [3, 4])


# ---------------------------------------------------------------------------
# a JAX checkpoint of each new parameter tree resumes in the port
# ---------------------------------------------------------------------------

def _bidirectional_pair():
    def build(pkg, seq_cls):
        model = seq_cls()
        model.add(pkg.Bidirectional(pkg.LSTM(4, return_sequences=True),
                                    input_shape=(T_IN, FEAT)))
        model.add(pkg.TimeDistributed(pkg.Dense(3)))
        return model

    from analytics_zoo_tpu.pipeline.api.keras.models import \
        Sequential as JSequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    jk, tk = build(jl, JSequential), build(tl, Sequential)
    load_jax_params(tk, _np_tree(jk.get_params()))
    return jk, tk


def _resume_case(case):
    """(JAX Keras model, port Keras model holding its weights, x, y, loss,
    the port parameter paths a case's tree is about)."""
    rs = np.random.default_rng(13)
    if case == "text_classifier_lstm_frozen_table":
        jm, tm = _text_pair("lstm")
        x, y = _text_data(3, 12)
        return jm.model, tm.model, x, y, \
            "sparse_categorical_crossentropy", ".table"
    if case == "seq2seq_nested_coder":
        jm, tm = _s2s_pair("gru", "dense", embedding=True)
        x, _ = _s2s_data(14, 12, embedding=True)
        y = rs.standard_normal((12, T_OUT, FEAT)).astype(np.float32)
        return jm.model, tm.model, x, y, "mse", ".l1.U"
    jk, tk = _bidirectional_pair()
    x = rs.standard_normal((12, T_IN, FEAT)).astype(np.float32)
    y = rs.standard_normal((12, T_IN, 3)).astype(np.float32)
    return jk, tk, x, y, "mse", ".forward.W"


@pytest.mark.parametrize("case", ["text_classifier_lstm_frozen_table",
                                  "seq2seq_nested_coder",
                                  "bidirectional_role_keys"])
def test_a_jax_checkpoint_resumes_in_the_port(case, tmp_path):
    """The model trains 3 Adagrad steps in JAX with a checkpoint; the port
    restores it under its own layer names and trains the next epoch's 3
    steps: the losses, the weights and Adagrad's accumulators (in optax's
    leaf order: the frozen table's, the coders' nested ``l{i}`` and
    ``embedding`` trees, the wrappers' role keys) agree with JAX
    continuing. A frozen table does not move."""
    jk, tk, x, y, loss, path = _resume_case(case)
    for m, pkg in ((jk, jopt), (tk, topt)):
        m.compile(pkg.Adagrad(lr=0.01), loss)
    jk.set_tensorboard(str(tmp_path / "tb"), "jax")
    jk.set_checkpoint(str(tmp_path / "ckpt"), trigger=JSeveralIteration(3))
    jk.fit(x, y, batch_size=4, nb_epoch=1)
    shutil.copytree(tmp_path / "ckpt", tmp_path / "at3")
    jk.fit(x, y, batch_size=4, nb_epoch=1)
    jlosses = [v for _, _, _, v in jk.get_train_summary("Loss")][3:]
    assert len(jlosses) == 3
    # the file's layer names (JAX's numbering) pair with the port's
    names = list(_np_tree(jk.get_params()))
    order = param_order(tk, names)
    assert any(k.endswith(path) for k in order)

    trainer = tk._ensure_trainer()
    trainer.load_checkpoint(str(tmp_path / "at3"))
    at3 = {k: p.detach().clone() for k, p in tk.named_parameters()}
    tk.fit(x, y, batch_size=4, nb_epoch=1)
    np.testing.assert_allclose(trainer.step_losses, jlosses, rtol=LOSS_RTOL)
    _compare_weights(types.SimpleNamespace(model=jk),
                     types.SimpleNamespace(model=tk))
    frozen = path if case.endswith("frozen_table") else None
    for k, p in tk.named_parameters():
        moved = not torch.equal(p.detach(), at3[k])
        assert moved != (frozen is not None and k.endswith(frozen)), k
    want = [np.asarray(l) for l in
            jax.tree_util.tree_leaves(jk.trainer.opt_state)]
    got = optimizer_leaves(trainer.opt_state, order)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g.detach().numpy() if torch.is_tensor(g) else g)
        _rel_close(g, w, WEIGHT_REL_TOL)


# ---------------------------------------------------------------------------
# training to a signal (tests/test_models_nlp_anomaly.py's cases, the port)
# ---------------------------------------------------------------------------

def _text_classifier_signal():
    vocab, seq_len, classes = 50, 20, 3
    table = np.random.default_rng(0).standard_normal((vocab, 16)) * 0.1
    clf = TextClassifier(classes, table.astype(np.float32),
                         sequence_length=seq_len, encoder="cnn",
                         encoder_output_dim=32)
    rng = np.random.default_rng(1)
    # class k = sequences dominated by tokens from band k
    y = rng.integers(0, classes, 256).astype(np.int32)
    x = np.stack([rng.integers(k * vocab // classes,
                               (k + 1) * vocab // classes, seq_len)
                  for k in y]).astype(np.float32)
    clf.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    clf.fit(x, y, batch_size=64, nb_epoch=8)
    return clf.evaluate(x, y, batch_size=64)["accuracy"], 0.85


def _anomaly_detector_signal():
    t = np.linspace(0, 12 * np.pi, 400, dtype=np.float32)
    feats, labels, _ = AnomalyDetector.unroll(np.sin(t), 10)
    ad = AnomalyDetector(feature_shape=(10, 1), hidden_layers=[8, 8],
                         dropouts=[0.0, 0.0])
    ad.compile(topt.Adam(lr=0.01), "mse")
    ad.fit(feats, labels[:, None], batch_size=64, nb_epoch=40)
    pred = ad.predict(feats, batch_size=128).reshape(-1)
    return -float(np.mean((pred - labels) ** 2)), -0.05


def _seq2seq_signal():
    feat, hidden = 3, 16
    s2s = ts2s.Seq2seq(ts2s.RNNEncoder.initialize("gru", 1, hidden),
                       ts2s.RNNDecoder.initialize("gru", 1, hidden),
                       [4, feat], [2, feat],
                       bridge=ts2s.Bridge("dense", hidden),
                       generator=tl.Dense(feat))
    rng = np.random.default_rng(0)
    x_enc = rng.standard_normal((128, 4, feat)).astype(np.float32)
    x_dec = np.zeros((128, 2, feat), np.float32)
    y = np.repeat(x_enc.mean(axis=1, keepdims=True), 2, axis=1)
    s2s.compile("adam", "mse")
    s2s.fit([x_enc, x_dec], y, batch_size=32, nb_epoch=30)
    pred = s2s.predict([x_enc, x_dec], batch_size=64)
    return -float(np.mean((pred - y) ** 2)), -0.05


SIGNAL_CASES = {"text_classifier_cnn_accuracy": _text_classifier_signal,
                "anomaly_detector_sine_mse": _anomaly_detector_signal,
                "seq2seq_copy_mean_mse": _seq2seq_signal}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_the_sequence_models_train_to_a_signal(case):
    """The JAX side's train-to-signal cases with their thresholds: the
    cnn classifier above 0.85 accuracy on banded tokens, the forecaster
    below 0.05 MSE on a sine, Seq2seq below 0.05 MSE copying a mean
    (scores negated so that higher is better)."""
    got, floor = SIGNAL_CASES[case]()
    assert got > floor, (case, got)
