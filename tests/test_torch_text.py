"""The port's text features (``feature/common.py``, ``feature/text``)
against the JAX package on the CPU, and KNRM's ranking route through
them: ``TimeDistributed(knrm.model)`` fitted with ``rank_hinge`` on a
``from_relation_pairs`` TextSet, NDCG and MAP on a
``from_relation_lists`` TextSet.

The text pipeline is host numpy in both packages, so its results are
held exactly: tokens, the word index, indices, shaped sequences, the
relation pairs drawn and the relation features and labels. KNRM's
``fit`` losses are held step for step at 1e-4 relative (the exact-match
kernel's slope, see ``test_torch_text_models.py``) with JAX's weights
copied by ``load_jax_params``; NDCG and MAP within 1e-6.
"""

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature.text import TextFeature as JTextFeature
from analytics_zoo_tpu.feature.text import TextSet as JTextSet
from analytics_zoo_tpu.models.textmatching import KNRM as JKNRM
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature import common as tcommon
from analytics_zoo_tpu_torch.feature.text import (TextFeature, TextSet,
                                                  Tokenizer, Normalizer)
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import base as tbase
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.utils import load_jax_params

L1, L2, EMBED, KERNELS = 5, 12, 8, 5
FIT_RTOL = 1e-4
RANK_TOL = 1e-6


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _word(i):
    """A lower-case alphabetic word for index i (base 26, two letters)."""
    return chr(97 + i // 26 % 26) + chr(97 + i % 26)


def _texts(seed, n, length, vocab=60):
    """n seeded texts of ``length`` words: mixed case, punctuation and a
    token with no letter, which the normalizer drops."""
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [_word(int(i)) for i in rs.integers(0, vocab, length)]
        words[0] = words[0].upper()
        words[-1] += ","
        out.append("  ".join(words) + " 42 !")
    return out


def _corpus(pkg_feature, pkg_set, texts, prefix):
    return pkg_set.array([pkg_feature(t, uri=f"{prefix}{i}")
                          for i, t in enumerate(texts)])


def _relations(seed, n_queries, n_docs, per_query=4):
    rs = np.random.default_rng(seed)
    rows = []
    for q in range(n_queries):
        docs = rs.choice(n_docs, per_query, replace=False)
        for j, d in enumerate(docs):
            rows.append((f"q{q}", f"d{d}", int(j < 2)))
    return rows


def _pipelines(seed=0, n_queries=8, n_docs=20):
    """Both packages' corpora through tokenize, normalize, word2idx and
    shape_sequence, and the relations over them."""
    qtexts, dtexts = _texts(seed, n_queries, 4), _texts(seed + 1, n_docs, 14)
    out = {}
    for name, feat, tset in (("jax", JTextFeature, JTextSet),
                             ("torch", TextFeature, TextSet)):
        q = _corpus(feat, tset, qtexts, "q")
        d = _corpus(feat, tset, dtexts, "d")
        q.tokenize().normalize().word2idx().shape_sequence(L1)
        d.tokenize().normalize().word2idx(
            existing_map=q.get_word_index()).shape_sequence(L2, "post")
        out[name] = (q, d)
    return out, _relations(seed + 2, n_queries, n_docs)


def _rels(module, rows):
    return [module.Relation(a, b, c) for a, b, c in rows]


def _samples(ts):
    return [(s.features[0], s.labels[0]) for s in ts.get_samples()]


def test_text_pipeline_matches_jax():
    sets, _ = _pipelines()
    for (jset, tset) in zip(sets["jax"], sets["torch"]):
        assert tset.get_word_index() == jset.get_word_index()
        assert tset.get_uris() == jset.get_uris()
        for jf, tf in zip(jset.features, tset.features):
            assert tf.get_tokens() == jf.get_tokens()
            assert tf.get_indices().dtype == np.float32
            np.testing.assert_array_equal(tf.get_indices(),
                                          jf.get_indices())
    # the normalizer dropped the token without letters
    assert all("" not in f.get_tokens() for f in sets["torch"][0].features)


def test_relation_builders_match_jax():
    sets, rows = _pipelines()
    (jq, jd), (tq, td) = sets["jax"], sets["torch"]
    jr, tr = _rels(jcommon, rows), _rels(tcommon, rows)
    jpairs = jcommon.Relations.generate_relation_pairs(jr, seed=3)
    tpairs = tcommon.Relations.generate_relation_pairs(tr, seed=3)
    assert [tuple(vars(p).values()) for p in tpairs] == \
        [tuple(vars(p).values()) for p in jpairs]
    for build in ("from_relation_pairs", "from_relation_lists"):
        jts = getattr(JTextSet, build)(jr, jq, jd)
        tts = getattr(TextSet, build)(tr, tq, td)
        assert tts.get_uris() == jts.get_uris()
        for (jx, jy), (tx, ty) in zip(_samples(jts), _samples(tts)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        jfs, tfs = jts.to_feature_set(), tts.to_feature_set()
        np.testing.assert_array_equal(tfs.features[0], jfs.features[0])
        np.testing.assert_array_equal(tfs.labels[0], jfs.labels[0])
    pairs = TextSet.from_relation_pairs(tr, tq, td)
    assert pairs.get_samples()[0].features[0].shape == (2, L1 + L2)


def test_text_set_readers_word_index_and_split(tmp_path):
    texts = _texts(4, 6, 7)
    for i, t in enumerate(texts):
        cat = tmp_path / "tree" / ("neg" if i % 2 else "pos")
        cat.mkdir(parents=True, exist_ok=True)
        (cat / f"doc{i}.txt").write_text(t)
    csv_path = tmp_path / "corpus.csv"
    csv_path.write_text("".join(f"u{i},{t}\n" for i, t in enumerate(texts)))
    rel_path = tmp_path / "rel.csv"
    rel_path.write_text("id1,id2,label\nq0,d1,1\nq0,d2,0\nq1,d1,0.0\n")
    got = {}
    for name, tset, module in (("jax", JTextSet, jcommon),
                               ("torch", TextSet, tcommon)):
        tree = tset.read(str(tmp_path / "tree"))
        csv_set = tset.read_csv(str(csv_path))
        csv_set.tokenize().normalize().word2idx(remove_topN=1,
                                                max_words_num=20)
        parts = csv_set.random_split([0.5, 0.5], seed=2)
        wi = tmp_path / f"{name}.txt"
        csv_set.save_word_index(str(wi))
        loaded = tset.array([]).load_word_index(str(wi)).get_word_index()
        got[name] = dict(
            tree=(tree.get_uris(), tree.get_labels(), tree.get_texts()),
            csv=(csv_set.get_uris(), csv_set.get_word_index()),
            split=[p.get_uris() for p in parts],
            loaded=loaded,
            rel=[tuple(vars(r).values())
                 for r in module.Relations.read(str(rel_path))])
    assert got["torch"] == got["jax"]
    assert got["torch"]["loaded"] == got["torch"]["csv"][1]


def test_transform_workers_and_preprocessing_match_jax():
    texts = _texts(5, 9, 6)
    seq = _corpus(TextFeature, TextSet, texts, "s").tokenize().normalize()
    par = _corpus(TextFeature, TextSet, texts, "s").transform(
        Tokenizer() >> Normalizer(), num_workers=3)
    assert [f.get_tokens() for f in par.features] == \
        [f.get_tokens() for f in seq.features]
    xs = [np.arange(6) * i for i in range(5)]
    for module in (jcommon, tcommon):
        chain = module.SeqToTensor((2, 3)) >> module.TensorToSample()
        assert isinstance(chain, module.ChainedPreprocessing)
    jb = list(jcommon.SampleToMiniBatch(2)(
        (jcommon.SeqToTensor((2, 3)) >> jcommon.TensorToSample())(iter(xs))))
    tb = list(tcommon.SampleToMiniBatch(2)(
        (tcommon.SeqToTensor((2, 3)) >> tcommon.TensorToSample())(iter(xs))))
    assert len(tb) == len(jb) == 3
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.inputs[0], j.inputs[0])
        np.testing.assert_array_equal(t.weights, j.weights)
    fl = [tcommon.FeatureLabelPreprocessing(tcommon.ArrayToTensor(),
                                            tcommon.ScalarToTensor()),
          jcommon.FeatureLabelPreprocessing(jcommon.ArrayToTensor(),
                                            jcommon.ScalarToTensor())]
    ts_, js_ = (p.apply(([1, 2], 3)) for p in fl)
    np.testing.assert_array_equal(ts_.features[0], js_.features[0])
    np.testing.assert_array_equal(ts_.labels[0], js_.labels[0])
    parts = tcommon.SeqToMultipleTensors([(2,), (1, 2)]).apply([1, 2, 3, 4])
    assert [p.shape for p in parts] == [(2,), (1, 2)]


def _unit_table(seed, vocab):
    t = np.random.default_rng(seed).standard_normal((vocab, EMBED))
    return (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)


def test_knrm_ranks_text_sets_as_jax_does(tmp_path):
    """KNRM's ranking route as the reference takes it: the zoo model's
    graph under TimeDistributed, trained by ``fit`` with ``rank_hinge``
    on relation pairs (each pair a whole (2, len1 + len2) sample, so the
    shuffle keeps it whole), then ``evaluate_ndcg``/``evaluate_map`` on
    relation lists, step for step against JAX from copied weights."""
    sets, rows = _pipelines(seed=9, n_queries=8, n_docs=20)
    vocab = len(sets["torch"][1].get_word_index()) + 1
    # the wrapped graphs' layers are auto-named; fresh counters give both
    # packages the same names, which ``load_jax_params`` pairs inside the
    # wrapper
    jbase._name_counters.clear()
    tbase._name_counters.clear()
    kw = dict(embed_size=EMBED, embed_weights=_unit_table(1, vocab),
              kernel_num=KERNELS, target_mode="ranking")
    jk, tk = JKNRM(L1, L2, vocab, **kw), KNRM(L1, L2, vocab, **kw)
    jm, tm = JSequential(), Sequential()
    jm.add(jl.TimeDistributed(jk.model, input_shape=(2, L1 + L2)))
    tm.add(tl.TimeDistributed(tk.model, input_shape=(2, L1 + L2)))
    jm.compile(jopt.Adam(lr=0.01), "rank_hinge")
    tm.compile(topt.Adam(lr=0.01), "rank_hinge")
    jm.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))

    (jq, jd), (tq, td) = sets["jax"], sets["torch"]
    jr, tr = _rels(jcommon, rows), _rels(tcommon, rows)
    jpairs = JTextSet.from_relation_pairs(jr, jq, jd)
    tpairs = TextSet.from_relation_pairs(tr, tq, td)
    assert len(tpairs) == 16
    jm.fit(jpairs, batch_size=4, nb_epoch=2)
    tm.fit(tpairs, batch_size=4, nb_epoch=2)
    jlosses = [v for _, _, _, v in jm.get_train_summary("Loss")]
    tlosses = tm.trainer.step_losses
    assert len(tlosses) == len(jlosses) == 8
    np.testing.assert_allclose(tlosses, jlosses, rtol=FIT_RTOL)

    # the port's wrapper shares knrm.model's weights, as the reference's
    # TimeDistributed does; JAX's trains a params tree of its own, so
    # its KNRM takes the trained weights from the port to rank with them
    trained = tk.model.get_weights()
    np.testing.assert_array_equal(
        trained[0], tm.graph_function().layers[0].layer.get_weights()[0])
    jk.model.set_weights(trained)
    jlists = JTextSet.from_relation_lists(jr, jq, jd)
    tlists = TextSet.from_relation_lists(tr, tq, td)
    assert len(tlists) == 8
    for k in (1, 3):
        assert tk.evaluate_ndcg(tlists, k) == pytest.approx(
            jk.evaluate_ndcg(jlists, k), abs=RANK_TOL)
    assert tk.evaluate_map(tlists) == pytest.approx(
        jk.evaluate_map(jlists), abs=RANK_TOL)
