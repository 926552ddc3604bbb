"""The port's ``tfpark.text`` against the JAX package on the CPU: the
cases of tests/test_tfpark_text.py, held step for step.

``NER`` (both CRF modes), ``SequenceTagger`` (word-only and word+char,
softmax and CRF) and ``IntentEntity`` at a few units, dropout 0: the port
takes the JAX model's initial weights (``load_jax_params``), both fit the
same batches, and each step's loss agrees within 1e-5 (relative), the
weights after it within 2e-5, paired by layer (tests/torch_parity.py);
``predict`` rows within 1e-5 and ``predict_tags`` exactly. Saved models
load across the packages both ways. The BERT estimators at 2 blocks,
hidden 32, 2 heads, seq 16, dropout 0: ``train`` losses step for step,
``evaluate`` and ``predict`` within 1e-5, ``model_dir`` /
``init_checkpoint`` both ways, a ``bert_config_file``, BERTSQuAD's
start/end rows and BERTNER's shapes. Two float32 LSTM stacks or
transformer blocks summed in another order (XLA's CPU dots against
PyTorch's BLAS) give gradients some 1e-6 apart, and Adam's normalised
step keeps each weight's drift a small multiple of that.
"""

import json
import os

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.tfpark import text as jtext
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.tfpark import text as ttext
from analytics_zoo_tpu_torch.utils import load_jax_params
from torch_parity import assert_weights_match

LOSS_RTOL, WEIGHT_TOL, ROW_TOL = 1e-5, 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1), device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tag_data(n=24, vocab=30, cvocab=12, seq=6, wlen=4, n_tags=5, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    chars = rng.integers(0, cvocab, (n, seq, wlen)).astype(np.int32)
    tags = rng.integers(0, n_tags, (n, seq)).astype(np.int32)
    return words, chars, tags


def _copy(jobj, tobj, tmp_path):
    """The port model takes the JAX model's initial weights. The JAX
    model's train summary is set first: ``get_params`` builds its
    trainer, which takes the summary only at its making."""
    jobj.model.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(tobj.model, _np_tree(jobj.model.get_params()))


def _fit_both(jobj, tobj, x, y, tmp_path, batch_size=8, epochs=1):
    """Fit both from the same weights; return the losses of each step
    (JAX's from its train summary, the port's from its trainer)."""
    jobj.fit(x, y, batch_size=batch_size, epochs=epochs)
    tobj.fit(x, y, batch_size=batch_size, epochs=epochs)
    jlosses = [v for _, _, _, v in jobj.model.get_train_summary("Loss")]
    tlosses = list(tobj.model.trainer.step_losses)
    assert len(tlosses) == len(jlosses) > 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL, atol=0)
    assert_weights_match(tobj.model, _np_tree(jobj.model.get_params()),
                         atol=WEIGHT_TOL)
    return jlosses


def _rows_close(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=ROW_TOL)


_NER_KW = dict(num_entities=5, word_vocab_size=30, char_vocab_size=12,
               word_length=4, word_emb_dim=8, char_emb_dim=4,
               tagger_lstm_dim=8, dropout=0.0)


@pytest.mark.parametrize("crf_mode", ["reg", "pad"])
def test_ner_fits_and_decodes_like_jax(crf_mode, tmp_path):
    words, chars, tags = _tag_data()
    jner = jtext.NER(crf_mode=crf_mode, **_NER_KW)
    tner = ttext.NER(crf_mode=crf_mode, **_NER_KW)
    _copy(jner, tner, tmp_path)
    x = [words, chars]
    if crf_mode == "pad":
        lens = np.random.default_rng(7).integers(1, 7, (24,)).astype(
            np.int32)
        x.append(lens)
    _fit_both(jner, tner, x, tags, tmp_path)
    probe = [a[:6] for a in x]
    _rows_close(tner.model.predict(probe), jner.model.predict(probe))
    jtags = np.asarray(jner.predict_tags(probe))
    ttags = tner.predict_tags(probe)
    np.testing.assert_array_equal(ttags, jtags)
    if crf_mode == "pad":
        # tags past each sentence's length are 0 (the decode's mask)
        assert all(not ttags[i, lens[i]:].any() for i in range(6))
    onehot = tner.predict(probe)
    assert onehot.shape == (6, 6, 5)
    np.testing.assert_array_equal(onehot, np.asarray(jner.predict(probe)))


def test_ner_crf_mode_validation_raises_as_jax():
    with pytest.raises(ValueError) as jerr:
        jtext.NER(num_entities=3, word_vocab_size=10, char_vocab_size=5,
                  crf_mode="bogus")
    with pytest.raises(ValueError) as terr:
        ttext.NER(num_entities=3, word_vocab_size=10, char_vocab_size=5,
                  crf_mode="bogus")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jtext.SequenceTagger(4, 3, 30, classifier="bogus")
    with pytest.raises(ValueError) as terr:
        ttext.SequenceTagger(4, 3, 30, classifier="bogus")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ner_saved_model_loads_across_packages(direction, tmp_path):
    words, chars, tags = _tag_data()
    jner = jtext.NER(**_NER_KW)
    tner = ttext.NER(**_NER_KW)
    _copy(jner, tner, tmp_path)
    probe = [words[:4], chars[:4]]
    want = tner.predict(probe)
    np.testing.assert_array_equal(want, np.asarray(jner.predict(probe)))
    path = str(tmp_path / "ner")
    if direction == "jax_to_port":
        jner.save_model(path)
        again = ttext.NER.load_model(path)
        assert type(again.model) is type(tner.model)
        got = again.predict(probe)
        rows = again.model.predict(probe)
    else:
        tner.save_model(path)
        again = jtext.NER.load_model(path)
        got = np.asarray(again.predict(probe))
        rows = again.model.predict(probe)
    np.testing.assert_array_equal(got, want)
    _rows_close(rows, tner.model.predict(probe))


@pytest.mark.parametrize("classifier", ["softmax", "crf"])
@pytest.mark.parametrize("chars_too", [False, True])
def test_sequence_tagger_fits_like_jax(classifier, chars_too, tmp_path):
    words, chars, _ = _tag_data()
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4, (24, 6)).astype(np.int32)
    chunk = rng.integers(0, 3, (24, 6)).astype(np.int32)
    kw = dict(num_pos_labels=4, num_chunk_labels=3, word_vocab_size=30,
              feature_size=8, dropout=0.0, classifier=classifier)
    if chars_too:
        kw.update(char_vocab_size=12, word_length=4)
    jtag, ttag = jtext.SequenceTagger(**kw), ttext.SequenceTagger(**kw)
    _copy(jtag, ttag, tmp_path)
    x = [words, chars] if chars_too else words
    _fit_both(jtag, ttag, x, [pos, chunk], tmp_path)
    probe = [words[:4], chars[:4]] if chars_too else words[:4]
    got, want = ttag.predict(probe), jtag.predict(probe)
    assert [g.shape for g in got] == [(4, 6, 4), (4, 6, 3)]
    if classifier == "crf":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        _rows_close(ttag.model.predict(probe), jtag.model.predict(probe))
    else:
        _rows_close(got, want)


def test_intent_entity_fits_like_jax(tmp_path):
    words, chars, tags = _tag_data()
    intents = np.random.default_rng(2).integers(0, 3, (24,)).astype(
        np.int32)
    kw = dict(num_intents=3, num_entities=5, word_vocab_size=30,
              char_vocab_size=12, word_length=4, word_emb_dim=8,
              char_emb_dim=4, char_lstm_dim=4, tagger_lstm_dim=8,
              dropout=0.0)
    jie, tie = jtext.IntentEntity(**kw), ttext.IntentEntity(**kw)
    _copy(jie, tie, tmp_path)
    _fit_both(jie, tie, [words, chars], [intents, tags], tmp_path)
    probe = [words[:4], chars[:4]]
    got = tie.predict(probe)
    assert [g.shape for g in got] == [(4, 3), (4, 6, 5)]
    _rows_close(got, jie.predict(probe))
    res_t = tie.evaluate([words, chars], [intents, tags], batch_size=8)
    res_j = jie.evaluate([words, chars], [intents, tags], batch_size=8)
    np.testing.assert_allclose(res_t["loss"], res_j["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the BERT estimators
# ---------------------------------------------------------------------------

_TINY = dict(vocab_size=40, hidden_size=32, n_block=2, n_head=2,
             seq_length=16, intermediate_size=64)


def _bert_features(n=16, seq=16, vocab=40, seed=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, seq))
    for i, k in enumerate(rng.integers(seq // 2, seq + 1, n)):
        mask[i, k:] = 0.0                       # padding at the tail
    return {"input_ids": rng.integers(0, vocab, (n, seq)),
            "input_mask": mask,
            "token_type_ids": np.zeros((n, seq))}


def _no_dropout(est):
    est.bert.hidden_p_drop = est.bert.attn_p_drop = 0.0
    return est


def _pair(make, tmp_path, **kw):
    jest = _no_dropout(make(jtext, **kw))
    test = _no_dropout(make(ttext, **kw))
    jest.model.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(test.model, _np_tree(jest.model.get_params()))
    return jest, test


def _classifier(pkg, **kw):
    return pkg.BERTClassifier(num_classes=2, **dict(_TINY, **kw))


def _train_both(jest, test, input_fn, steps):
    before = len(jest.model.get_train_summary("Loss"))
    jest.train(input_fn, steps=steps)
    test.train(input_fn, steps=steps)
    jl = [v for _, _, _, v in jest.model.get_train_summary("Loss")][before:]
    tl = list(test.model.trainer.step_losses)
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)


def test_bert_classifier_trains_evaluates_and_predicts_like_jax(tmp_path):
    feats = _bert_features()
    labels = np.random.default_rng(4).integers(0, 2, (16,)).astype(np.int32)
    jest, test = _pair(_classifier, tmp_path)
    fn = ttext.bert_input_fn(feats, labels, batch_size=8)
    jfn = jtext.bert_input_fn(feats, labels, batch_size=8)
    for a, b in zip(fn()[0].features, jfn()[0].features):
        np.testing.assert_array_equal(a, b)
    _train_both(jest, test, jfn, 3)
    # a second train() keeps advancing from the trainer's step
    _train_both(jest, test, jfn, 2)
    assert test.model.trainer.step == 5
    assert_weights_match(test.model, _np_tree(jest.model.get_params()),
                         atol=WEIGHT_TOL)
    tres = test.evaluate(fn, metrics=["accuracy"])
    jres = jest.evaluate(jfn, metrics=["accuracy"])
    assert set(tres) == set(jres) == {"loss", "accuracy"}
    for k in tres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=0, atol=ROW_TOL)
    pfn = ttext.bert_input_fn(feats, batch_size=8)
    got = test.predict(pfn)
    assert got.shape == (16, 2)
    _rows_close(got, jest.predict(jtext.bert_input_fn(feats, batch_size=8)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bert_model_dir_resumes_across_packages(direction, tmp_path):
    """A ``model_dir`` one package trains into is the other's
    ``init_checkpoint``: the same weights, the same rows. The JAX loader
    takes the file's layer names as they are, so both packages' name
    counters start over here and the two models name their layers alike
    (the port pairs another model's names by class and creation order)."""
    from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
        base as tbase

    jbase._name_counters.clear()
    tbase._name_counters.clear()
    feats = _bert_features()
    labels = np.random.default_rng(5).integers(0, 2, (16,)).astype(np.int32)
    src_pkg, dst_pkg = (jtext, ttext) if direction == "jax_to_port" \
        else (ttext, jtext)
    model_dir = str(tmp_path / "model_dir")
    src = _no_dropout(_classifier(src_pkg, model_dir=model_dir))
    src.train(src_pkg.bert_input_fn(feats, labels, batch_size=8), steps=2)
    assert os.listdir(model_dir)
    dst = _classifier(dst_pkg, init_checkpoint=model_dir)
    pfn = lambda pkg: pkg.bert_input_fn(feats, batch_size=8)  # noqa: E731
    _rows_close(np.asarray(dst.predict(pfn(dst_pkg))),
                np.asarray(src.predict(pfn(src_pkg))))
    trainer = dst.model._ensure_trainer()
    assert trainer.step == 2


def test_bert_config_file_sets_the_trunk(tmp_path):
    cfg = {"vocab_size": 50, "hidden_size": 32, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 48,
           "max_position_embeddings": 12}
    path = tmp_path / "bert_config.json"
    path.write_text(json.dumps(cfg))
    jest = jtext.BERTClassifier(num_classes=3, bert_config_file=str(path),
                                seq_length=16)
    test = ttext.BERTClassifier(num_classes=3, bert_config_file=str(path),
                                seq_length=16)
    assert test.bert_config == jest.bert_config == cfg
    for attr in ("vocab", "hidden_size", "n_block", "n_head", "seq_len",
                 "intermediate_size"):
        assert getattr(test.bert, attr) == getattr(jest.bert, attr), attr
    assert test.bert.seq_len == 12
    load_jax_params(test.model, _np_tree(jest.model.get_params()))
    feats = _bert_features(n=4, seq=12, vocab=50)
    _rows_close(test.predict(ttext.bert_input_fn(feats, batch_size=4)),
                jest.predict(jtext.bert_input_fn(feats, batch_size=4)))


def test_bert_squad_start_end_rows_like_jax(tmp_path):
    feats = _bert_features(n=8)
    rng = np.random.default_rng(6)
    starts = rng.integers(0, 16, (8,)).astype(np.int32)
    ends = rng.integers(0, 16, (8,)).astype(np.int32)
    jest, test = _pair(lambda pkg: pkg.BERTSQuAD(**_TINY), tmp_path)
    _train_both(jest, test, jtext.bert_input_fn(feats, [starts, ends],
                                                batch_size=4), 2)
    got = test.predict(ttext.bert_input_fn(feats, batch_size=4))
    want = jest.predict(jtext.bert_input_fn(feats, batch_size=4))
    assert [g.shape for g in got] == [(8, 16), (8, 16)]
    np.testing.assert_allclose(got[0].sum(-1), 1.0, rtol=1e-5)
    _rows_close(got, want)


def test_bert_ner_shapes_and_rows_like_jax(tmp_path):
    feats = _bert_features(n=8)
    tags = np.random.default_rng(5).integers(0, 4, (8, 16)).astype(
        np.int32)
    jest, test = _pair(lambda pkg: pkg.BERTNER(num_entities=4, **_TINY),
                       tmp_path)
    _train_both(jest, test, jtext.bert_input_fn(feats, tags, batch_size=4),
                2)
    got = test.predict(ttext.bert_input_fn(feats, batch_size=4))
    assert got.shape == (8, 16, 4)
    _rows_close(got, jest.predict(jtext.bert_input_fn(feats, batch_size=4)))


def test_public_names_match_jax():
    assert sorted(ttext.__all__) == sorted(jtext.__all__)
    from analytics_zoo_tpu.tfpark.text import estimator as jest_pkg
    from analytics_zoo_tpu.tfpark.text import keras as jkeras
    from analytics_zoo_tpu_torch.tfpark.text import estimator as test_pkg
    from analytics_zoo_tpu_torch.tfpark.text import keras as tkeras
    assert sorted(tkeras.__all__) == sorted(jkeras.__all__)
    assert sorted(test_pkg.__all__) == sorted(jest_pkg.__all__)
