"""The port's NNFrames (``pipeline/nnframes``) against the JAX package on
the CPU.

``NNEstimator`` and ``NNClassifier`` fit step for step against JAX's from
copied weights (float32; losses within 1e-5, weights within 2e-5: the
two packages' matmuls sum in another order, as in
tests/test_torch_training.py), on pandas frames and on dicts of columns,
in memory and through the spill to ``.npz`` shards. ``transform``, the
binary threshold and ``save``/``load`` both ways across the packages are
held against JAX's rows (1e-5), and ``NNImageReader``'s rows bit for bit
against JAX's (OpenCV) on the codec fixtures.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.common import zoo_trigger as jtrig
from analytics_zoo_tpu.pipeline import nnframes as jnf
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.utils import tensorboard as jtb
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.common import zoo_trigger as ttrig
from analytics_zoo_tpu_torch.feature.feature_set import ShardedFileFeatureSet
from analytics_zoo_tpu_torch.pipeline import nnframes as tnf
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils import tensorboard as ttb
from torch_parity import assert_weights_match, paired_leaves

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL, WEIGHT_TOL, ROW_TOL = 1e-5, 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _use_contexts(**cfg):
    jnn.set_nncontext(None)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1,
                                                   **cfg)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1, **cfg),
                       device="cpu")


def _columns(n, d, seed, classes=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if classes is None:
        y = [float(v) for v in x @ rng.standard_normal(d).astype(np.float32)]
    else:
        y = [int(v) for v in rng.integers(0, classes, n)]
    return {"features": [r.tolist() for r in x], "label": y}


def _frames(cols, kind):
    """(the JAX frame, the port's): pandas for both, or pandas and a dict
    of columns."""
    jdf = pd.DataFrame(cols)
    return jdf, (pd.DataFrame(cols) if kind == "pandas" else
                 {k: list(v) for k, v in cols.items()})


def _mlp(pkg, d=4, out=1, activation=None):
    layers, models = (jl, jmodels) if pkg == "jax" else (tl, tmodels)
    m = models.Sequential()
    m.add(layers.Dense(8, input_shape=(d,), activation="relu"))
    m.add(layers.Dense(out, activation=activation))
    return m


def _paired_mlps(**kw):
    """The MLP in both packages, the port holding the JAX model's initial
    weights. ``get_params`` builds the JAX model's own trainer, which
    would then shadow the weights its NNEstimator writes back
    (``_built_params``): it is dropped."""
    jm, tm = _mlp("jax", **kw), _mlp("torch", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))
    jm.trainer = None
    return jm, tm


def _weights_match(jm, tm):
    # paired by layer, not by sorted name (tests/torch_parity.py)
    assert_weights_match(tm, jax.tree.map(np.asarray, jm.get_params()),
                         atol=WEIGHT_TOL)


def test_weights_pair_by_layer_across_a_counter_digit_boundary():
    """The JAX pair named dense_9/dense_10 and the port's dense_1/dense_2
    sort in other layer orders (ROADMAP C37): the helper pairs every leaf
    by layer, as load_jax_params copied them."""
    from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
        base as tbase

    jbase._name_counters.clear()
    tbase._name_counters.clear()
    for _ in range(8):
        jl.Dense(3)
    jm, tm = _paired_mlps()
    assert sorted(jm.get_params()) == ["dense_10", "dense_9"]
    assert sorted(l.name for l in tm.graph_function().layers
                  if l.name.startswith("dense")) == ["dense_1", "dense_2"]
    # zipped by sorted name, the two lists compare other layers
    assert [w.shape for w in tm.get_weights()] != \
        [np.shape(w) for w in jm.get_weights()]
    jparams = jax.tree.map(np.asarray, jm.get_params())
    pairs = paired_leaves(tm, jparams)
    assert len(pairs) == len(tm.get_weights()) == 4
    for path, got, want in pairs:
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert_weights_match(tm, jparams, atol=0.0)


def _losses(log_dir, app):
    return [v for _, _, _, v in jtb.read_scalars(
        os.path.join(log_dir, app, "train"), "Loss")]


def _fit_both(jest, test, jdf, tdf, tmp_path):
    jest.setTrainSummary(jtb.TrainSummary(str(tmp_path), "jax"))
    test.setTrainSummary(ttb.TrainSummary(str(tmp_path), "torch"))
    jmodel = jest.fit(jdf)
    tmodel = test.fit(tdf)
    jl_, tl_ = _losses(tmp_path, "jax"), _losses(tmp_path, "torch")
    return jmodel, tmodel, jl_, tl_


@pytest.mark.parametrize("frame", ["pandas", "dict"])
def test_nnestimator_fits_step_for_step(frame, tmp_path):
    _use_contexts()
    jdf, tdf = _frames(_columns(32, 4, 0), frame)
    jm, tm = _paired_mlps()
    ests = [pkg.NNEstimator(m, "mse", feature_preprocessing=[4],
                            label_preprocessing=[1])
            .setBatchSize(8).setMaxEpoch(2)
            .setOptimMethod(opt.Adam(lr=0.01))
            for pkg, m, opt in ((jnf, jm, jopt), (tnf, tm, topt))]
    jmodel, tmodel, jlosses, tlosses = _fit_both(*ests, jdf, tdf, tmp_path)
    assert isinstance(tmodel, tnf.NNModel)
    assert len(tlosses) == len(jlosses) == 8
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_TOL)
    _weights_match(jm, tm)
    jout, tout = jmodel.transform(jdf), tmodel.transform(tdf)
    np.testing.assert_allclose(np.asarray(list(tout["prediction"])),
                               np.asarray(list(jout["prediction"])),
                               rtol=0, atol=ROW_TOL)
    # transform keeps the caller's frame and its type
    assert type(tout) is type(tdf) and "prediction" not in tdf
    # the model's own parameters trained in place: predict serves them
    pred = tm.predict(np.asarray(tdf["features"] if frame == "dict" else
                                 tdf["features"].tolist(), np.float32))
    np.testing.assert_allclose(np.asarray(list(tout["prediction"])), pred,
                               atol=ROW_TOL)


def test_nnestimator_learning_rate_validation_clipping_and_checkpoint(
        tmp_path):
    """The default SGD at setLearningRate/Decay, L2 clipping, a validation
    frame every epoch and a checkpoint every epoch, step for step."""
    _use_contexts()
    cols = _columns(32, 4, 1)
    jdf, tdf = _frames(cols, "dict")
    vj, vt = _frames(_columns(16, 4, 2), "dict")
    jm, tm = _paired_mlps()
    ests = []
    for pkg, m, trig, vdf, name in ((jnf, jm, jtrig, vj, "j"),
                                    (tnf, tm, ttrig, vt, "t")):
        ests.append(
            pkg.NNEstimator(m, "mse", [4], [1]).setBatchSize(8)
            .setMaxEpoch(2).setLearningRate(0.05).setLearningRateDecay(0.01)
            .setGradientClippingByL2Norm(0.5)
            .setValidation(trig.EveryEpoch(), vdf, ["mae"], 8)
            .setCheckpoint(str(tmp_path / f"ckpt_{name}"),
                           trig.EveryEpoch()))
    _, _, jlosses, tlosses = _fit_both(*ests, jdf, tdf, tmp_path)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_TOL)
    _weights_match(jm, tm)
    assert os.listdir(tmp_path / "ckpt_t")
    assert ests[1].getLearningRate() == 0.05
    assert ests[1].getCheckpoint()[0] == str(tmp_path / "ckpt_t")
    # snake_case aliases are the camelCase setters
    assert tnf.NNEstimator.set_max_epoch is tnf.NNEstimator.setMaxEpoch
    assert tnf.NNEstimator.set_batch_size is tnf.NNEstimator.setBatchSize


@pytest.mark.parametrize("frame", ["pandas", "dict"])
def test_nnclassifier_fits_and_transforms_as_jax(frame, tmp_path):
    _use_contexts()
    jdf, tdf = _frames(_columns(32, 4, 3, classes=3), frame)
    jm, tm = _paired_mlps(out=3, activation="softmax")
    ests = [pkg.NNClassifier(m, feature_preprocessing=[4]).setBatchSize(8)
            .setMaxEpoch(1).setOptimMethod(opt.Adam(lr=0.01))
            for pkg, m, opt in ((jnf, jm, jopt), (tnf, tm, topt))]
    jmodel, tmodel, jlosses, tlosses = _fit_both(*ests, jdf, tdf, tmp_path)
    assert isinstance(tmodel, tnf.NNClassifierModel)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_TOL)
    jpred = np.asarray(list(jmodel.transform(jdf)["prediction"]))
    tpred = np.asarray(list(tmodel.transform(tdf)["prediction"]))
    np.testing.assert_array_equal(tpred, jpred)
    probs = tm.predict(np.asarray(list(tdf["features"]), np.float32))
    np.testing.assert_array_equal(tpred, np.argmax(probs, -1))


def test_binary_threshold_matches_jax():
    _use_contexts()
    cols = _columns(24, 4, 4)
    jdf, tdf = _frames(cols, "dict")
    jm, tm = _paired_mlps(out=1, activation="sigmoid")
    for threshold in (0.5, 0.3):
        jmodel = jnf.NNClassifierModel(jm, feature_preprocessing=[4])
        tmodel = tnf.NNClassifierModel(tm, feature_preprocessing=[4])
        jmodel.setThreshold(threshold)
        tmodel.set_threshold(threshold)
        np.testing.assert_array_equal(
            np.asarray(list(tmodel.transform(tdf)["prediction"])),
            np.asarray(list(jmodel.transform(jdf)["prediction"])))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("klass", ["NNModel", "NNClassifierModel"])
def test_save_and_load_across_packages(direction, klass, tmp_path):
    _use_contexts()
    cols = _columns(16, 4, 5)
    jdf, tdf = _frames(cols, "dict")
    out = 2 if klass == "NNClassifierModel" else 1
    jm, tm = _paired_mlps(out=out, activation="softmax" if out > 1 else None)
    jsrc = getattr(jnf, klass)(jm, feature_preprocessing=[4])
    tsrc = getattr(tnf, klass)(tm, feature_preprocessing=[4])
    for m in (jsrc, tsrc):
        m.setPredictionCol("p").setBatchSize(4)
        if klass == "NNClassifierModel":
            m.setThreshold(0.25)
    path = str(tmp_path / "m")
    if direction == "port_to_jax":
        tsrc.save(path)
        loaded = jnf.NNModel.load(path)
        want = tsrc.transform(tdf)["p"]
        got = loaded.transform(jdf)["p"]
    else:
        jsrc.save(path)
        loaded = tnf.NNModel.load(path)
        want = jsrc.transform(jdf)["p"]
        got = loaded.transform(tdf)["p"]
    assert type(loaded).__name__ == klass
    assert loaded.prediction_col == "p" and loaded.batch_size == 4
    assert type(loaded.feature_preprocessing).__name__ == "SeqToTensor"
    if klass == "NNClassifierModel":
        assert loaded.threshold == 0.25
    np.testing.assert_allclose(np.asarray(list(got)), np.asarray(list(want)),
                               rtol=0, atol=ROW_TOL)


def test_spill_route_fits_step_for_step(tmp_path):
    """Past ``nnframes_spill_bytes`` the processed rows go to ``.npz``
    shards in both packages; the shards hold the in-memory rows, and the
    fit through them matches JAX's."""
    _use_contexts(nnframes_spill_bytes=1)
    jdf, tdf = _frames(_columns(32, 4, 6), "dict")
    jm, tm = _paired_mlps()
    test = tnf.NNEstimator(tm, "mse", [4], [1]).setBatchSize(8) \
        .setMaxEpoch(2)
    spilled = test._get_dataset(tdf)
    assert isinstance(spilled, ShardedFileFeatureSet)
    assert len(spilled.paths) > 1
    resident = tnf.NNEstimator(tm, "mse", [4], [1])._extract_samples(tdf)
    rows = np.concatenate([b.inputs[0] for b in
                           spilled.batches(8, shuffle=False)])
    np.testing.assert_array_equal(
        rows, np.stack([s.features[0] for s in resident]))
    jest = jnf.NNEstimator(jm, "mse", [4], [1]).setBatchSize(8) \
        .setMaxEpoch(2)
    _, tmodel, jlosses, tlosses = _fit_both(jest, test, jdf, tdf, tmp_path)
    assert len(tlosses) == len(jlosses) == 8
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_TOL)
    _weights_match(jm, tm)
    assert np.isfinite(np.asarray(list(tmodel.transform(tdf)[
        "prediction"]))).all()


def test_feature_set_and_shard_paths_fit(tmp_path):
    """A FeatureSet, or a list of shard paths, goes to the trainer as it
    is, as in JAX."""
    from analytics_zoo_tpu_torch.feature.feature_set import (DiskFeatureSet,
                                                             FeatureSet)
    _use_contexts()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        x = rng.standard_normal((16, 4)).astype(np.float32)
        p = str(tmp_path / f"s{i}.npz")
        DiskFeatureSet.write_shard(p, x, (x[:, :1] > 0).astype(np.float32))
        paths.append(p)
    for data in (FeatureSet.files(paths), paths):
        est = tnf.NNEstimator(_mlp("torch", activation="sigmoid"),
                              "binary_crossentropy", [4], [1])
        est.setBatchSize(8).setMaxEpoch(1)
        assert est._get_dataset(data) is data or isinstance(data, list)
        assert isinstance(est.fit(data), tnf.NNModel)


def test_size_lists_become_preprocessing():
    from analytics_zoo_tpu_torch.feature.common import (SeqToMultipleTensors,
                                                        SeqToTensor)
    from analytics_zoo_tpu_torch.pipeline.nnframes import nn_estimator as ne
    assert isinstance(ne._sizes_to_preprocessing([5]), SeqToTensor)
    assert isinstance(ne._sizes_to_preprocessing([[1], [2]]),
                      SeqToMultipleTensors)
    assert ne._sizes_to_preprocessing(None) is None
    with pytest.raises(TypeError):
        ne._sizes_to_preprocessing("nope")


@pytest.mark.parametrize("resize", [None, (9, 7)])
def test_image_reader_rows_equal_jax(resize, tmp_path):
    """Rows of the codec fixtures (progressive, CMYK, YCCK JPEGs) and a
    seeded PNG, bit for bit against the JAX reader (OpenCV); an
    unreadable file is skipped by both."""
    import shutil

    import cv2

    src = ROOT / "tools" / "codec_fixtures"
    for p in sorted(src.glob("*.jpg")):
        shutil.copy(p, tmp_path / p.name)
    img = np.random.default_rng(0).integers(0, 255, (12, 10, 3)) \
        .astype(np.uint8)
    cv2.imwrite(str(tmp_path / "sub_a.png"), img)
    (tmp_path / "broken.jpg").write_bytes(b"not an image")
    kw = {} if resize is None else {"resizeH": resize[0],
                                    "resizeW": resize[1]}
    jdf = jnf.NNImageReader.readImages(str(tmp_path), **kw)
    tdf = tnf.NNImageReader.read_images(str(tmp_path), **kw)
    assert isinstance(tdf, dict) and list(tdf) == ["image"]
    jrows = list(jdf["image"])
    assert len(tdf["image"]) == len(jrows) == 7
    for a, b in zip(tdf["image"], jrows):
        assert a == b, a["origin"]
    (png,) = [r for r in tdf["image"] if r["origin"].endswith(".png")]
    back = tnf.NNImageSchema.to_ndarray(png)
    if resize is None:
        np.testing.assert_array_equal(back.astype(np.uint8), img)
    feat = tnf.NNImageSchema.to_image_feature(tdf["image"][0])
    np.testing.assert_array_equal(
        feat.get_image(), jnf.NNImageSchema.to_ndarray(jrows[0]))
    assert feat["uri"] == jrows[0]["origin"]
