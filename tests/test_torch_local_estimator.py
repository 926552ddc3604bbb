"""The port's ``LocalEstimator`` against the JAX package's on the CPU:
``fit`` step for step from copied weights (float32; losses within 1e-5,
weights within 2e-5, as tests/test_torch_training.py), ``validate`` and
``predict`` within 1e-5."""

import os

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.estimator import LocalEstimator as JLocal
from analytics_zoo_tpu.utils import tensorboard as jtb
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.pipeline.estimator import LocalEstimator
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils import tensorboard as ttb
from torch_parity import assert_weights_match

TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1), device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _mlp(layers, models):
    m = models.Sequential()
    m.add(layers.Dense(8, input_shape=(4,), activation="relu"))
    m.add(layers.Dense(1))
    return m


def _data(seed, n=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    return x, (x @ rng.standard_normal((4, 1))).astype(np.float32)


def _losses(log_dir, app):
    return [v for _, _, _, v in jtb.read_scalars(
        os.path.join(log_dir, app, "train"), "Loss")]


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_local_estimator_matches_jax(optim, tmp_path):
    jm, tm = _mlp(jl, jmodels), _mlp(tl, tmodels)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.get_params()))
    jopt_, topt_ = ((jopt.SGD(lr=0.05), topt.SGD(lr=0.05)) if optim == "sgd"
                    else (jopt.Adam(lr=0.01), topt.Adam(lr=0.01)))
    jle = JLocal(jm, "mse", validation_methods=["mae"], optim_method=jopt_,
                 thread_num=4)
    tle = LocalEstimator(tm, "mse", validation_methods=["mae"],
                         optim_method=topt_, thread_num=4)
    jle.trainer.train_summary = jtb.TrainSummary(str(tmp_path), "jax")
    tle.trainer.train_summary = ttb.TrainSummary(str(tmp_path), "torch")
    x, y = _data(0)
    vx, vy = _data(1, 16)
    for le in (jle, tle):
        assert le.fit(x, y, validation_data=vx, validation_labels=vy,
                      epoch=2, batch_size=8) is le
    # a second fit continues from epoch 2
    for le in (jle, tle):
        le.fit(x, y, epoch=1, batch_size=8)
    assert tle.trainer.epoch == 3
    jlosses, tlosses = _losses(tmp_path, "jax"), _losses(tmp_path, "torch")
    assert len(tlosses) == len(jlosses) == 12
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL)
    assert_weights_match(tm, jax.tree.map(np.asarray, jle.trainer.params),
                         atol=2e-5)
    jres = jle.validate(vx, vy, batch_size=8)
    tres = tle.validate(vx, vy, batch_size=8)
    assert set(tres) == set(jres) == {"loss", "mae"}
    for k in tres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=0, atol=TOL)
    np.testing.assert_allclose(tle.predict(vx, batch_size=5),
                               np.asarray(jle.predict(vx, batch_size=5)),
                               rtol=0, atol=TOL)


def test_local_estimator_takes_feature_sets_and_trains_the_models_weights():
    tm = _mlp(tl, tmodels)
    before = [w.copy() for w in tm.get_weights()]
    x, y = _data(2)
    le = LocalEstimator(tm, "mse", optim_method="adam")
    assert le.thread_num is None
    le.fit(ArrayFeatureSet(x, y), epoch=1, batch_size=16)
    assert len(le.trainer.step_losses) == 2
    assert all(not np.array_equal(a, b)
               for a, b in zip(before, tm.get_weights()))
    res = le.validate(ArrayFeatureSet(x, y), batch_size=16)
    np.testing.assert_allclose(res["loss"], float(np.mean(
        (tm.predict(x) - y) ** 2)), rtol=1e-5)
