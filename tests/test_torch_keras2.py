"""The port's Keras-2 API, ``save_keras2`` and ``KerasNet.summary`` /
``get_params`` against the JAX package on the CPU.

Every ``keras2`` adapter builds the same Keras-1 class with the same
config as JAX's. A Keras-2 model predicts within 1e-5 of JAX's from the
same weights and trains step for step with ``fit(epochs=,
validation_split=)`` (losses within 1e-5). ``save_keras2``'s source
equals JAX's string for string, up to the package's own name, and its
weights in ``set_weights`` order are JAX's arrays; ``summary``'s text
equals JAX's.
"""

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api import keras2 as jk2
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.engine import \
    keras2_export as jexport
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.pipeline.api import keras2 as tk2
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
    keras2_export as texport
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


#: keras2 name -> constructor over the keras2 module
ADAPTERS = {
    "Dense": lambda k: k.Dense(4, activation="relu", use_bias=False),
    "Conv1D": lambda k: k.Conv1D(3, 2, strides=2, padding="same"),
    "Conv2D": lambda k: k.Conv2D(3, (2, 3), strides=2, padding="same"),
    "Conv3D": lambda k: k.Conv3D(2, 3, strides=(1, 2, 1)),
    "SeparableConv2D": lambda k: k.SeparableConv2D(4, 3,
                                                   depth_multiplier=2),
    "Activation": lambda k: k.Activation("tanh"),
    "Dropout": lambda k: k.Dropout(0.2),
    "Flatten": lambda k: k.Flatten(),
    "Embedding": lambda k: k.Embedding(10, 3, input_length=5),
    "BatchNormalization": lambda k: k.BatchNormalization(momentum=0.9),
    "MaxPooling1D": lambda k: k.MaxPooling1D(3, strides=2),
    "MaxPooling2D": lambda k: k.MaxPooling2D(3, strides=2, padding="same"),
    "MaxPooling3D": lambda k: k.MaxPooling3D(),
    "AveragePooling1D": lambda k: k.AveragePooling1D(2),
    "AveragePooling2D": lambda k: k.AveragePooling2D((2, 3)),
    "AveragePooling3D": lambda k: k.AveragePooling3D(),
    "GlobalMaxPooling1D": lambda k: k.GlobalMaxPooling1D(),
    "GlobalMaxPooling2D": lambda k: k.GlobalMaxPooling2D(),
    "GlobalMaxPooling3D": lambda k: k.GlobalMaxPooling3D(),
    "GlobalAveragePooling1D": lambda k: k.GlobalAveragePooling1D(),
    "GlobalAveragePooling2D": lambda k: k.GlobalAveragePooling2D(),
    "GlobalAveragePooling3D": lambda k: k.GlobalAveragePooling3D(),
    "Add": lambda k: k.Add(),
    "Subtract": lambda k: k.Subtract(),
    "Multiply": lambda k: k.Multiply(),
    "Average": lambda k: k.Average(),
    "Maximum": lambda k: k.Maximum(),
    "Minimum": lambda k: k.Minimum(),
    "Concatenate": lambda k: k.Concatenate(axis=1),
    "Dot": lambda k: k.Dot(normalize=True),
    "Cropping1D": lambda k: k.Cropping1D((1, 2)),
    "Cropping2D": lambda k: k.Cropping2D(((1, 0), (0, 1))),
    "Cropping3D": lambda k: k.Cropping3D(),
    "ZeroPadding1D": lambda k: k.ZeroPadding1D(2),
    "ZeroPadding2D": lambda k: k.ZeroPadding2D((1, 2)),
    "ZeroPadding3D": lambda k: k.ZeroPadding3D((1, 2, 0)),
    "UpSampling1D": lambda k: k.UpSampling1D(3),
    "UpSampling2D": lambda k: k.UpSampling2D(2),
    "UpSampling3D": lambda k: k.UpSampling3D((1, 2, 2)),
    "LocallyConnected1D": lambda k: k.LocallyConnected1D(3, 2),
    "LocallyConnected2D": lambda k: k.LocallyConnected2D(2, 3,
                                                         padding="same"),
    "SimpleRNN": lambda k: k.SimpleRNN(4, return_sequences=True),
    "LSTM": lambda k: k.LSTM(3, recurrent_activation="sigmoid"),
    "GRU": lambda k: k.GRU(3, go_backwards=True),
    "Bidirectional": lambda k: k.Bidirectional(k.LSTM(2, name="bi_in"),
                                               merge_mode="sum"),
    "TimeDistributed": lambda k: k.TimeDistributed(k.Dense(2,
                                                           name="td_in")),
    "Reshape": lambda k: k.Reshape((2, -1)),
    "Permute": lambda k: k.Permute((2, 1)),
    "RepeatVector": lambda k: k.RepeatVector(3),
    "Masking": lambda k: k.Masking(0.5),
    "LeakyReLU": lambda k: k.LeakyReLU(0.1),
    "PReLU": lambda k: k.PReLU(),
    "ELU": lambda k: k.ELU(0.5),
    "ThresholdedReLU": lambda k: k.ThresholdedReLU(0.2),
    "SpatialDropout1D": lambda k: k.SpatialDropout1D(0.1),
    "SpatialDropout2D": lambda k: k.SpatialDropout2D(0.2),
    "SpatialDropout3D": lambda k: k.SpatialDropout3D(0.3),
    "GaussianNoise": lambda k: k.GaussianNoise(0.5),
    "GaussianDropout": lambda k: k.GaussianDropout(0.25),
    "Softmax": lambda k: k.Softmax(axis=1),
}


def test_every_keras2_name_is_ported():
    assert sorted(tk2.__all__) == sorted(jk2.__all__)
    for name in tk2.__all__:
        assert hasattr(tk2, name), name
    made = set(ADAPTERS) | {"Input", "Model", "Sequential"}
    assert made == set(jk2.__all__)


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_adapter_builds_jax_class_and_config(name):
    jlayer, tlayer = ADAPTERS[name](jk2), ADAPTERS[name](tk2)
    assert type(tlayer).__name__ == type(jlayer).__name__
    jcfg, tcfg = jlayer.get_config(), tlayer.get_config()
    inner = ("layer",)       # wrappers hold a layer: compare its class
    assert {k: v for k, v in tcfg.items() if k not in inner} == \
        {k: v for k, v in jcfg.items() if k not in inner}
    for k in inner:
        if k in jcfg:
            assert type(tcfg[k]).__name__ == type(jcfg[k]).__name__


def _k2_cnn(k, name):
    model = k.Sequential(name=name)
    model.add(k.Conv2D(4, 3, padding="same", activation="relu",
                       input_shape=(1, 8, 8), name="c1"))
    model.add(k.MaxPooling2D(pool_size=2, name="p1"))
    model.add(k.Flatten(name="f1"))
    model.add(k.Dense(3, activation="softmax", name="d1"))
    return model


def test_keras2_model_predicts_and_fits_like_jax(tmp_path):
    jmodel, tmodel = _k2_cnn(jk2, "k2"), _k2_cnn(tk2, "k2")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    rs = np.random.default_rng(0)
    x = rs.standard_normal((20, 1, 8, 8)).astype(np.float32)
    y = rs.integers(0, 3, 20).astype(np.float32)
    tnn.init_nncontext(device="cpu")
    np.testing.assert_allclose(tmodel.predict(x, batch_size=8),
                               np.asarray(jmodel.predict(x, batch_size=8)),
                               rtol=0, atol=1e-5)
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path), "jax")
    # 20 rows less a 0.2 split: 16 training rows, 2 batches of 8
    jmodel.fit(x, y, batch_size=8, epochs=2, validation_split=0.2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    tmodel.fit(x, y, batch_size=8, epochs=2, validation_split=0.2)
    assert len(tmodel.trainer.step_losses) == len(jlosses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses, rtol=0,
                               atol=1e-5)
    with pytest.raises(TypeError, match="conflicting"):
        tmodel.fit(x, y, epochs=1, nb_epoch=2)
    with pytest.raises(ValueError, match="validation_split"):
        tmodel.fit(x, y, epochs=1, validation_split=1.5)


def test_keras2_load_model_keeps_the_dialect(tmp_path):
    _k2_cnn(jk2, "k2s").save_model(str(tmp_path / "j"))
    _k2_cnn(tk2, "k2s").save_model(str(tmp_path / "t"))
    jback = jk2.Sequential.load_model(str(tmp_path / "j"))
    for path in ("j", "t"):
        back = tk2.Sequential.load_model(str(tmp_path / path))
        assert type(back).__name__ == type(jback).__name__
        assert type(back).__module__.endswith("keras2.models")


def _export_stack(m, name):
    """A stack over every layer kind ``save_keras2`` emits."""
    model = (JSequential if m is jl else Sequential)(name=name)
    model.add(m.Embedding(20, 6, input_shape=(8,), name="emb"))
    model.add(m.Convolution1D(5, 3, border_mode="same", activation="relu",
                              name="c1d"))
    model.add(m.MaxPooling1D(2, name="mp1"))
    model.add(m.AveragePooling1D(2, stride=1, name="ap1"))
    model.add(m.LSTM(4, return_sequences=True, name="lstm"))
    model.add(m.GRU(4, return_sequences=True, name="gru"))
    model.add(m.SimpleRNN(3, activation="relu", return_sequences=True,
                          name="rnn"))
    model.add(m.GlobalMaxPooling1D(name="gmp"))
    model.add(m.RepeatVector(4, name="rep"))
    model.add(m.Reshape((1, 4, 3), name="resh"))
    model.add(m.ZeroPadding2D((1, 1), name="zp"))
    model.add(m.Convolution2D(2, 2, 2, dim_ordering="th", name="c2d"))
    model.add(m.BatchNormalization(axis=1, name="bn"))
    model.add(m.AveragePooling2D((1, 2), name="ap2"))
    model.add(m.Flatten(name="flat"))
    model.add(m.Dropout(0.3, name="drop"))
    model.add(m.Dense(3, name="dense"))
    model.add(m.Activation("hard_sigmoid", name="act"))
    return model


def test_save_keras2_source_and_weights_equal_jax(tmp_path):
    jmodel, tmodel = _export_stack(jl, "exported"), \
        _export_stack(tl, "exported")
    jparams = jax.tree.map(np.asarray, jmodel.get_params())
    load_jax_params(tmodel, jparams)
    jpath = jmodel.save_keras2(str(tmp_path / "jax.py"))
    tpath = tmodel.save_keras2(str(tmp_path / "port.py"))
    want = open(jpath).read().replace("analytics_zoo_tpu",
                                      "analytics_zoo_tpu_torch")
    assert open(tpath).read() == want
    compile(open(tpath).read(), tpath, "exec")     # valid python
    jw, tw = jexport.keras2_weights(jmodel), texport.keras2_weights(tmodel)
    assert len(tw) == len(jw) > 10
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(texport.Keras2ExportError, match="go_backwards"):
        bad = Sequential()
        bad.add(tl.LSTM(2, return_sequences=True, go_backwards=True,
                        input_shape=(3, 2)))
        texport.sequential_to_keras2_source(bad)


def test_summary_text_and_get_params_equal_jax(capsys):
    jmodel, tmodel = _export_stack(jl, "summed"), _export_stack(tl, "summed")
    want = jmodel.summary()
    got = tmodel.summary()
    assert got == want
    assert got in capsys.readouterr().out
    jparams = jax.tree.map(np.asarray, jmodel.get_params())
    load_jax_params(tmodel, jparams)
    tparams = tmodel.get_params()
    assert set(tparams) == set(jparams)
    for layer, tree in jparams.items():
        for k, v in tree.items():
            np.testing.assert_array_equal(
                tparams[layer][k].detach().numpy(), v)


def test_zoo_model_summary_forwards():
    tnn.init_nncontext(device="cpu")
    ncf = NeuralCF(user_count=10, item_count=12, class_num=2)
    assert ncf.summary() == ncf.model.summary()
