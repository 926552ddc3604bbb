"""Model save/load, zoo-model save/load and ``InferenceModel.load``
across the two packages, and the layer configs they rest on, on the CPU.

A directory either package saves loads in the other: the port writes the
JAX package's class paths into ``architecture.json`` and its module
paths into ``zoo_model.pkl``. Each case saves from one package, loads in
the other and compares ``predict`` on seeded inputs within 1e-5 (float32
forwards of the same weights summed in another order), and the port's
reload of what it saved, or of what JAX saved from the port's weights,
bit for bit. Layer configs: every ported layer class records the same
constructor arguments as its JAX class for the same call, round-trips
through ``get_config``/``from_config``, and is written under the JAX
class's path.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.models.common import ZooModel as JZooModel
from analytics_zoo_tpu.models.image.imageclassification import \
    image_classifier as jic
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.engine import model_io as jio
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import KerasNet as JKerasNet
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.models import ZooModel
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    image_classifier as tic
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import model_io
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (KerasNet,
                                                               Sequential)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

from test_torch_image import LAYER_CASES as IMAGE_LAYER_CASES
from test_torch_training import _classifier, _data as _bert_data

TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _round_trip(tmodel, x, tmp_path):
    """port save -> JAX load -> JAX predict (against the port's) -> JAX
    save -> port load -> predict (bit for bit the port's) ->
    ``InferenceModel.load`` on the JAX-saved directory."""
    want = tmodel.predict(x, batch_size=4)
    tmodel.save_model(str(tmp_path / "port"))
    jmodel = JKerasNet.load_model(str(tmp_path / "port"))
    _close(np.asarray(jmodel.predict(x, batch_size=4)), want)
    jmodel.save_model(str(tmp_path / "jax"))
    back = KerasNet.load_model(str(tmp_path / "jax"))
    assert [l.name for l in back.graph_function().layers] == \
        [l.name for l in jmodel.graph_function().layers]
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)
    served = InferenceModel().load(str(tmp_path / "jax"))
    out = served.predict(x)
    np.testing.assert_array_equal(np.asarray(out), want)


def test_sequential_saves_and_loads_across_packages(tmp_path):
    model = Sequential()
    model.add(tl.Dense(8, activation="tanh", input_shape=(5,)))
    model.add(tl.Dropout(0.3))
    model.add(tl.Dense(3, activation="softmax"))
    x = np.random.default_rng(0).standard_normal((6, 5)).astype(np.float32)
    _round_trip(model, x, tmp_path)
    # and a model JAX built and named
    jmodel = JSequential()
    jmodel.add(jl.Dense(4, activation="relu", input_shape=(5,)))
    jmodel.add(jl.Dense(2))
    jmodel.save_model(str(tmp_path / "jax_built"))
    port = KerasNet.load_model(str(tmp_path / "jax_built"))
    _close(port.predict(x), np.asarray(jmodel.predict(x)))


def test_the_bert_classifier_saves_and_loads_across_packages(tmp_path):
    tmodel = _classifier("torch")
    x, _ = _bert_data(5, 6)
    _round_trip(tmodel, x, tmp_path)
    spec = json.loads((tmp_path / "port" / "architecture.json").read_text())
    assert spec["layers"][0]["class"] == \
        "analytics_zoo_tpu.pipeline.api.keras.layers.self_attention.BERT"
    # a JAX-built classifier, saved by JAX, loads in the port
    jbuilt = _classifier("jax")
    jbuilt.save_model(str(tmp_path / "jax_built"))
    port = KerasNet.load_model(str(tmp_path / "jax_built"))
    _close(port.predict(x, batch_size=4),
           np.asarray(jbuilt.predict(x, batch_size=4)))


def test_neuralcf_zoo_model_saves_and_loads_across_packages(tmp_path):
    tncf = trec.NeuralCF(50, 40, 3, user_embed=6, item_embed=5,
                         hidden_layers=[8, 4], mf_embed=4)
    rs = np.random.default_rng(1)
    x = np.stack([rs.integers(1, 51, 9), rs.integers(1, 41, 9)],
                 axis=1).astype(np.float32)
    want = tncf.predict(x, batch_size=4)
    tncf.save_model(str(tmp_path / "port"))
    jncf = JZooModel.load_model(str(tmp_path / "port"))
    assert type(jncf).__module__ == \
        "analytics_zoo_tpu.models.recommendation.neuralcf"
    assert jncf.hidden_layers == [8, 4] and jncf.user_count == 50
    _close(np.asarray(jncf.predict(x, batch_size=4)), want)
    jncf.save_model(str(tmp_path / "jax"))
    back = ZooModel.load_model(str(tmp_path / "jax"))
    assert isinstance(back, trec.NeuralCF) and back.item_count == 40
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)
    served = InferenceModel().load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(served.predict(x), want)
    with pytest.raises(IOError, match="over_write"):
        tncf.save_model(str(tmp_path / "port"))


def test_resnet50_zoo_model_carries_its_moving_statistics(tmp_path):
    tclf = tic.ImageClassifier(class_num=5, model_name="resnet-50",
                               input_shape=(3, 32, 32))
    rs = np.random.default_rng(2)
    with torch.no_grad():
        for name, buf in tclf.model.named_buffers():
            buf.copy_(torch.from_numpy(
                rs.uniform(0.5, 1.5, buf.shape) if name.endswith("var")
                else rs.standard_normal(buf.shape) * 0.1).float())
    x = rs.standard_normal((3, 3, 32, 32)).astype(np.float32)
    want = tclf.predict(x, batch_size=4)
    tclf.save_model(str(tmp_path / "port"))
    jclf = JZooModel.load_model(str(tmp_path / "port"))
    assert isinstance(jclf, jic.ImageClassifier)
    jparams, jstate = jclf.model._built_params
    graph = jclf.model.graph_function()
    got = np.asarray(jax.jit(lambda p, s, xin: graph.apply(
        p, [xin], state=s, training=False))(jparams, jstate, x))
    _close(got, want)
    jclf.save_model(str(tmp_path / "jax"))
    back = ZooModel.load_model(str(tmp_path / "jax"))
    stats = dict(back.model.named_buffers())
    for name, buf in tclf.model.named_buffers():
        assert torch.equal(stats[name], buf), name
    np.testing.assert_array_equal(back.predict(x, batch_size=4), want)
    served = InferenceModel().load(str(tmp_path / "port"))
    np.testing.assert_array_equal(served.predict(x), want)


def test_what_cannot_be_saved_or_loaded_names_its_roadmap_item(tmp_path):
    model = Sequential()
    model.add(tl.Dense(2, activation=lambda x: x, input_shape=(3,)))
    with pytest.raises(model_io.UnserializableConfig, match="pickled"):
        model.save_model(str(tmp_path / "callable"))
    jmodel = JSequential()
    jmodel.add(jl.ELU(input_shape=(3, 2)))
    jmodel.save_model(str(tmp_path / "lstm"))
    # the TensorFlow graph wrapper is ported (ROADMAP A14.8); a class
    # the port lacks names the ROADMAP queue of what is not ported
    from analytics_zoo_tpu_torch.pipeline.api.net import TFNet
    assert model_io.port_class(
        "analytics_zoo_tpu.pipeline.api.net.tfnet.TFNet") is TFNet
    spec = json.loads((tmp_path / "lstm" / "architecture.json").read_text())
    spec["layers"][0]["class"] = \
        "analytics_zoo_tpu.pipeline.api.net.tfnet.TFNetOfAnotherKind"
    (tmp_path / "lstm" / "architecture.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="ROADMAP's queue A"):
        KerasNet.load_model(str(tmp_path / "lstm"))
    spec = json.loads((tmp_path / "lstm" / "architecture.json").read_text())
    spec["layers"][0]["class"] = "os.system"
    (tmp_path / "lstm" / "architecture.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="refusing"):
        KerasNet.load_model(str(tmp_path / "lstm"))
    spec["layers"][0]["class"] = \
        "analytics_zoo_tpu_torch.pipeline.api.keras.layers.core.Dense"
    (tmp_path / "lstm" / "architecture.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="refusing"):
        KerasNet.load_model(str(tmp_path / "lstm"))


# -- layer configs ---------------------------------------------------------

CONFIG_CASES = {
    "Dense": lambda m: m.Dense(3, activation="relu", input_shape=(4,)),
    "Activation": lambda m: m.Activation("tanh"),
    "Dropout": lambda m: m.Dropout(0.25),
    "Flatten": lambda m: m.Flatten(),
    "Select": lambda m: m.Select(1, -1),
    "Embedding": lambda m: m.Embedding(10, 4, init="normal"),
    "SparseEmbedding": lambda m: m.SparseEmbedding(12, 3),
    "Merge": lambda m: m.Merge(mode="concat", concat_axis=1),
    "Add": lambda m: m.Add(),
    "Multiply": lambda m: m.Multiply(),
    "Average": lambda m: m.Average(),
    "Maximum": lambda m: m.Maximum(),
    "Concatenate": lambda m: m.Concatenate(axis=-1),
    "BatchNormalization": lambda m: m.BatchNormalization(epsilon=1e-4),
    "LayerNorm": lambda m: m.LayerNorm(),
    "LRN2D": lambda m: m.LRN2D(alpha=1e-2, n=3),
    "WithinChannelLRN2D": lambda m: m.WithinChannelLRN2D(size=3),
    "InputLayer": lambda m: m.InputLayer(input_shape=(3,)),
    "SimpleRNN": lambda m: m.SimpleRNN(4, activation="relu",
                                       input_shape=(5, 3)),
    "LSTM": lambda m: m.LSTM(4, return_sequences=True, go_backwards=True),
    "GRU": lambda m: m.GRU(3, inner_activation="sigmoid"),
    # wrapped and array-holding layers carry a name: the spec holds the
    # inner layer's name and keys the arrays by the layer's
    "TimeDistributed": lambda m: m.TimeDistributed(
        m.Dense(2, name="td_inner"), input_shape=(4, 3)),
    "Bidirectional": lambda m: m.Bidirectional(
        m.GRU(3, return_sequences=True, name="bidi_inner"),
        merge_mode="ave"),
    "WordEmbedding": lambda m: m.WordEmbedding(
        weights=np.arange(12, dtype=np.float32).reshape(4, 3),
        input_length=6, name="word_embedding_case"),
}
for _case, (_make, _) in IMAGE_LAYER_CASES.items():
    CONFIG_CASES[_case] = _make
CONFIG_CASES.update({   # the rest of core.py
    "Reshape": lambda m: m.Reshape((4, -1)),
    "Permute": lambda m: m.Permute((2, 3, 1)),
    "RepeatVector": lambda m: m.RepeatVector(3),
    "Masking": lambda m: m.Masking(0.5),
    "Highway": lambda m: m.Highway(activation="relu"),
    "MaxoutDense": lambda m: m.MaxoutDense(5, nb_feature=3),
    "Narrow": lambda m: m.Narrow(1, 1, 2),
    "Squeeze": lambda m: m.Squeeze(2),
    "ExpandDim": lambda m: m.ExpandDim(1),
    "Identity": lambda m: m.Identity(),
    "Max": lambda m: m.Max(1, return_value=False),
    "SplitTensor": lambda m: m.SplitTensor(1, 2),
    "Exp": lambda m: m.Exp(),
    "Log": lambda m: m.Log(),
    "Sqrt": lambda m: m.Sqrt(),
    "Square": lambda m: m.Square(),
    "Negative": lambda m: m.Negative(),
    "Power": lambda m: m.Power(2, 0.5, 1.0),
    "AddConstant": lambda m: m.AddConstant(2.5),
    "MulConstant": lambda m: m.MulConstant(-1.5),
    "CAdd": lambda m: m.CAdd((1, 4)),
    "CMul": lambda m: m.CMul((3, 1)),
    "Mul": lambda m: m.Mul(),
    "Scale": lambda m: m.Scale((3, 4)),
    "BinaryThreshold": lambda m: m.BinaryThreshold(0.1),
    "Threshold": lambda m: m.Threshold(0.2, -1.0),
    "HardTanh": lambda m: m.HardTanh(-0.5, 0.7),
    "HardShrink": lambda m: m.HardShrink(0.4),
    "SoftShrink": lambda m: m.SoftShrink(0.3),
    "GaussianNoise": lambda m: m.GaussianNoise(0.5),
    "GaussianDropout": lambda m: m.GaussianDropout(0.3),
    "GaussianSampler": lambda m: m.GaussianSampler(),
    "SpatialDropout1D": lambda m: m.SpatialDropout1D(0.4),
    "SpatialDropout2D": lambda m: m.SpatialDropout2D(0.5,
                                                     dim_ordering="tf"),
    "SpatialDropout3D": lambda m: m.SpatialDropout3D(0.5),
    "ResizeBilinear": lambda m: m.ResizeBilinear(6, 10),
    "SparseDense": lambda m: m.SparseDense(4, backward_start=2,
                                           backward_length=3),
    "SelectTable": lambda m: m.SelectTable(1),
    "Expand": lambda m: m.Expand((-1, 3, 4)),
    "GetShape": lambda m: m.GetShape(),
})


def _bert_case(pkg):
    cls = jsa.BERT if pkg is jl else tl.BERT
    return cls(vocab=50, hidden_size=16, n_block=1, n_head=2, seq_len=8,
               intermediate_size=32)


def _transformer_case(pkg):
    cls = jsa.TransformerLayer if pkg is jl else tl.TransformerLayer
    return cls(n_block=1, hidden_size=16, n_head=2, vocab=30, seq_len=8)


def _moe_transformer_case(pkg):
    cls = jsa.TransformerLayer if pkg is jl else tl.TransformerLayer
    return cls(n_block=1, hidden_size=16, n_head=2, vocab=30, seq_len=8,
               moe_experts=4, moe_top_k=1)


CONFIG_CASES["BERT"] = _bert_case
CONFIG_CASES["TransformerLayer"] = _transformer_case
CONFIG_CASES["TransformerLayer_moe"] = _moe_transformer_case
CONFIG_CASES.update({   # the layer library's rest
    "ELU": lambda m: m.ELU(0.7),
    "LeakyReLU": lambda m: m.LeakyReLU(0.2),
    "PReLU": lambda m: m.PReLU(n_output_plane=3),
    "RReLU": lambda m: m.RReLU(0.1, 0.4),
    "Softmax": lambda m: m.Softmax(axis=1),
    "SReLU": lambda m: m.SReLU(shared_axes=[1]),
    "ThresholdedReLU": lambda m: m.ThresholdedReLU(0.3),
    "Convolution3D": lambda m: m.Convolution3D(
        4, 2, 3, 1, border_mode="same", subsample=(2, 1, 1)),
    "Deconvolution2D": lambda m: m.Deconvolution2D(3, 3, 2,
                                                   subsample=(2, 2)),
    "ShareConvolution2D": lambda m: m.ShareConvolution2D(3, 2, 2),
    "LocallyConnected1D": lambda m: m.LocallyConnected1D(
        3, 2, subsample_length=2),
    "LocallyConnected2D": lambda m: m.LocallyConnected2D(
        2, 3, 3, border_mode="same", dim_ordering="tf"),
    "Cropping3D": lambda m: m.Cropping3D(((1, 0), (0, 1), (1, 1))),
    "UpSampling3D": lambda m: m.UpSampling3D((1, 2, 3)),
    "ZeroPadding3D": lambda m: m.ZeroPadding3D((1, 0, 2)),
    "ConvLSTM2D": lambda m: m.ConvLSTM2D(4, 3, return_sequences=True),
    "ConvLSTM3D": lambda m: m.ConvLSTM3D(2, 3, go_backwards=True),
    "CRF": lambda m: m.CRF(5),
    "SparseMoE": lambda m: m.SparseMoE(4, 8, top_k=1,
                                       capacity_factor=2.0),
})


def test_every_layer_class_has_a_config_case():
    classes = {type(make(tl)).__name__ for make in CONFIG_CASES.values()}
    ported = {n for n in tl.__all__ if isinstance(getattr(tl, n), type)}
    aliases = {"Conv1D", "Conv2D", "Conv3D", "KerasLayer"}
    # a wrapper's config is a callable, which saves only pickled: its
    # round trip is test_torch_torchnet.py's
    # test_keras_layer_wrapper_in_a_graph_saves_pickled
    callables = {"KerasLayerWrapper"}
    assert ported - aliases - callables <= classes


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_layer_config_matches_jax_and_round_trips(case):
    make = CONFIG_CASES[case]
    tlayer, jlayer = make(tl), make(jl)
    tcfg, jcfg = tlayer.get_config(), jlayer.get_config()
    assert set(tcfg) == set(jcfg)
    t_arrays, j_arrays = {}, {}
    t_spec = model_io._layer_spec(tlayer, t_arrays)
    j_spec = jio._layer_spec(jlayer, j_arrays)
    assert t_spec["class"] == j_spec["class"]
    assert t_spec["config"] == j_spec["config"]
    again = type(tlayer).from_config(tcfg)
    assert type(again) is type(tlayer)
    again.name = tlayer.name     # the spec keys a config's arrays by it
    assert model_io._layer_spec(again, {})["config"] == t_spec["config"]
