"""The port's Caffe importer against the JAX package's on the CPU.

The same prototxt and caffemodel bytes (written here: the JAX package's
own caffe tests read reference fixtures that are not in the repository,
``tests/test_caffe.py:15``) load through JAX's ``load_caffe`` and the
port's, and the same seeded inputs go through both. The cases are the
layer set of ``tests/test_caffe.py:53-241`` (convolution, CEIL pooling,
InnerProduct, Softmax, BatchNorm with its scale factor, Scale, Eltwise
with coefficients and its field-scoped MAX, Concat, LRN, V1 binary
layers, Dropout, global pooling) and the rest of the interpreter
(Deconvolution, average pooling with pads, Slice, Split, Reshape,
Flatten, PReLU, ELU, Sigmoid, TanH, AbsVal, Power, within-channel LRN, a
two-bottom Scale, an Input layer, train-only layers and
SoftmaxWithLoss); then fit, save/load and ``InferenceModel.load_caffe``.

Tolerances: rows within 1e-5 absolute and relative (float32; other
summation orders); fit's per-step losses within 1e-5, weights 2e-5.
"""

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.caffe import load_caffe as jload_caffe
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.caffe import load_caffe
from analytics_zoo_tpu_torch.pipeline.api.caffe import proto as cproto
from analytics_zoo_tpu_torch.pipeline.api.caffe.text_format import \
    parse_prototxt
from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.utils import load_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                                     devices=jax.devices()[:1]))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _blob(arr, packed=True):
    """A BlobProto: the data packed from the array's bytes (the port's
    encoder), or as JAX's tests write it, one float at a time."""
    arr = np.asarray(arr, np.float32)
    return {"shape": {"dim": [int(d) for d in arr.shape]},
            "data": arr.ravel() if packed else
            [float(v) for v in arr.ravel()]}


def _w(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _files(tmp_path, prototxt, layers, name="net"):
    ptx = tmp_path / "net.prototxt"
    ptx.write_text(prototxt)
    cm = tmp_path / "net.caffemodel"
    cm.write_bytes(cproto.encode({"name": name, "layer": layers},
                                 "NetParameter"))
    return str(ptx), str(cm)


def _both(ptx, cm, xs, n):
    arg = xs if len(xs) > 1 else xs[0]
    want = jload_caffe(ptx, cm).predict(arg, batch_size=n)
    got = load_caffe(ptx, cm).predict(arg, batch_size=n)
    return got, want


def _close(got, want, tol=TOL):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CONV_POOL_IP = """
name: "golden"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 5 kernel_size: 3 pad: 1 stride: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 1 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 4 bias_term: false } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""


@pytest.mark.parametrize("packed", [True, False])
def test_conv_pool_ip_softmax_matches_jax(tmp_path, packed):
    ptx, cm = _files(tmp_path, CONV_POOL_IP, [
        {"name": "conv1", "type": "Convolution",
         "blobs": [_blob(_w((5, 3, 3, 3), 1), packed),
                   _blob(_w((5,), 2), packed)]},
        {"name": "ip1", "type": "InnerProduct",
         "blobs": [_blob(_w((4, 45), 3), packed)]}])
    _close(*_both(ptx, cm, [_x((2, 3, 8, 8), 4)], 2))


BN_SCALE_ELTWISE = """
name: "golden2"
input: "data"
input_shape { dim: 2 dim: 4 dim: 6 dim: 6 }
layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn"
  batch_norm_param { use_global_stats: true eps: 1e-5 } }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
  scale_param { bias_term: true } }
layer { name: "sum" type: "Eltwise" bottom: "sc" bottom: "data" top: "sum"
  eltwise_param { operation: SUM coeff: 1.0 coeff: 0.5 } }
layer { name: "prod" type: "Eltwise" bottom: "sum" bottom: "data"
  top: "prod" eltwise_param { operation: PROD } }
layer { name: "cat" type: "Concat" bottom: "prod" bottom: "data" top: "cat"
  concat_param { axis: 1 } }
layer { name: "lrn" type: "LRN" bottom: "cat" top: "lrn"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "lrn2" type: "LRN" bottom: "lrn" top: "lrn2"
  lrn_param { local_size: 3 alpha: 0.01 beta: 0.6 k: 2
              norm_region: WITHIN_CHANNEL } }
"""


def test_batchnorm_scale_eltwise_concat_lrn_match_jax(tmp_path):
    c = 4
    ptx, cm = _files(tmp_path, BN_SCALE_ELTWISE, [
        {"name": "bn", "type": "BatchNorm",
         "blobs": [_blob(_w((c,), 5)),
                   _blob(np.abs(_w((c,), 6)) + 0.5),
                   _blob(np.array([2.0], np.float32))]},
        {"name": "sc", "type": "Scale",
         "blobs": [_blob(_w((c,), 7)), _blob(_w((c,), 8))]}])
    _close(*_both(ptx, cm, [_x((2, 4, 6, 6), 9)], 2))


def test_v1_layers_binary_decode_match_jax(tmp_path):
    """V1 ('layers', enum types), no prototxt: the caffemodel alone."""
    buf = cproto.encode({
        "name": "v1net", "input": ["data"], "input_dim": [1, 3, 4, 4],
        "layers": [
            {"name": "c", "type": 4, "bottom": ["data"], "top": ["c"],
             "convolution_param": {"num_output": 2, "kernel_size": [1]},
             "blobs": [_blob(_w((2, 3, 1, 1), 10), False),
                       _blob(np.zeros(2, np.float32), False)]},
            {"name": "r", "type": 18, "bottom": ["c"], "top": ["c"]},
            {"name": "p", "type": 17, "bottom": ["c"], "top": ["p"],
             "pooling_param": {"pool": 1, "kernel_size": 3,
                               "stride": 2, "pad": 1}}]},
        "NetParameter")
    path = tmp_path / "v1.caffemodel"
    path.write_bytes(buf)
    x = _x((2, 3, 4, 4), 11)
    want = jload_caffe(None, str(path)).predict(x, batch_size=2)
    got = load_caffe(None, str(path)).predict(x, batch_size=2)
    _close(got, want)


def test_dropout_identity_and_global_pool_match_jax(tmp_path):
    ptx, cm = _files(tmp_path, """
name: "g"
input: "data"
input_shape { dim: 2 dim: 3 dim: 5 dim: 5 }
layer { name: "do" type: "Dropout" bottom: "data" top: "do"
        dropout_param { dropout_ratio: 0.5 } }
layer { name: "gp" type: "Pooling" bottom: "do" top: "gp"
        pooling_param { pool: AVE global_pooling: true } }
layer { name: "gm" type: "Pooling" bottom: "do" top: "gm"
        pooling_param { pool: MAX global_pooling: true } }
""", [])
    got, want = _both(ptx, cm, [_x((2, 3, 5, 5), 12)], 2)
    _close(got, want)


def test_eltwise_max_enum_is_field_scoped(tmp_path):
    prototxt = """
name: "m"
input: "a"
input_shape { dim: 2 dim: 3 }
input: "b"
input_shape { dim: 2 dim: 3 }
layer { name: "mx" type: "Eltwise" bottom: "a" bottom: "b" top: "mx"
  eltwise_param { operation: MAX } }
"""
    assert parse_prototxt(prototxt)["layer"][0]["eltwise_param"][
        "operation"] == 2
    ptx, cm = _files(tmp_path, prototxt, [])
    a, b = _x((2, 3), 13), _x((2, 3), 14)
    got, want = _both(ptx, cm, [a, b], 2)
    _close(got, want)
    np.testing.assert_allclose(got, np.maximum(a, b), rtol=1e-6)


REST = """
name: "rest"
layer { name: "in" type: "Input" top: "data"
  input_param { shape { dim: 2 dim: 4 dim: 7 dim: 6 } } }
layer { name: "dtrain" type: "Data" top: "label"
  include { phase: TRAIN } }
layer { name: "deconv" type: "Deconvolution" bottom: "data" top: "dc"
  convolution_param { num_output: 3 kernel_size: 3 pad: 1 stride: 2 } }
layer { name: "ap" type: "Pooling" bottom: "dc" top: "ap"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "mp" type: "Pooling" bottom: "dc" top: "mp"
  pooling_param { pool: MAX kernel_h: 2 kernel_w: 3 stride: 2 } }
layer { name: "sl" type: "Slice" bottom: "data" top: "s1" top: "s2"
  top: "s3" slice_param { axis: 1 slice_point: 1 slice_point: 3 } }
layer { name: "sp" type: "Split" bottom: "s2" top: "t1" top: "t2" }
layer { name: "pr" type: "PReLU" bottom: "t1" top: "pr" }
layer { name: "el" type: "ELU" bottom: "t2" top: "el"
  elu_param { alpha: 0.5 } }
layer { name: "sg" type: "Sigmoid" bottom: "s1" top: "sg" }
layer { name: "th" type: "TanH" bottom: "s3" top: "th" }
layer { name: "ab" type: "AbsVal" bottom: "th" top: "ab" }
layer { name: "pw" type: "Power" bottom: "ab" top: "pw"
  power_param { power: 2 scale: 0.5 shift: 1 } }
layer { name: "sc2" type: "Scale" bottom: "pr" bottom: "el" top: "sc2"
  scale_param { axis: 0 } }
layer { name: "rs" type: "Reshape" bottom: "mp" top: "rs"
  reshape_param { shape { dim: 0 dim: -1 dim: 3 } } }
layer { name: "fl" type: "Flatten" bottom: "ap" top: "fl" }
layer { name: "ip" type: "InnerProduct" bottom: "fl" top: "ip"
  inner_product_param { num_output: 5 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
layer { name: "lk" type: "ReLU" bottom: "sg" top: "lk"
  relu_param { negative_slope: 0.1 } }
"""


def test_the_rest_of_the_layer_set_matches_jax(tmp_path):
    ptx, cm = _files(tmp_path, REST, [
        {"name": "deconv", "type": "Deconvolution",
         "blobs": [_blob(_w((4, 3, 3, 3), 15)), _blob(_w((3,), 16))]},
        {"name": "pr", "type": "PReLU", "blobs": [_blob(_w((2,), 17))]},
        {"name": "ip", "type": "InnerProduct",
         "blobs": [_blob(_w((5, 3 * 7 * 6), 18)), _blob(_w((5,), 19))]}])
    got, want = _both(ptx, cm, [_x((2, 4, 7, 6), 20)], 2)
    assert len(got) == 5      # the net's unconsumed tops
    _close(got, want)


def test_imported_net_fits_step_for_step_as_jax(tmp_path):
    """Average pooling: JAX cannot differentiate its max pooling's
    ``reduce_window`` (ROADMAP C), the port can (the card's leg B)."""
    ptx, cm = _files(tmp_path, CONV_POOL_IP.replace("pool: MAX",
                                                   "pool: AVE"), [
        {"name": "conv1", "type": "Convolution",
         "blobs": [_blob(_w((5, 3, 3, 3), 21)), _blob(_w((5,), 22))]},
        {"name": "ip1", "type": "InnerProduct",
         "blobs": [_blob(_w((4, 45), 23))]}])
    jmodel, tmodel = jload_caffe(ptx, cm), load_caffe(ptx, cm)
    for m in (jmodel, tmodel):
        m.compile(optimizer="sgd", loss="categorical_crossentropy")
    jmodel.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    rs = np.random.default_rng(24)
    x = rs.standard_normal((16, 3, 8, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.integers(0, 4, 16)]
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=0, atol=1e-5)
    jw = jax.tree.map(np.asarray, jmodel.get_params())["golden"]
    for name, p in tmodel.graph_function().layers[-1].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jw[name], rtol=0,
                                   atol=2e-5, err_msg=name)


def test_imported_net_saves_and_loads(tmp_path):
    ptx, cm = _files(tmp_path, BN_SCALE_ELTWISE, [
        {"name": "bn", "type": "BatchNorm",
         "blobs": [_blob(_w((4,), 25)), _blob(np.abs(_w((4,), 26)) + 1),
                   _blob(np.array([1.0], np.float32))]},
        {"name": "sc", "type": "Scale",
         "blobs": [_blob(_w((4,), 27)), _blob(_w((4,), 28))]}])
    model = load_caffe(ptx, cm)
    x = _x((2, 4, 6, 6), 29)
    want = model.predict(x, batch_size=2)
    model.save_model(str(tmp_path / "saved"))
    again = KerasNet.load_model(str(tmp_path / "saved"))
    np.testing.assert_array_equal(again.predict(x, batch_size=2), want)


@pytest.mark.parametrize("quantize", [False, True])
def test_inference_model_load_caffe_matches_jax(tmp_path, quantize):
    """``load_caffe``: rows as JAX's. A net's blobs are named
    ``"{layer}/{blob}"``, which holds no ``KERNEL_KEYS`` entry, so with
    ``quantize`` neither package quantizes anything: the rows are the
    float32 rows (ROADMAP A14.5's note)."""
    ptx, cm = _files(tmp_path, CONV_POOL_IP, [
        {"name": "conv1", "type": "Convolution",
         "blobs": [_blob(_w((5, 3, 3, 3), 30)), _blob(_w((5,), 31))]},
        {"name": "ip1", "type": "InnerProduct",
         "blobs": [_blob(_w((4, 45), 32))]}])
    x = _x((4, 3, 8, 8), 33)
    jm = JInferenceModel().load_caffe(ptx, cm, quantize=quantize)
    tm = InferenceModel().load_caffe(ptx, cm, quantize=quantize)
    _close(tm.predict(x), np.asarray(jm.predict(x)))
    if quantize:
        assert tm.model.kernels == {}
        np.testing.assert_array_equal(
            tm.predict(x), InferenceModel().load_caffe(ptx, cm).predict(x))


def test_packed_blobs_decode_as_float_lists_do():
    arr = _w((3, 4, 5), 34)
    packed = cproto.decode(cproto.encode(
        {"name": "n", "layer": [{"name": "l", "blobs": [_blob(arr)]}]},
        "NetParameter"), "NetParameter")
    listed = cproto.decode(cproto.encode(
        {"name": "n", "layer": [{"name": "l",
                                 "blobs": [_blob(arr, False)]}]},
        "NetParameter"), "NetParameter")
    for net in (packed, listed):
        np.testing.assert_array_equal(
            cproto.blob_to_numpy(net["layer"][0]["blobs"][0]), arr)
