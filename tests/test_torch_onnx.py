"""The port's ONNX importer against the JAX package's on the CPU.

The same ONNX bytes, written with the builder (``pipeline/api/onnx/
builder.py``, a copy in both packages), load through JAX's ``OnnxLoader``
and the port's, and the same seeded numpy inputs go through both
``predict``s. Every op family of the registry has a case; the JAX tests'
MLP and CNN graphs (``tests/test_interop.py``) are held against torch
too; an imported model trains step for step as JAX's does; it saves and
loads; ``InferenceModel.load_onnx`` serves it in float32 and weight-only
int8.

Tolerances: outputs within 1e-5 absolute and relative (float32; the two
packages sum in other orders), exact for integer results and shapes;
``fit``'s per-step losses within 1e-5 and its weights within 2e-5, as
``test_torch_training.py`` holds the native models.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.onnx import OnnxLoader as JLoader
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet
from analytics_zoo_tpu_torch.pipeline.api.onnx import OnnxLoader, builder
from analytics_zoo_tpu_torch.pipeline.api.onnx import onnx_loader
from analytics_zoo_tpu_torch.pipeline.api.onnx.ops import REGISTRY
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


def _model_bytes(nodes, inputs, inits, outputs):
    g = builder.make_graph(
        nodes, "case",
        [builder.value_info(n, (None,) + a.shape[1:], a.dtype)
         for n, a in inputs.items()],
        [builder.value_info(n, ()) for n in outputs], inits)
    return builder.make_model(g)


def _both(raw, xs):
    """Rows of the JAX and the port's loads of ``raw`` on ``xs``."""
    xs = list(xs.values())
    arg = xs if len(xs) > 1 else xs[0]
    n = len(xs[0])
    want = JLoader.from_bytes(raw).predict(arg, batch_size=n)
    got = OnnxLoader.from_bytes(raw).predict(arg, batch_size=n)
    return got, want


def _close(got, want, tol=TOL):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _x(shape, seed=0, positive=False):
    rs = np.random.default_rng(seed)
    a = rs.standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _w(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


N = builder.make_node

# name -> () -> (nodes, inputs, initializers, outputs); every registry op
# appears in at least one case (test_every_registry_op_has_a_case)
CASES = {}


def case(name):
    def deco(fn):
        CASES[name] = fn
        return fn
    return deco


for _op in ["Add", "Sub", "Mul", "Div", "Pow", "Max", "Min"]:
    def _binary(op=_op):
        pos = op in ("Div", "Pow")
        return ([N(op, ["x", "y"], ["z"])],
                {"x": _x((3, 4, 5), 0, positive=pos),
                 "y": _x((3, 4, 5), 1, positive=pos)}, {}, ["z"])
    case(f"binary_{_op}")(_binary)

for _op in ["Max", "Min", "Sum", "Mean"]:
    def _variadic(op=_op):
        return ([N(op, ["x", "y", "c"], ["z"])],
                {"x": _x((2, 6), 2), "y": _x((2, 6), 3)},
                {"c": _w((6,), 4)}, ["z"])
    case(f"variadic_{_op}")(_variadic)

for _op in ["Abs", "Neg", "Exp", "Log", "Sqrt", "Floor", "Ceil", "Sin",
            "Cos", "Tanh", "Erf", "Sigmoid", "Relu", "Softplus", "Sign",
            "Reciprocal", "Softsign", "Identity", "Selu", "Elu",
            "LeakyRelu", "HardSigmoid", "Dropout"]:
    def _unary(op=_op):
        pos = op in ("Log", "Sqrt", "Reciprocal")
        return ([N(op, ["x"], ["y"])],
                {"x": _x((3, 7), 5, positive=pos) * 3}, {}, ["y"])
    case(f"unary_{_op}")(_unary)


@case("logic_where_cast")
def _logic():
    return ([N("Greater", ["x", "y"], ["g"]), N("Less", ["x", "y"], ["l"]),
             N("Equal", ["x", "x"], ["e"]), N("Not", ["l"], ["nl"]),
             N("And", ["g", "nl"], ["a"]), N("Or", ["a", "e"], ["o"]),
             N("Where", ["a", "x", "y"], ["w"]),
             N("Cast", ["o"], ["of"], to=1)],
            {"x": _x((4, 5), 6), "y": _x((4, 5), 7)}, {}, ["w", "of"])


@case("activations_with_attributes")
def _acts():
    return ([N("Clip", ["x"], ["c1"], min=-0.5, max=0.7),
             N("Clip", ["x", "lo", "hi"], ["c2"]),
             N("LeakyRelu", ["x"], ["lr"], alpha=0.3),
             N("Elu", ["x"], ["el"], alpha=0.7),
             N("PRelu", ["x", "slope"], ["pr"]),
             N("HardSigmoid", ["x"], ["hs"], alpha=0.3, beta=0.4),
             N("Gelu", ["x"], ["g1"]),
             N("Gelu", ["x"], ["g2"], approximate="tanh"),
             N("Softmax", ["x"], ["sm"], axis=1),
             N("LogSoftmax", ["x"], ["lsm"])],
            {"x": _x((3, 4, 6), 8) * 2},
            {"lo": np.asarray(-0.2, np.float32),
             "hi": np.asarray(0.4, np.float32), "slope": _w((6,), 9)},
            ["c1", "c2", "lr", "el", "pr", "hs", "g1", "g2", "sm", "lsm"])


@case("matmul_gemm")
def _gemm():
    return ([N("MatMul", ["x", "w"], ["m"]),
             N("Gemm", ["a", "wt", "b"], ["g1"], transB=1, alpha=0.5,
               beta=2.0)],
            {"x": _x((2, 3, 4), 10), "a": _x((2, 4), 11)},
            {"w": _w((4, 6), 13), "wt": _w((3, 4), 14), "b": _w((3,), 15)},
            ["m", "g1"])


def test_registry_impls_match_jax_on_host_arrays():
    """Attribute corners a batched graph cannot reach (Gemm's transA
    transposes the batch), impl against impl on the same arrays."""
    from analytics_zoo_tpu.pipeline.api.onnx.ops import REGISTRY as JREG

    a, b, c = _x((4, 5), 66), _x((4, 3), 67), _w((5, 3), 68)
    for op, attrs, ins in [
            ("Gemm", {"transA": 1, "alpha": 2.0}, [a, b]),
            ("Gemm", {"transA": 1, "transB": 1, "beta": 0.5},
             [a, b.T.copy(), c]),
            ("Squeeze", {}, [_x((1, 3, 1), 69)]),
            ("Transpose", {}, [_x((2, 3, 4), 70)]),
            ("Split", {"axis": 1, "num_outputs": 3}, [_x((2, 6), 71)]),
            ("ReduceSum", {"axes": []}, [_x((2, 3), 72)])]:
        got = [t.numpy() for t in REGISTRY[op](attrs, ins)]
        want = [np.asarray(t) for t in JREG[op](attrs, ins)]
        _close(got, want)


@case("conv")
def _conv():
    return ([N("Conv", ["x", "w", "b"], ["c1"], pads=[1, 0, 2, 1],
               strides=[2, 1], dilations=[1, 2], kernel_shape=[3, 3]),
             N("Conv", ["x", "wg"], ["c2"], group=2, kernel_shape=[3, 3],
               auto_pad="SAME_UPPER", strides=[2, 2]),
             N("Conv", ["x", "wg"], ["c3"], group=2, kernel_shape=[3, 3],
               auto_pad="SAME_LOWER", strides=[2, 2])],
            {"x": _x((2, 4, 9, 8), 17)},
            {"w": _w((5, 4, 3, 3), 18), "b": _w((5,), 19),
             "wg": _w((6, 2, 3, 3), 20)}, ["c1", "c2", "c3"])


@case("conv1d")
def _conv1d():
    return ([N("Conv", ["x", "w", "b"], ["c"], pads=[2, 1], strides=[2])],
            {"x": _x((2, 3, 11), 21)},
            {"w": _w((4, 3, 4), 22), "b": _w((4,), 23)}, ["c"])


@case("conv_transpose")
def _deconv():
    return ([N("ConvTranspose", ["x", "w", "b"], ["d1"], strides=[2, 2],
               pads=[1, 0, 1, 1], output_padding=[1, 0],
               kernel_shape=[3, 3]),
             N("ConvTranspose", ["x", "w"], ["d2"], strides=[2, 2],
               auto_pad="SAME_UPPER", kernel_shape=[3, 3])],
            # JAX's ConvTranspose reads the kernel as (C_out, C_in)
            {"x": _x((2, 3, 5, 4), 24)},
            {"w": _w((2, 3, 3, 3), 25), "b": _w((2,), 26)}, ["d1", "d2"])


@case("pooling")
def _pool():
    return ([N("MaxPool", ["x"], ["p1"], kernel_shape=[3, 3],
               strides=[2, 2], pads=[1, 1, 1, 0]),
             N("MaxPool", ["x"], ["p2"], kernel_shape=[2, 3],
               auto_pad="SAME_UPPER", strides=[2, 2]),
             N("AveragePool", ["x"], ["p3"], kernel_shape=[3, 3],
               strides=[2, 2], pads=[1, 1, 1, 1]),
             N("AveragePool", ["x"], ["p4"], kernel_shape=[3, 3],
               strides=[2, 2], pads=[1, 1, 1, 1], count_include_pad=1),
             N("AveragePool", ["x"], ["p5"], kernel_shape=[2, 2]),
             N("GlobalAveragePool", ["x"], ["p6"]),
             N("GlobalMaxPool", ["x"], ["p7"])],
            {"x": _x((2, 3, 9, 7), 27)}, {},
            ["p1", "p2", "p3", "p4", "p5", "p6", "p7"])


@case("normalization")
def _norms():
    var = np.abs(_w((4,), 31)) + 0.5
    return ([N("BatchNormalization", ["x", "g", "bt", "mu", "var"], ["bn"],
               epsilon=1e-3),
             N("InstanceNormalization", ["x", "g", "bt"], ["inn"]),
             N("LayerNormalization", ["x", "lg", "lb"], ["ln"]),
             N("LRN", ["x"], ["lrn"], size=3, alpha=0.001, beta=0.6,
               bias=1.5)],
            {"x": _x((2, 4, 5, 6), 28)},
            {"g": _w((4,), 29), "bt": _w((4,), 30), "mu": _w((4,), 32),
             "var": var, "lg": _w((6,), 33), "lb": _w((6,), 34)},
            ["bn", "inn", "ln", "lrn"])


@case("reshape_flatten_transpose")
def _reshape():
    return ([N("Reshape", ["x", "shape"], ["r"]),
             N("Flatten", ["x"], ["f"], axis=2),
             N("Transpose", ["x"], ["t"], perm=[0, 3, 1, 2]),
             N("Transpose", ["r"], ["t2"])],
            {"x": _x((2, 3, 4, 5), 35)},
            {"shape": np.asarray([0, -1, 5], np.int64)},
            ["r", "f", "t", "t2"])


@case("concat_split_squeeze")
def _concat():
    return ([N("Concat", ["x", "y"], ["c"], axis=1),
             N("Split", ["c"], ["s1", "s2", "s3"], axis=1, split=[2, 3, 2]),
             N("Split", ["c", "parts"], ["t1", "t2"], axis=2),
             N("Unsqueeze", ["s1", "ax"], ["u"]),
             N("Squeeze", ["u", "ax"], ["q"]),
             N("Unsqueeze", ["t1"], ["u2"], axes=[1, 3]),
             N("Squeeze", ["u2"], ["q2"], axes=[3])],
            {"x": _x((2, 3, 4), 36), "y": _x((2, 4, 4), 37)},
            {"parts": np.asarray([1, 3], np.int64),
             "ax": np.asarray([1], np.int64)},
            ["q", "s2", "s3", "t2", "q2"])


@case("expand_tile_gather_slice")
def _gather():
    return ([N("Expand", ["x", "es"], ["e"]),
             N("Tile", ["x", "reps"], ["t"]),
             N("Gather", ["x", "idx"], ["g"], axis=2),
             N("GatherElements", ["x", "gidx"], ["ge"], axis=2),
             N("Slice", ["x", "st", "en", "axs", "sp"], ["s1"]),
             N("Slice", ["x", "st2", "en2"], ["s2"])],
            {"x": _x((2, 3, 5), 38)},
            {"es": np.asarray([4, 1, 1, 5], np.int64),
             "reps": np.asarray([1, 2, 1], np.int64),
             "idx": np.asarray([[0, -1], [2, 1]], np.int64),
             "gidx": np.random.default_rng(39).integers(
                 -5, 5, (1, 3, 4)).astype(np.int64),
             "st": np.asarray([4, 0], np.int64),
             "en": np.asarray([0, 100], np.int64),
             "axs": np.asarray([2, 1], np.int64),
             "sp": np.asarray([-2, 2], np.int64),
             "st2": np.asarray([0, 1, -4], np.int64),
             "en2": np.asarray([2, 3, -1], np.int64)},
            ["e", "t", "g", "ge", "s1", "s2"])


@case("pad")
def _pad():
    return ([N("Pad", ["x", "pads"], ["p1"]),
             N("Pad", ["x", "pads", "val"], ["p2"]),
             N("Pad", ["x", "pads"], ["p3"], mode="reflect"),
             N("Pad", ["x", "pads"], ["p4"], mode="edge")],
            {"x": _x((2, 3, 4, 5), 40)},
            {"pads": np.asarray([0, 1, 2, 1, 0, 0, 1, 3], np.int64),
             "val": np.asarray(1.5, np.float32)},
            ["p1", "p2", "p3", "p4"])


@case("constants_and_shape_machinery")
def _consts():
    return ([N("Shape", ["x"], ["s"]),
             N("Size", ["x"], ["n"]),
             N("ConstantOfShape", ["s"], ["ones"],
               value=np.asarray([2.0], np.float32)),
             N("Constant", [], ["k"], value=np.asarray([0.5], np.float32)),
             N("Range", ["r0", "r1", "r2"], ["ar"]),
             N("Cast", ["ar"], ["arf"], to=1),
             N("Mul", ["x", "ones"], ["a"]),
             N("Add", ["a", "k"], ["b"]),
             N("Add", ["b", "arf"], ["c"]),
             N("Cast", ["n"], ["nf"], to=1),
             N("Mul", ["c", "nf"], ["y"])],
            {"x": _x((2, 3, 4), 41)},
            {"r0": np.asarray(0, np.int64), "r1": np.asarray(8, np.int64),
             "r2": np.asarray(2, np.int64)}, ["y"])


@case("reductions")
def _reduce():
    return ([N("ReduceSum", ["x", "axes"], ["r1"], keepdims=0),
             N("ReduceMean", ["x"], ["r2"], axes=[1, 2]),
             N("ReduceMax", ["x"], ["r3"], axes=[-1], keepdims=0),
             N("ReduceMin", ["x"], ["r4"], axes=[1]),
             N("ReduceProd", ["x"], ["r5"], axes=[2], keepdims=0),
             N("ReduceL2", ["x"], ["r6"], axes=[1, 2], keepdims=0),
             N("ReduceSum", ["x"], ["r7"])],
            {"x": _x((2, 3, 4), 42)},
            {"axes": np.asarray([1], np.int64)},
            ["r1", "r2", "r3", "r4", "r5", "r6", "r7"])


@case("argmax_topk")
def _topk():
    return ([N("ArgMax", ["x"], ["am"], axis=1),
             N("ArgMin", ["x"], ["an"], axis=2, keepdims=0),
             N("Cast", ["am"], ["amf"], to=1),
             N("Cast", ["an"], ["anf"], to=1),
             N("TopK", ["x", "k"], ["tv", "ti"], axis=1),
             N("TopK", ["x", "k"], ["sv", "si"], axis=-1, largest=0),
             N("Cast", ["ti"], ["tif"], to=1),
             N("Cast", ["si"], ["sif"], to=1)],
            {"x": _x((2, 5, 6), 43)}, {"k": np.asarray([3], np.int64)},
            ["amf", "anf", "tv", "tif", "sv", "sif"])


def test_every_registry_op_has_a_case():
    seen = set()
    for make in CASES.values():
        seen |= {n["op_type"] for n in make()[0]}
    assert set(REGISTRY) <= seen, sorted(set(REGISTRY) - seen)


@pytest.mark.parametrize("name", sorted(CASES))
def test_onnx_op_family_matches_jax(name):
    nodes, inputs, inits, outputs = CASES[name]()
    got, want = _both(_model_bytes(nodes, inputs, inits, outputs), inputs)
    _close(got, want)


def test_topk_axis_and_smallest_as_jax():
    x = np.asarray([[5.0, 1.0], [3.0, 4.0], [2.0, 9.0]], np.float32)
    vals, idx = REGISTRY["TopK"]({"axis": 0, "k": 2}, [x])
    np.testing.assert_allclose(vals.numpy(), [[5.0, 9.0], [3.0, 4.0]])
    np.testing.assert_array_equal(idx.numpy(), [[0, 2], [1, 1]])
    vals, _ = REGISTRY["TopK"]({"axis": 0, "k": 1, "largest": 0}, [x])
    np.testing.assert_allclose(vals.numpy(), [[2.0, 1.0]])


def _mlp_bytes(m):
    nodes = [N("Gemm", ["x", "w0", "b0"], ["h0"], transB=1),
             N("Relu", ["h0"], ["h1"]),
             N("Gemm", ["h1", "w2", "b2"], ["y"], transB=1)]
    g = builder.make_graph(
        nodes, "mlp", [builder.value_info("x", (None, 6))],
        [builder.value_info("y", (None, 3))],
        {"w0": m[0].weight.detach().numpy(),
         "b0": m[0].bias.detach().numpy(),
         "w2": m[2].weight.detach().numpy(),
         "b2": m[2].bias.detach().numpy()})
    return builder.make_model(g)


def test_mlp_matches_torch_and_jax():
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 3))
    x = _x((4, 6), 44)
    got, want = _both(_mlp_bytes(m), {"x": x})
    _close(got, want)
    np.testing.assert_allclose(got, m(torch.from_numpy(x)).detach().numpy(),
                               atol=TOL, rtol=TOL)


def test_shape_machinery_runs_once_per_input_signature(monkeypatch):
    """The JAX layer folds the Shape -> Gather -> Concat -> Reshape idiom
    under tracing; the port runs it at the first call of a signature and
    then only the device nodes."""
    nodes = [N("Shape", ["x"], ["s"]),
             N("Gather", ["s", "zero"], ["b"], axis=0),
             N("Unsqueeze", ["b", "ax"], ["b1"]),
             N("Concat", ["b1", "minus1"], ["target"], axis=0),
             N("Reshape", ["x", "target"], ["y"])]
    inits = {"zero": np.asarray(0, np.int64),
             "ax": np.asarray([0], np.int64),
             "minus1": np.asarray([-1], np.int64)}
    raw = _model_bytes(nodes, {"x": _x((4, 2, 3))}, inits, ["y"])
    model = OnnxLoader.from_bytes(raw)
    module = model.graph_function().layers[-1]
    calls = []
    real = onnx_loader.GraphModule._run_host

    def counted(node, env):
        calls.append(node.op_type)
        return real(node, env)

    monkeypatch.setattr(onnx_loader.GraphModule, "_run_host",
                        staticmethod(counted))
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    for _ in range(3):
        np.testing.assert_array_equal(model.predict(x, batch_size=4),
                                      x.reshape(4, 6))
    assert calls == ["Shape", "Gather", "Unsqueeze", "Concat"]
    np.testing.assert_array_equal(model.predict(x[:2], batch_size=2),
                                  x[:2].reshape(2, 6))
    assert len(calls) == 8
    assert len(module._signatures) == 3     # 2 predicts + the shape probe
    got, want = _both(raw, {"x": x})
    _close(got, want)


def _cnn_bytes(rs):
    nodes = [N("Conv", ["x", "w1", "c1"], ["a"], pads=[1, 1, 1, 1],
               kernel_shape=[3, 3]),
             N("BatchNormalization", ["a", "g", "beta", "mu", "var"], ["b"],
               epsilon=1e-5),
             N("Relu", ["b"], ["c"]),
             N("MaxPool", ["c"], ["d"], kernel_shape=[2, 2],
               strides=[2, 2]),
             N("Conv", ["d", "w2", "c2"], ["e"], strides=[2, 2],
               kernel_shape=[3, 3]),
             N("Relu", ["e"], ["f"]),
             N("GlobalAveragePool", ["f"], ["gap"]),
             N("Flatten", ["gap"], ["flat"]),
             N("Gemm", ["flat", "wf", "bf"], ["y"], transB=1)]
    inits = {"w1": _w((8, 3, 3, 3), 50), "c1": _w((8,), 51),
             "g": _w((8,), 52), "beta": _w((8,), 53), "mu": _w((8,), 54),
             "var": np.abs(_w((8,), 55)) + 0.5, "w2": _w((4, 8, 3, 3), 56),
             "c2": _w((4,), 57), "wf": _w((5, 4), 58), "bf": _w((5,), 59)}
    g = builder.make_graph(
        nodes, "cnn", [builder.value_info("x", (None, 3, 12, 12))],
        [builder.value_info("y", (None, 5))], inits)
    return builder.make_model(g)


def test_cnn_matches_jax():
    x = _x((8, 3, 12, 12), 60)
    got, want = _both(_cnn_bytes(None), {"x": x})
    _close(got, want)


def test_imported_model_fits_step_for_step_as_jax(tmp_path):
    """Initializers are trainable parameters in both packages: the same
    Adam steps from the same weights give the same losses and weights."""
    raw = _cnn_bytes(None)
    jmodel = JLoader.from_bytes(raw)
    tmodel = OnnxLoader.from_bytes(raw)
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="mse")
    jmodel.set_tensorboard(str(tmp_path), "jax")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    rs = np.random.default_rng(61)
    x = rs.standard_normal((16, 3, 12, 12)).astype(np.float32)
    y = rs.standard_normal((16, 5)).astype(np.float32)
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    assert len(tmodel.trainer.step_losses) == len(jlosses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=0, atol=1e-5)
    jw = jax.tree.map(np.asarray, jmodel.get_params())
    (jname,) = jw
    for name, p in tmodel.graph_function().layers[-1].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jw[jname][name],
                                   rtol=0, atol=2e-5, err_msg=name)


def test_initializer_names_with_dots_load_jax_weights():
    nodes = [N("MatMul", ["x", "fc.weight"], ["y"])]
    inputs = {"x": _x((3, 4), 62)}
    raw = _model_bytes(nodes, inputs, {"fc.weight": _w((4, 2), 63)}, ["y"])
    jmodel, tmodel = JLoader.from_bytes(raw), OnnxLoader.from_bytes(raw)
    layer = tmodel.graph_function().layers[-1]
    assert [n for n, _ in layer.named_parameters()] == ["fc_weight"]
    new = {k: {n: v * 3 for n, v in t.items()}
           for k, t in jax.tree.map(np.asarray,
                                    jmodel.get_params()).items()}
    load_jax_params(tmodel, new)
    np.testing.assert_allclose(
        tmodel.predict(inputs["x"], batch_size=3),
        inputs["x"] @ (_w((4, 2), 63) * 3), rtol=TOL, atol=TOL)


def test_imported_model_saves_and_loads(tmp_path):
    raw = _cnn_bytes(None)
    model = OnnxLoader.from_bytes(raw)
    x = _x((4, 3, 12, 12), 64)
    want = model.predict(x, batch_size=4)
    model.save_model(str(tmp_path / "onnx"))
    again = KerasNet.load_model(str(tmp_path / "onnx"))
    np.testing.assert_array_equal(again.predict(x, batch_size=4), want)


@pytest.mark.parametrize("quantize", [False, True])
def test_inference_model_load_onnx_matches_jax(tmp_path, quantize):
    """``load_onnx``: float32 rows as JAX's; with ``quantize`` both
    packages quantize the same kernel leaves (the names holding a
    ``KERNEL_KEYS`` entry, 2-D and up) int8 weight-only, and the rows
    agree within the same tolerance."""
    path = str(tmp_path / "cnn.onnx")
    builder.save_model(_cnn_bytes(None), path)
    x = _x((8, 3, 12, 12), 65)
    jm = JInferenceModel().load_onnx(path, quantize=quantize)
    tm = InferenceModel().load_onnx(path, quantize=quantize)
    _close(tm.predict(x), np.asarray(jm.predict(x)))
    if quantize:
        from analytics_zoo_tpu.ops import quant as jquant
        leaves = jax.tree_util.tree_flatten_with_path(
            jm.model._params,
            is_leaf=lambda v: isinstance(v, jquant.QuantTensor))[0]
        jq = {str(path[-1].key): np.asarray(v.q) for path, v in leaves
              if isinstance(v, jquant.QuantTensor)}
        tq = {k.split("['")[-1][:-2]: qt.q.cpu().numpy()
              for k, qt in tm.model.kernels.items()}
        assert sorted(tq) == sorted(jq) == ["w1", "w2", "wf"]
        for k in tq:
            np.testing.assert_array_equal(tq[k].reshape(jq[k].shape),
                                          jq[k], err_msg=k)
        floats = InferenceModel().load_onnx(path).predict(x)
        assert np.abs(tm.predict(x) - floats).max() > 0
