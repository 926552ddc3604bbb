"""The port's TF GraphDef translator against the JAX package's on the CPU.

Every name of the op registry (``TF_REGISTRY``, 110 names, the same set in
both packages) has at least one case: a graph TensorFlow writes here by
tracing a ``tf.function`` over the op (``tf.raw_ops`` where an attribute
matters), with Consts made from a seeded numpy draw. The same serialized
GraphDef goes to JAX's ``TFGraphFunction`` (through TensorFlow's parser)
and to the port's (through its own reader), with the same seeded inputs.

Tolerances: float32 outputs within 1e-5 absolute and relative (the two
packages sum in other orders), integer and boolean outputs exact;
gradients of a seeded cotangent with respect to the float Consts (the
trainable params) and the float inputs within 1e-4.

The cases cover SAME, VALID and EXPLICIT padding, NCHW, negative strides,
``name:k`` outputs, control inputs, ``PlaceholderWithDefault`` and
``Cast`` to each DataType of the port's table. A depthwise multiplier of
2 is held against TensorFlow's own run instead: JAX orders its output
channels as multiplier-major (ROADMAP C40), TF and the port as
channel-major.
"""

import os
import zlib

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

tf = pytest.importorskip("tensorflow")

from analytics_zoo_tpu.pipeline.api.net.tf_graph import \
    TF_REGISTRY as J_REGISTRY  # noqa: E402
from analytics_zoo_tpu.pipeline.api.net.tf_graph import \
    TFGraphFunction as JGraph  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.net import graphdef as gd  # noqa
from analytics_zoo_tpu_torch.pipeline.api.net.tf_graph import (  # noqa
    TF_REGISTRY, TFGraphFunction, UnsupportedTFGraph)

TOL = 1e-5
GRAD_TOL = 1e-4
raw = tf.raw_ops


def _r(seed):
    return np.random.default_rng(seed)


def _f(r, *shape, lo=None, hi=None):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


# -- cases --------------------------------------------------------------------
# each case: (id, registry names it covers, maker). A maker takes a
# numpy Generator and returns (fn, inputs): ``fn`` is traced over
# TensorSpecs of ``inputs`` (numpy arrays; a leading None batch dim where
# the array's first dim is marked with ``dyn``).

CASES = []


def case(cid, names, dyn=False):
    def deco(fn):
        CASES.append((cid, tuple(names), fn, dyn))
        return fn
    return deco


_IDENT = ("Identity", "StopGradient", "PreventGradient", "CheckNumerics",
          "Snapshot")
for _op in _IDENT:
    def _b(r, _op=_op):
        c = _f(r, 3, 4)
        arg = "tensor" if _op == "CheckNumerics" else "input"
        kw = {"message": "x"} if _op == "CheckNumerics" else {}
        return (lambda x: getattr(raw, _op)(
            **{arg: x * tf.constant(c)}, **kw), [_f(r, 3, 4)])
    case(f"unary_{_op}", [_op])(_b)


@case("ensure_shape", ["EnsureShape"])
def _(r):
    c = _f(r, 3, 4)
    return (lambda x: raw.EnsureShape(input=x * tf.constant(c),
                                      shape=[3, 4]), [_f(r, 3, 4)])


@case("identity_n_outputs_k", ["IdentityN"])
def _(r):
    c = _f(r, 2, 3)
    return (lambda x: tuple(raw.IdentityN(input=[x * tf.constant(c),
                                                 x + tf.constant(c)])),
            [_f(r, 2, 3)])


@case("noop_control_input", ["NoOp"])
def _(r):
    c = _f(r, 4)

    def fn(x):
        with tf.control_dependencies([raw.NoOp()]):
            return tf.identity(x * tf.constant(c))
    return fn, [_f(r, 4)]


_FLOAT_BIN = {"Add": {}, "AddV2": {}, "Sub": {}, "Mul": {}, "Div": {},
              "RealDiv": {}, "FloorDiv": {}, "Maximum": {}, "Minimum": {},
              "Pow": {"lo": 0.5, "hi": 2.0},
              "SquaredDifference": {}, "Mod": {}}
for _op, _rng in _FLOAT_BIN.items():
    def _b(r, _op=_op, _rng=_rng):
        c = _f(r, 3, 4, **_rng)
        if _op in ("Div", "RealDiv", "FloorDiv", "Mod"):
            c = np.where(np.abs(c) < 0.3, 0.7, c).astype(np.float32)
        return (lambda x: getattr(raw, _op)(x=x, y=tf.constant(c)),
                [_f(r, 3, 4, **_rng)])
    case(f"float_{_op}", [_op])(_b)

for _op in ("FloorDiv", "Mod", "Add", "Mul", "Maximum"):
    def _b(r, _op=_op):
        c = r.integers(1, 6, (5,)) * r.choice([-1, 1], 5)
        return (lambda x: getattr(raw, _op)(
            x=x, y=tf.constant(c.astype(np.int32))),
            [r.integers(-20, 20, (5,)).astype(np.int32)])
    case(f"int_{_op}", [_op])(_b)

for _op in ("Greater", "GreaterEqual", "Less", "LessEqual", "Equal",
            "NotEqual"):
    def _b(r, _op=_op):
        c = np.round(_f(r, 6)).astype(np.float32)
        return (lambda x: getattr(raw, _op)(x=x, y=tf.constant(c)),
                [np.round(_f(r, 6)).astype(np.float32)])
    case(f"compare_{_op}", [_op])(_b)

for _op in ("LogicalAnd", "LogicalOr"):
    def _b(r, _op=_op):
        c = _f(r, 6) > 0
        return (lambda x: getattr(raw, _op)(x=x > 0, y=tf.constant(c)),
                [_f(r, 6)])
    case(f"logical_{_op}", [_op, "Greater"])(_b)


@case("logical_not", ["LogicalNot", "Less"])
def _(r):
    return (lambda x: raw.LogicalNot(x=x < tf.constant(_f(r, 6))),
            [_f(r, 6)])


_UN = {"Relu": {}, "Relu6": {"scale": 5.0}, "Elu": {}, "Selu": {},
       "Sigmoid": {}, "Tanh": {}, "Softplus": {}, "Softsign": {},
       "Exp": {}, "Log": {"pos": True}, "Log1p": {"pos": True}, "Neg": {},
       "Abs": {}, "Sqrt": {"pos": True}, "Rsqrt": {"pos": True},
       "Square": {}, "Sign": {}, "Floor": {"scale": 3.0},
       "Ceil": {"scale": 3.0}, "Round": {"scale": 3.0}, "Erf": {},
       "Sin": {}, "Cos": {}, "Reciprocal": {"pos": True},
       "ZerosLike": {}, "OnesLike": {}, "Tan": {"scale": 0.5}, "Atan": {}}
_FEATURES = {"Relu", "Relu6", "Elu", "Selu", "Softplus", "Softsign"}
for _op, _kw in _UN.items():
    def _b(r, _op=_op, _kw=_kw):
        if _kw.get("pos"):
            c, x = _f(r, 3, 5, lo=0.5, hi=2.0), _f(r, 3, 5, lo=0.5, hi=2.0)
        else:
            s = _kw.get("scale", 1.0)
            c, x = _f(r, 3, 5) * s, _f(r, 3, 5, lo=0.5, hi=1.5)
        arg = "features" if _op in _FEATURES else "x"
        return (lambda x: getattr(raw, _op)(**{arg: x * tf.constant(c)}),
                [x])
    case(f"unary_{_op}", [_op])(_b)


@case("leaky_relu", ["LeakyRelu"])
def _(r):
    c = _f(r, 3, 5)
    return (lambda x: raw.LeakyRelu(features=x * tf.constant(c), alpha=0.3),
            [_f(r, 3, 5)])


@case("add_n", ["AddN"])
def _(r):
    a, b = _f(r, 2, 3), _f(r, 2, 3)
    return (lambda x: raw.AddN(inputs=[x, tf.constant(a), tf.constant(b)]),
            [_f(r, 2, 3)])


for _ta, _tb in ((False, False), (True, False), (False, True)):
    def _b(r, _ta=_ta, _tb=_tb):
        w = _f(r, *((5, 4) if not _tb else (4, 5)))
        x = _f(r, *((3, 5) if not _ta else (5, 3)))
        return (lambda x: raw.MatMul(a=x, b=tf.constant(w), transpose_a=_ta,
                                     transpose_b=_tb), [x])
    case(f"matmul_ta{int(_ta)}_tb{int(_tb)}", ["MatMul"])(_b)


@case("batch_matmul_adj_x", ["BatchMatMul"])
def _(r):
    w = _f(r, 2, 3, 4)
    return (lambda x: raw.BatchMatMul(x=x, y=tf.constant(w), adj_x=True),
            [_f(r, 2, 3, 5)])


@case("batch_matmul_v2_broadcast_adj_y", ["BatchMatMulV2"])
def _(r):
    w = _f(r, 6, 5)
    return (lambda x: raw.BatchMatMulV2(x=x, y=tf.constant(w), adj_y=True),
            [_f(r, 2, 3, 5)])


for _fmt in ("NHWC", "NCHW"):
    def _b(r, _fmt=_fmt):
        b = _f(r, 3)
        shape = (2, 4, 4, 3) if _fmt == "NHWC" else (2, 3, 4, 4)
        return (lambda x: raw.BiasAdd(value=x, bias=tf.constant(b),
                                      data_format=_fmt), [_f(r, *shape)])
    case(f"bias_add_{_fmt}", ["BiasAdd"])(_b)

for _op in ("Softmax", "LogSoftmax"):
    def _b(r, _op=_op):
        c = _f(r, 3, 6)
        return (lambda x: getattr(raw, _op)(logits=x * tf.constant(c)),
                [_f(r, 3, 6)])
    case(f"{_op}", [_op])(_b)


@case("select", ["Select", "Greater"])
def _(r):
    a, b = _f(r, 3, 4), _f(r, 3, 4)
    return (lambda x: raw.Select(condition=x > 0, x=tf.constant(a) * x,
                                 y=tf.constant(b)), [_f(r, 3, 4)])


@case("select_v2_broadcast", ["SelectV2", "Less"])
def _(r):
    a, b = _f(r, 3, 4), _f(r, 4)
    return (lambda x: raw.SelectV2(condition=x < 0, t=tf.constant(a),
                                   e=tf.constant(b) * 2.0), [_f(r, 1, 4)])


@case("sparse_softmax_xent", ["SparseSoftmaxCrossEntropyWithLogits"])
def _(r):
    labels = r.integers(0, 5, (4,)).astype(np.int32)
    c = _f(r, 4, 5)
    return (lambda x: tuple(raw.SparseSoftmaxCrossEntropyWithLogits(
        features=x * tf.constant(c), labels=tf.constant(labels))),
        [_f(r, 4, 5)])


@case("softmax_xent", ["SoftmaxCrossEntropyWithLogits"])
def _(r):
    lab = np.eye(5, dtype=np.float32)[r.integers(0, 5, 4)]
    c = _f(r, 4, 5)
    return (lambda x: tuple(raw.SoftmaxCrossEntropyWithLogits(
        features=x * tf.constant(c), labels=tf.constant(lab))),
        [_f(r, 4, 5)])


_CAST = {"float": (tf.float32, 1), "double": (tf.float64, 1),
         "int32": (tf.int32, 50), "uint8": (tf.uint8, 100),
         "int8": (tf.int8, 40), "int64": (tf.int64, 50),
         "bool": (tf.bool, 1), "bfloat16": (tf.bfloat16, 1),
         "half": (tf.float16, 1)}
for _name, (_dt, _scale) in _CAST.items():
    def _b(r, _dt=_dt, _scale=_scale):
        c = _f(r, 3, 4)
        x = _f(r, 3, 4) * _scale
        if _dt == tf.uint8:
            x = np.abs(x)
        if _dt == tf.bool:
            x = np.where(np.abs(x) < 0.5, 0.0, x).astype(np.float32)
        return (lambda x: raw.Cast(x=x * tf.constant(c) if _scale == 1
                                   else x, DstT=_dt), [x])
    case(f"cast_to_{_name}", ["Cast"])(_b)

_REDUCE = {"Mean": ([1], False), "Sum": ([0, -1], True),
           "Max": ([-1], False), "Min": ([0], True), "Prod": ([1, 2], False)}
for _op, (_axes, _keep) in _REDUCE.items():
    def _b(r, _op=_op, _axes=_axes, _keep=_keep):
        c = _f(r, 2, 3, 4, lo=0.5, hi=1.5) if _op == "Prod" \
            else _f(r, 2, 3, 4)
        return (lambda x: getattr(raw, _op)(
            input=x * tf.constant(c), axis=tf.constant(_axes, tf.int32),
            keep_dims=_keep), [_f(r, 2, 3, 4, lo=0.5, hi=1.5)])
    case(f"reduce_{_op}", [_op])(_b)

for _op in ("All", "Any"):
    def _b(r, _op=_op):
        return (lambda x: getattr(raw, _op)(
            input=x > -0.5, axis=tf.constant([1], tf.int32),
            keep_dims=False), [_f(r, 3, 4)])
    case(f"reduce_{_op}", [_op, "Greater"])(_b)

for _op in ("ArgMax", "ArgMin"):
    def _b(r, _op=_op):
        c = _f(r, 3, 6)
        return (lambda x: getattr(raw, _op)(
            input=x * tf.constant(c), dimension=tf.constant(1, tf.int32)),
            [_f(r, 3, 6)])
    case(f"{_op}", [_op])(_b)

_CONV = {
    "same_s2": dict(strides=[1, 2, 2, 1], padding="SAME"),
    "valid_dil2": dict(strides=[1, 1, 1, 1], padding="VALID",
                       dilations=[1, 2, 2, 1]),
    "explicit": dict(strides=[1, 2, 1, 1], padding="EXPLICIT",
                     explicit_paddings=[0, 0, 1, 2, 0, 1, 0, 0]),
    "nchw_explicit": dict(strides=[1, 1, 2, 2], padding="EXPLICIT",
                          explicit_paddings=[0, 0, 0, 0, 2, 1, 1, 0],
                          data_format="NCHW"),
}
for _cid, _kw in _CONV.items():
    def _b(r, _kw=_kw):
        w = _f(r, 3, 3, 3, 4) * 0.5
        shape = (2, 3, 9, 8) if _kw.get("data_format") == "NCHW" \
            else (2, 9, 8, 3)
        return (lambda x: raw.Conv2D(input=x, filter=tf.constant(w), **_kw),
                [_f(r, *shape)])
    case(f"conv2d_{_cid}", ["Conv2D"])(_b)

for _cid, _kw in {"same_s2": dict(strides=[1, 2, 2, 1], padding="SAME"),
                  "valid": dict(strides=[1, 1, 1, 1], padding="VALID"),
                  "explicit": dict(strides=[1, 1, 1, 1], padding="EXPLICIT",
                                   explicit_paddings=[0, 0, 2, 0, 1, 1, 0,
                                                      0])}.items():
    def _b(r, _kw=_kw):
        w = _f(r, 3, 3, 4, 1)
        return (lambda x: raw.DepthwiseConv2dNative(
            input=x, filter=tf.constant(w), **_kw), [_f(r, 2, 7, 9, 4)])
    case(f"depthwise_{_cid}", ["DepthwiseConv2dNative"])(_b)

for _op in ("MaxPool", "AvgPool"):
    for _cid, _kw in {"same_s2": dict(ksize=[1, 3, 3, 1],
                                      strides=[1, 2, 2, 1], padding="SAME"),
                      "valid": dict(ksize=[1, 2, 3, 1],
                                    strides=[1, 2, 1, 1], padding="VALID"),
                      "nchw_same": dict(ksize=[1, 1, 2, 2],
                                        strides=[1, 1, 2, 2],
                                        padding="SAME",
                                        data_format="NCHW")}.items():
        def _b(r, _op=_op, _kw=_kw):
            c = _f(r, 1)
            shape = (2, 3, 7, 9) if _kw.get("data_format") == "NCHW" \
                else (2, 7, 9, 3)
            arg = "input" if _op == "MaxPool" else "value"
            return (lambda x: getattr(raw, _op)(
                **{arg: x * tf.constant(c)}, **_kw), [_f(r, *shape)])
        case(f"{_op}_{_cid}", [_op])(_b)

for _op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
    for _fmt in ("NHWC", "NCHW"):
        def _b(r, _op=_op, _fmt=_fmt):
            scale, off, mean = _f(r, 3), _f(r, 3), _f(r, 3)
            var = _f(r, 3, lo=0.5, hi=2.0)
            shape = (2, 4, 5, 3) if _fmt == "NHWC" else (2, 3, 4, 5)
            return (lambda x: getattr(raw, _op)(
                x=x, scale=tf.constant(scale), offset=tf.constant(off),
                mean=tf.constant(mean), variance=tf.constant(var),
                epsilon=1e-3, data_format=_fmt, is_training=False)[0],
                [_f(r, *shape)])
        case(f"{_op}_{_fmt}", [_op])(_b)


@case("shape_rank_size", ["Shape", "Rank", "Size"], dyn=True)
def _(r):
    return (lambda x: (raw.Shape(input=x), raw.Rank(input=x),
                       raw.Size(input=x)), [_f(r, 3, 4, 5)])


@case("dynamic_reshape", ["Reshape", "Shape", "StridedSlice", "Pack"],
      dyn=True)
def _(r):
    c = _f(r, 4, 5)
    return (lambda x: tf.reshape(x * tf.constant(c),
                                 tf.stack([tf.shape(x)[0], -1])),
            [_f(r, 3, 4, 5)])


@case("squeeze_expand_dims", ["Squeeze", "ExpandDims"])
def _(r):
    c = _f(r, 3, 1, 4)
    return (lambda x: raw.ExpandDims(input=raw.Squeeze(
        input=x * tf.constant(c), axis=[1]), axis=-1), [_f(r, 3, 1, 4)])


@case("concat_v2", ["ConcatV2"])
def _(r):
    c = _f(r, 2, 3)
    return (lambda x: raw.ConcatV2(values=[x, tf.constant(c), x * 2.0],
                                   axis=-1), [_f(r, 2, 4)])


@case("pack_unpack", ["Pack", "Unpack"])
def _(r):
    c = _f(r, 2, 3)
    return (lambda x: tuple(raw.Unpack(value=raw.Pack(
        values=[x, tf.constant(c)], axis=1), num=2, axis=1)),
        [_f(r, 2, 3)])


@case("split", ["Split"])
def _(r):
    c = _f(r, 4, 6)
    return (lambda x: tuple(raw.Split(axis=1, value=x * tf.constant(c),
                                      num_split=3)), [_f(r, 4, 6)])


@case("split_v", ["SplitV"])
def _(r):
    c = _f(r, 4, 6)
    return (lambda x: tuple(raw.SplitV(value=x * tf.constant(c),
                                       size_splits=[1, 2, 3], axis=-1,
                                       num_split=3)), [_f(r, 4, 6)])


@case("transpose", ["Transpose"])
def _(r):
    c = _f(r, 2, 3, 4)
    return (lambda x: raw.Transpose(x=x * tf.constant(c), perm=[2, 0, 1]),
            [_f(r, 2, 3, 4)])


@case("pad", ["Pad"])
def _(r):
    c = _f(r, 3, 4)
    return (lambda x: raw.Pad(input=x * tf.constant(c),
                              paddings=[[1, 0], [2, 3]]), [_f(r, 3, 4)])


@case("pad_v2", ["PadV2"])
def _(r):
    c = _f(r, 3, 4)
    return (lambda x: raw.PadV2(input=x * tf.constant(c),
                                paddings=[[0, 2], [1, 1]],
                                constant_values=0.5), [_f(r, 3, 4)])


for _mode in ("REFLECT", "SYMMETRIC"):
    def _b(r, _mode=_mode):
        c = _f(r, 3, 4)
        return (lambda x: raw.MirrorPad(input=x * tf.constant(c),
                                        paddings=[[1, 2], [2, 1]],
                                        mode=_mode), [_f(r, 3, 4)])
    case(f"mirror_pad_{_mode}", ["MirrorPad"])(_b)

_SS = {
    "masks": dict(begin=[1, 0], end=[0, 3], strides=[1, 1], begin_mask=2,
                  end_mask=1),
    "negative_strides": dict(begin=[-1, 4], end=[0, 0], strides=[-1, -2],
                             end_mask=1),
    "negative_to_start": dict(begin=[3, 0], end=[0, 5], strides=[-2, 2],
                              end_mask=1),
    "shrink": dict(begin=[1, -2], end=[2, -1], strides=[1, 1],
                   shrink_axis_mask=1),
}
for _cid, _kw in _SS.items():
    def _b(r, _kw=_kw):
        c = _f(r, 5, 6)
        kw = dict(_kw)
        b, e, s = kw.pop("begin"), kw.pop("end"), kw.pop("strides")
        return (lambda x: raw.StridedSlice(
            input=x * tf.constant(c), begin=tf.constant(b, tf.int32),
            end=tf.constant(e, tf.int32), strides=tf.constant(s, tf.int32),
            **kw), [_f(r, 5, 6)])
    case(f"strided_slice_{_cid}", ["StridedSlice"])(_b)


@case("slice", ["Slice"])
def _(r):
    c = _f(r, 4, 5)
    return (lambda x: raw.Slice(input=x * tf.constant(c), begin=[1, 2],
                                size=[2, -1]), [_f(r, 4, 5)])


@case("gather_v2", ["GatherV2"])
def _(r):
    c = _f(r, 3, 5)
    idx = np.asarray([[4, 0], [2, 2]], np.int32)
    return (lambda x: raw.GatherV2(params=x * tf.constant(c),
                                   indices=tf.constant(idx), axis=1),
            [_f(r, 3, 5)])


@case("gather", ["Gather"])
def _(r):
    c = _f(r, 4, 3)
    return (lambda x, i: raw.Gather(params=x * tf.constant(c), indices=i),
            [_f(r, 4, 3), np.asarray([3, 1, 1], np.int32)])


@case("tile_fill_range_broadcast",
      ["Tile", "Fill", "Range", "BroadcastTo", "Shape"], dyn=True)
def _(r):
    c, v = _f(r, 2, 3), _f(r)
    return (lambda x: (raw.Tile(input=x * tf.constant(c), multiples=[2, 1]),
                       raw.Fill(dims=tf.shape(x), value=tf.constant(v)) * x,
                       raw.Range(start=1, limit=9, delta=3),
                       raw.BroadcastTo(input=tf.constant(c[0]) * x[:1],
                                       shape=[4, 3])),
            [_f(r, 2, 3)])


@case("read_variable_capture", ["ReadVariableOp"])
def _(r):
    v = tf.Variable(_f(r, 3, 4))
    return (lambda x: x * v, [_f(r, 3, 4)])


@case("placeholder_with_default", ["Mul"])
def _(r):
    c = _f(r, 2, 3)
    return (lambda x: x * raw.PlaceholderWithDefault(
        input=tf.constant(c), shape=[2, 3]), [_f(r, 2, 3)])


# -- harness ------------------------------------------------------------------

_TRACED = {}


def traced(cid):
    """(serialized GraphDef, input names, output names, captures, inputs)
    of a case, traced once."""
    if cid not in _TRACED:
        _, _, make, dyn = next(c for c in CASES if c[0] == cid)
        fn, xs = make(_r(zlib.crc32(cid.encode())))
        specs = [tf.TensorSpec((None,) + x.shape[1:] if dyn else x.shape,
                               tf.as_dtype(x.dtype)) for x in xs]
        concrete = tf.function(fn, autograph=False).get_concrete_function(
            *specs)
        captures = {internal.op.name: ext.numpy() if ext.dtype != tf.resource
                    else _var_value(fn, ext)
                    for ext, internal in concrete.graph.captures}
        cap = set(captures)
        _TRACED[cid] = (concrete.graph.as_graph_def().SerializeToString(),
                        [t.op.name for t in concrete.inputs
                         if t.op.name not in cap],
                        [t.name for t in concrete.outputs], captures, xs)
    return _TRACED[cid]


def _var_value(fn, handle):
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if isinstance(v, tf.Variable) and v.handle is handle:
            return v.numpy()
    raise AssertionError("no variable for a resource capture")


def _both(cid):
    raw_graph, ins, outs, captures, xs = traced(cid)
    jfn = JGraph(tf.compat.v1.GraphDef.FromString(raw_graph), ins, outs,
                 captures=captures or None)
    tfn = TFGraphFunction(raw_graph, ins, outs, captures=captures or None)
    return jfn, tfn, xs


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype in (torch.bfloat16, torch.float16)
                else v).numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        str(a.dtype) == "bfloat16" else a


def _is_float(a):
    return np.asarray(a).dtype.kind == "f"


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_registry_op_matches_jax(cid):
    jfn, tfn, xs = _both(cid)
    _, names, _, _ = next(c for c in CASES if c[0] == cid)
    graph_ops = set(tfn.ops)
    assert set(names) <= graph_ops | {"Mul"}, (names, graph_ops)
    jparams = {k: jnp.asarray(v) for k, v in jfn.init_params().items()}
    tparams = {k: v.clone().requires_grad_(v.is_floating_point())
               for k, v in tfn.init_params().items()}
    assert sorted(jparams) == sorted(tparams)
    tx = [torch.from_numpy(x.copy()).requires_grad_(x.dtype.kind == "f")
          for x in xs]
    jouts = jfn(jparams, *[jnp.asarray(x) for x in xs])
    touts = tfn(tparams, *tx)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j, tn = _np(j), _np(t)
        assert j.shape == tn.shape, (j.shape, tn.shape)
        if _is_float(j):
            np.testing.assert_allclose(tn, j, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(tn, j)
    # gradients of a seeded cotangent over the float outputs
    rs = _r(7)
    cots = [rs.standard_normal(np.shape(_np(j))).astype(np.float32)
            if _is_float(_np(j)) and isinstance(t, torch.Tensor) and
            t.requires_grad else None for j, t in zip(jouts, touts)]
    if not any(c is not None for c in cots):
        return
    fx = [i for i, x in enumerate(xs) if x.dtype.kind == "f"]
    # JAX reads PadV2's constant value with float(), which a JAX tracer
    # refuses: that Const is held out of both packages' gradients
    diff = [k for k in sorted(tparams) if tparams[k].requires_grad and
            "constant_values" not in k]

    def jloss(p, fxs):
        args = [jnp.asarray(x) for x in xs]
        for i, v in zip(fx, fxs):
            args[i] = v
        outs = jfn(dict(jparams, **p), *args)
        return sum(jnp.sum(jnp.asarray(o, jnp.float32) * c)
                   for o, c in zip(outs, cots) if c is not None)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jparams[k] for k in diff}, [jnp.asarray(xs[i]) for i in fx])
    tloss = sum((o.float() * torch.from_numpy(c)).sum()
                for o, c in zip(touts, cots) if c is not None)
    wrt = [tparams[k] for k in diff] + [tx[i] for i in fx]
    grads = torch.autograd.grad(tloss, wrt, allow_unused=True)
    want = [np.asarray(jgp[k]) for k in diff] + [np.asarray(g) for g in jgx]
    for g, w in zip(grads, want):
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_every_registry_name_has_a_case():
    covered = {n for c in CASES for n in c[1]}
    assert set(TF_REGISTRY) == set(J_REGISTRY)
    assert len(TF_REGISTRY) == 110
    assert set(TF_REGISTRY) <= covered, sorted(set(TF_REGISTRY) - covered)


def test_output_indexing_by_name_k():
    """``name:k`` output names pick a node's k-th output."""
    raw_graph, ins, _, _, xs = traced("split")
    split = next(n["name"] for n in gd.parse_graph_def(raw_graph)["node"]
                 if n["op"] == "Split")
    outs = [f"{split}:2", f"{split}:0", split]
    jfn = JGraph(tf.compat.v1.GraphDef.FromString(raw_graph), ins, outs)
    tfn = TFGraphFunction(raw_graph, ins, outs)
    jo = jfn(jfn.init_params(), *xs)
    to = tfn(tfn.init_params(), *[torch.from_numpy(x) for x in xs])
    for j, t in zip(jo, to):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(to[1]), _np(to[2]))


def test_depthwise_multiplier_two_matches_tensorflow():
    r = _r(3)
    w, x = _f(r, 3, 3, 4, 2), _f(r, 2, 7, 9, 4)
    fn = tf.function(lambda x: raw.DepthwiseConv2dNative(
        input=x, filter=tf.constant(w), strides=[1, 2, 2, 1],
        padding="SAME"), autograph=False)
    concrete = fn.get_concrete_function(tf.TensorSpec(x.shape, tf.float32))
    tfn = TFGraphFunction(concrete.graph.as_graph_def(),
                          [t.op.name for t in concrete.inputs],
                          [t.name for t in concrete.outputs])
    (got,) = tfn(tfn.init_params(), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), fn(x).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", ["Einsum", "Erfc"])
def test_op_outside_the_registry_raises_in_both(op):
    fn = {"Einsum": lambda x: tf.einsum("ij,jk->ik", x, x),
          "Erfc": lambda x: tf.math.erfc(x)}[op]
    concrete = tf.function(fn, autograph=False).get_concrete_function(
        tf.TensorSpec((3, 3), tf.float32))
    graph = concrete.graph.as_graph_def()
    names = ([t.op.name for t in concrete.inputs],
             [t.name for t in concrete.outputs])
    from analytics_zoo_tpu.pipeline.api.net.tf_graph import \
        UnsupportedTFGraph as JUnsupported
    with pytest.raises(JUnsupported, match=op):
        JGraph(graph, *names)
    with pytest.raises(UnsupportedTFGraph, match=op):
        TFGraphFunction(graph.SerializeToString(), *names)


def test_reader_decodes_what_tensorflow_parses():
    """The port's reader and TensorFlow's parser agree on every node's
    name, op, inputs and attribute values of a traced graph, and the
    port's encoder writes bytes TensorFlow parses back to the same
    graph."""
    raw_graph = traced("conv2d_explicit")[0]
    mine = gd.parse_graph_def(raw_graph)
    theirs = tf.compat.v1.GraphDef.FromString(raw_graph)
    assert [n["name"] for n in mine["node"]] == [n.name for n in theirs.node]
    from tensorflow.python.framework import tensor_util
    for m, t in zip(mine["node"], theirs.node):
        assert m["op"] == t.op and m["input"] == list(t.input)
        attrs = gd.node_attrs(m)
        for key, av in t.attr.items():
            kind = av.WhichOneof("value")
            if kind == "tensor":
                np.testing.assert_array_equal(
                    attrs[key], tensor_util.MakeNdarray(av.tensor))
            elif kind == "list" and list(av.list.i):
                assert attrs[key] == list(av.list.i)
            elif kind in ("i", "f", "b", "type"):
                assert attrs[key] == getattr(av, kind)
            elif kind == "s":
                assert attrs[key] == av.s.decode()
    back = tf.compat.v1.GraphDef.FromString(gd.encode(mine, "GraphDef"))
    assert [n.name for n in back.node] == [n.name for n in theirs.node]


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "int16", "int8", "int64", "bool",
                                   "float16", "bfloat16"])
def test_make_ndarray_matches_tensorflow(dtype):
    """``make_ndarray`` against ``tensor_util.MakeNdarray`` on protos
    TensorFlow writes: raw ``tensor_content``, typed values, and a
    shape filled from fewer values (the last repeated)."""
    from tensorflow.python.framework import tensor_util
    r = _r(11)
    arr = r.standard_normal((3, 4)) * 50
    tfdt = tf.as_dtype(dtype)
    content = tensor_util.make_tensor_proto(
        tf.constant(arr.astype(np.float32), tf.float32) if dtype ==
        "bfloat16" else arr.astype(tfdt.as_numpy_dtype)
        if dtype != "bool" else arr > 0, dtype=tfdt)
    if dtype == "bfloat16":
        content = tensor_util.make_tensor_proto(
            tf.cast(arr.astype(np.float32), tf.bfloat16).numpy())
    filled = tensor_util.make_tensor_proto(
        np.asarray([1, 0][:1 + (dtype == "bool")]).astype(
            tfdt.as_numpy_dtype) if dtype != "bfloat16" else
        tf.constant([1.5], tf.bfloat16).numpy(), shape=[2, 3])
    filled.tensor_content = b""
    for proto in (content, filled):
        got = gd.make_ndarray(gd.decode(proto.SerializeToString(),
                                        "TensorProto"))
        want = tensor_util.MakeNdarray(proto)
        np.testing.assert_array_equal(got, np.asarray(want).astype(
            got.dtype))
