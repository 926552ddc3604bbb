"""The image slice of the port against the JAX package on the CPU: the
convolution, pooling and normalization layers, ``Dropout``, the batch-norm
op, every ``ImageClassifier`` backbone's ``predict`` from copied weights
and moving statistics, and ResNet-50 through ``fit`` step for step.
JAX's weights (and ``net_state``) are copied into the port with
``load_jax_params``; inputs come from numpy seeds.

Tolerances (largest |port - JAX|, over the reference's scale where said):
- layers' forward 1e-5 (float32 products summed in another order by
  XLA's CPU convolution and PyTorch's); ``jax.grad`` against autograd
  for ``Convolution2D`` and ``SeparableConvolution2D`` 1e-4 of the
  gradient's largest element;
- ``batch_norm_train``: forward and backward 1e-5 of the reference's
  largest element in float32, 2e-2 in bf16 (both sides round y and dx to
  bf16 from float32 arithmetic done in another order: a bf16 step is
  2**-8 relative);
- ``BatchNormalization``'s output and moving statistics 1e-5;
- each backbone's ``predict`` (softmax rows) 1e-4;
- ResNet-50 ``fit``, 2 SGD steps at the default lr 0.01 with the
  residual branches' last gammas drawn from U(0.02, 0.05) (see
  ``resnet_start``): each step's loss, every weight and every moving
  statistic within 1e-4 in float32 (measured: losses 1.9e-6, weights
  4.1e-6, statistics 3.6e-7) and 2e-2 in bf16 (measured: 1.57e-2,
  1.25e-2 and 2.4e-3); and each parameter's update (weights after the
  steps less the start) within 5e-3 of the norm of JAX's update in
  float32 (measured 1.1e-3, a BatchNorm gamma; convolution kernels
  1.1e-4) and 0.75 in bf16 (measured 0.57): bf16 rounds far more than
  the rounding the float32 updates are sensitive to, so the bf16 bound
  tells a missing or reversed update (1.0 or more) from a right one and
  no finer; every convolution kernel's update is nonzero;
- ``Dropout``'s keep rate within 3 sigma of 1 - p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.models.image.common import LabelOutput as JLabelOutput
from analytics_zoo_tpu.ops import batchnorm as jbn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.models.image import (ImageConfigure, LabelOutput,
                                                  imagenet_preprocess)
from analytics_zoo_tpu_torch.models.image import imageclassification as tic
from analytics_zoo_tpu_torch.ops import batchnorm as tbn
from analytics_zoo_tpu_torch.ops import quant as tquant
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.utils import load_jax_params

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PREDICT_TOL = 1e-4
FIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FIT_UPDATE_TOL = {"float32": 5e-3, "bfloat16": 0.75}


def _jax_context():
    """One device, as the port trains on one: on the test suite's
    8-device CPU mesh JAX's BatchNorm would take shard-local moments."""
    return jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                          devices=jax.devices()[:1])


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(_jax_context())
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _np_tree(tree):
    """Copies: the JAX trainer donates its buffers to the next step."""
    return jax.tree.map(np.array, tree)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32) -
                        np.asarray(want, np.float32)).max())


# ---------------------------------------------------------------------------
# convolution, pooling and normalization layers, forward
# ---------------------------------------------------------------------------

def _conv_cases():
    cases = {}
    for fmt in ("th", "tf"):
        def shape(c, h, w, fmt=fmt):
            return (None, c, h, w) if fmt == "th" else (None, h, w, c)
        kw = dict(dim_ordering=fmt)
        cases.update({
            f"conv2d_same_{fmt}": (lambda m, kw=kw: m.Convolution2D(
                4, 3, 3, border_mode="same", **kw), shape(3, 7, 7)),
            # stride 2, SAME: (0, 1) pads on the even size, (1, 1) on the
            # odd one
            f"conv2d_same_stride2_{fmt}": (lambda m, kw=kw: m.Convolution2D(
                4, 3, 3, border_mode="same", subsample=(2, 2), **kw),
                shape(3, 8, 9)),
            f"conv2d_same_stride2_k4_{fmt}": (
                lambda m, kw=kw: m.Convolution2D(
                    2, 4, 4, border_mode="same", subsample=(2, 2), **kw),
                shape(3, 9, 8)),
            f"conv2d_valid_bias_relu_{fmt}": (
                lambda m, kw=kw: m.Convolution2D(
                    5, 3, 2, subsample=(2, 1), activation="relu", **kw),
                shape(2, 9, 8)),
            f"atrous2d_same_{fmt}": (lambda m, kw=kw: m.AtrousConvolution2D(
                3, 3, 3, atrous_rate=(2, 2), border_mode="same", **kw),
                shape(2, 9, 8)),
            f"separable2d_same_stride2_{fmt}": (
                lambda m, kw=kw: m.SeparableConvolution2D(
                    5, 3, 3, border_mode="same", subsample=(2, 2),
                    depth_multiplier=2, activation="relu", **kw),
                shape(3, 8, 9)),
            f"separable2d_valid_{fmt}": (
                lambda m, kw=kw: m.SeparableConvolution2D(
                    4, 3, 3, bias=False, **kw), shape(2, 7, 7)),
            f"cropping2d_{fmt}": (lambda m, kw=kw: m.Cropping2D(
                ((1, 0), (2, 1)), **kw), shape(2, 6, 7)),
            f"upsampling2d_{fmt}": (lambda m, kw=kw: m.UpSampling2D(
                (2, 3), **kw), shape(2, 3, 4)),
            f"zeropadding2d_{fmt}": (lambda m, kw=kw: m.ZeroPadding2D(
                ((1, 2), (0, 3)), **kw), shape(2, 3, 4)),
        })
    cases.update({
        "conv1d_same_stride2": (lambda m: m.Convolution1D(
            4, 3, border_mode="same", subsample_length=2), (None, 10, 3)),
        "conv1d_valid_tanh": (lambda m: m.Convolution1D(
            4, 2, activation="tanh"), (None, 9, 3)),
        "atrous1d_same": (lambda m: m.AtrousConvolution1D(
            3, 3, atrous_rate=2, border_mode="same"), (None, 9, 2)),
        "cropping1d": (lambda m: m.Cropping1D((2, 1)), (None, 7, 3)),
        "upsampling1d": (lambda m: m.UpSampling1D(3), (None, 4, 3)),
        "zeropadding1d": (lambda m: m.ZeroPadding1D(2), (None, 4, 3)),
    })
    return cases


def _pool_cases():
    cases = {}
    for mode in ("Max", "Average"):
        for border in ("same", "valid"):
            for fmt in ("th", "tf"):
                cases[f"{mode}Pooling2D_{border}_{fmt}"] = (
                    lambda m, mode=mode, border=border, fmt=fmt: getattr(
                        m, f"{mode}Pooling2D")((3, 3), strides=(2, 2),
                                               border_mode=border,
                                               dim_ordering=fmt),
                    (None, 3, 8, 9) if fmt == "th" else (None, 8, 9, 3))
                cases[f"{mode}Pooling3D_{border}_{fmt}"] = (
                    lambda m, mode=mode, border=border, fmt=fmt: getattr(
                        m, f"{mode}Pooling3D")((2, 3, 2), strides=(2, 2, 1),
                                               border_mode=border,
                                               dim_ordering=fmt),
                    (None, 2, 5, 6, 3) if fmt == "th" else (None, 5, 6, 3, 2))
            cases[f"{mode}Pooling1D_{border}"] = (
                lambda m, mode=mode, border=border: getattr(
                    m, f"{mode}Pooling1D")(3, stride=2, border_mode=border),
                (None, 8, 3))
        for rank, shape in ((1, (None, 5, 3)), (2, (None, 3, 4, 5)),
                            (3, (None, 2, 3, 4, 5))):
            cases[f"Global{mode}Pooling{rank}D"] = (
                lambda m, mode=mode, rank=rank: getattr(
                    m, f"Global{mode}Pooling{rank}D")(), shape)
    cases["GlobalAveragePooling2D_tf"] = (
        lambda m: m.GlobalAveragePooling2D(dim_ordering="tf"),
        (None, 4, 5, 3))
    return cases


NORM_CASES = {
    "layernorm": (lambda m: m.LayerNorm(), (None, 3, 6)),
    "lrn2d_th": (lambda m: m.LRN2D(alpha=1e-2, n=3), (None, 6, 4, 4)),
    "lrn2d_tf": (lambda m: m.LRN2D(alpha=1e-2, n=5, dim_ordering="tf"),
                 (None, 4, 4, 7)),
    "within_channel_lrn2d": (lambda m: m.WithinChannelLRN2D(size=3),
                             (None, 2, 5, 6)),
    "dropout_not_training": (lambda m: m.Dropout(0.4), (None, 3, 6)),
}

LAYER_CASES = {**_conv_cases(), **_pool_cases(), **NORM_CASES}


def _pair(case, seed=0):
    """The case's layer in both packages, the port holding JAX's weights;
    JAX's params; a seeded input."""
    make, in_shape = LAYER_CASES[case]
    jlayer, tlayer = make(jl), make(tl)
    jparams = _np_tree(jlayer.build(jax.random.PRNGKey(seed), in_shape))
    tlayer.build_params(torch.Generator().manual_seed(0), in_shape)
    if jparams:
        load_jax_params(tlayer, {tlayer.name: jparams})
    rs = np.random.default_rng(sorted(LAYER_CASES).index(case))
    x = rs.standard_normal((2,) + tuple(in_shape[1:])).astype(np.float32)
    return jlayer, tlayer, jparams, x


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_forward_matches_jax(case):
    jlayer, tlayer, jparams, x = _pair(case)
    want = np.asarray(jlayer.call(jparams, jnp.asarray(x)))
    got = tlayer(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == tuple(
        d if d is not None else 2
        for d in tlayer.compute_output_shape((None,) + x.shape[1:]))
    assert _err(got, want) <= FWD_TOL


GRAD_CASES = ["conv2d_same_stride2_th", "conv2d_same_stride2_tf",
              "conv2d_valid_bias_relu_th", "atrous2d_same_tf",
              "separable2d_same_stride2_th", "separable2d_same_stride2_tf"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_conv_gradients_match_jax(case):
    jlayer, tlayer, jparams, x = _pair(case, seed=1)
    out_shape = (2,) + tuple(tlayer.compute_output_shape(
        (None,) + x.shape[1:])[1:])
    cot = np.random.default_rng(5).standard_normal(out_shape).astype(
        np.float32)

    def jloss(params, xin):
        return jnp.sum(jlayer.call(params, xin) * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tlayer(xt) * torch.from_numpy(cot)).sum().backward()
    for name, p in tlayer.named_parameters():
        want = np.asarray(jgp[name])
        assert _err(p.grad.numpy(), want) <= GRAD_TOL * np.abs(want).max()
    want = np.asarray(jgx)
    assert _err(xt.grad.numpy(), want) <= GRAD_TOL * np.abs(want).max()


def test_quantized_kernels_wait_for_quantized_model():
    """The convolution op takes a quantized kernel since QuantizedModel
    arrived (ROADMAP A10): a weight-only one convolves with its
    dequantized kernel (``tests/test_torch_quant.py`` holds every tier
    against JAX)."""
    rs = np.random.default_rng(3)
    x = torch.from_numpy(rs.standard_normal((1, 2, 5, 5)).astype(np.float32))
    w = rs.standard_normal((3, 3, 2, 4)).astype(np.float32)
    qt = tquant.quantize_weight(w, name="['c']['kernel']")
    dn = ("NCHW", "HWIO", "NCHW")
    got = tquant.conv2d(x, qt, (1, 1), "SAME", None, dn)
    want = tquant.conv2d(x, qt.dequantize(), (1, 1), "SAME", None, dn)
    assert torch.equal(got, want)
    assert qt.q.dtype == torch.int8 and tuple(qt.scale.shape) == (1, 1, 1, 4)


# ---------------------------------------------------------------------------
# batch norm: the op, the layer, Dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,shape", [(1, (4, 6, 5, 3)),
                                        (-1, (4, 5, 3, 6)), (-1, (16, 6))])
@pytest.mark.parametrize("moment_cotangents", [False, True])
def test_batch_norm_train_forward_and_backward_match_jax(
        dtype, axis, shape, moment_cotangents):
    rs = np.random.default_rng(len(shape) + axis)
    c = shape[axis]
    x = (2.0 * rs.standard_normal(shape) + 0.5).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rs.standard_normal(c).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    dmean, dvar = (rs.standard_normal(c).astype(np.float32)
                   for _ in range(2))
    if not moment_cotangents:
        dmean, dvar = np.zeros_like(dmean), np.zeros_like(dvar)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jin = [jnp.asarray(a, jdt) for a in (x, gamma, beta)]
    # the JAX op takes the axis counted from the front (its layer
    # normalizes it); the port's takes either
    (jy, jm, jv), vjp = jax.vjp(
        lambda *a: jbn.batch_norm_train(*a, axis % len(shape), 1e-3), *jin)
    jgrads = vjp((jnp.asarray(dy, jdt), jnp.asarray(dmean),
                  jnp.asarray(dvar)))
    tin = [torch.from_numpy(a).to(tdt).requires_grad_(True)
           for a in (x, gamma, beta)]
    ty, tm, tv = tbn.batch_norm_train(*tin, axis, 1e-3)
    assert ty.dtype == tdt and tm.dtype == tv.dtype == torch.float32
    outs, cots = [ty], [torch.from_numpy(dy).to(tdt)]
    if moment_cotangents:
        outs += [tm, tv]
        cots += [torch.from_numpy(dmean), torch.from_numpy(dvar)]
    torch.autograd.backward(outs, cots)
    tol = BN_TOL[dtype]
    for got, want in [(ty, jy), (tm, jm), (tv, jv)] + [
            (t.grad, g) for t, g in zip(tin, jgrads)]:
        want = np.asarray(want.astype(jnp.float32))
        assert _err(got.detach().float().numpy(), want) <= \
            tol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 5)),
                                        (-1, (4, 5, 5, 3)), (-1, (8, 3))])
def test_batch_normalization_moving_statistics_match_jax(axis, shape):
    rs = np.random.default_rng(axis + 7)
    x = (3.0 * rs.standard_normal(shape) - 1.0).astype(np.float32)
    in_shape = (None,) + shape[1:]
    jlayer = jl.BatchNormalization(axis=axis)
    tlayer = tl.BatchNormalization(axis=axis)
    c = shape[axis]
    params = {"gamma": rs.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rs.standard_normal(c).astype(np.float32)}
    state = {"moving_mean": rs.standard_normal(c).astype(np.float32),
             "moving_var": rs.uniform(0.5, 2.0, c).astype(np.float32)}
    tlayer.build_params(None, in_shape)
    assert {k: v.dtype for k, v in tlayer.state_tree().items()} == {
        "moving_mean": torch.float32, "moving_var": torch.float32}
    load_jax_params(tlayer, {tlayer.name: params},
                    state={tlayer.name: state})
    jy, jstate = jlayer.call(params, jnp.asarray(x), training=True,
                             state=state)
    ty = tlayer(torch.from_numpy(x), training=True)
    assert _err(ty.detach().numpy(), jy) <= FWD_TOL
    for k, v in tlayer.state_tree().items():
        assert _err(v.numpy(), jstate[k]) <= FWD_TOL, k
        assert _err(v.numpy(), state[k]) > 1e-3, f"{k} did not move"
    # inference normalizes with the moving statistics and leaves them be
    x2 = rs.standard_normal(shape).astype(np.float32)
    jy2, _ = jlayer.call(params, jnp.asarray(x2), training=False,
                         state=jstate)
    before = {k: v.clone() for k, v in tlayer.state_tree().items()}
    ty2 = tlayer(torch.from_numpy(x2))
    assert _err(ty2.detach().numpy(), jy2) <= FWD_TOL
    assert all(torch.equal(before[k], v)
               for k, v in tlayer.state_tree().items())


def test_load_jax_state_refuses_a_missing_extra_or_misshaped_leaf():
    layer = tl.BatchNormalization()
    layer.build_params(None, (None, 3, 4, 4))
    params = {layer.name: {"gamma": np.ones(3, np.float32),
                           "beta": np.zeros(3, np.float32)}}
    good = {"moving_mean": np.zeros(3, np.float32),
            "moving_var": np.ones(3, np.float32)}
    for bad, match in (({"moving_mean": good["moving_mean"]}, "missing"),
                       (dict(good, extra=np.ones(3)), "extra"),
                       (dict(good, moving_var=np.ones(4)), "shape")):
        with pytest.raises(ValueError, match=match):
            load_jax_params(layer, params, state={layer.name: bad})


def test_dropout_keeps_one_minus_p_and_scales_while_training():
    p, n = 0.3, 200_000
    layer = tl.Dropout(p)
    x = torch.ones(n)
    gen = torch.Generator().manual_seed(3)
    y = layer(x, training=True, generator=gen)
    kept = (y != 0)
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept.float().mean().item() - (1 - p)) <= 3 * sigma
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    # another step's generator draws another mask; no generator, no drop
    y2 = layer(x, training=True, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(y, y2)
    assert torch.equal(layer(x, training=True), x)
    assert torch.equal(tl.Dropout(0.0)(x, training=True, generator=gen), x)


# ---------------------------------------------------------------------------
# the backbones: predict from copied weights and moving statistics
# ---------------------------------------------------------------------------

def _random_state(jstate, seed):
    """A seeded stand-in for trained moving statistics."""
    rs = np.random.default_rng(seed)
    return {name: {"moving_mean": rs.normal(0, 0.2, s["moving_mean"].shape)
                   .astype(np.float32),
                   "moving_var": rs.uniform(0.5, 1.5, s["moving_var"].shape)
                   .astype(np.float32)}
            for name, s in jstate.items()}


BACKBONES = {   # case -> (model_name, input_shape, data_format)
    "lenet": ("lenet", (1, 28, 28), "th"),
    "vgg-16": ("vgg-16", (3, 32, 32), "th"),
    "squeezenet": ("squeezenet", (3, 64, 64), "th"),
    "mobilenet": ("mobilenet", (3, 64, 64), "th"),
    "resnet-50": ("resnet-50", (3, 64, 64), "th"),
    "resnet-50-tf": ("resnet-50", (3, 64, 64), "tf"),
}


def _backbone_pair(case, class_num=7):
    """The classifier in both packages with the same weights and seeded
    moving statistics. The port draws the weights (JAX's eager init of
    these graphs takes up to 10 s on the CPU) and loads the JAX trees
    back through ``load_jax_params``."""
    name, shape, fmt = BACKBONES[case]
    jclf = jic.ImageClassifier(class_num=class_num, model_name=name,
                               input_shape=shape, data_format=fmt)
    tclf = tic.ImageClassifier(class_num=class_num, model_name=name,
                               input_shape=shape, data_format=fmt)
    params, state = _jax_trees(jclf.model, tclf.model, 1)
    load_jax_params(tclf.model, params, state=state)
    return jclf, tclf, params, state


@pytest.mark.parametrize("case", sorted(BACKBONES))
def test_backbone_predict_from_copied_weights_and_state_matches_jax(case):
    jclf, tclf, params, state = _backbone_pair(case)
    shape = tclf.model.graph_function().inputs[0].shape[1:]
    x = np.random.default_rng(2).standard_normal((3,) + shape).astype(
        np.float32)
    graph = jclf.model.graph_function()
    want = np.asarray(jax.jit(lambda p, s, xin: graph.apply(
        p, [xin], state=s, training=False))(params, state, x))
    before = {n: b.clone() for n, b in tclf.model.named_buffers()}
    got = tclf.predict(x, batch_size=2)
    assert got.shape == want.shape == (3, 7)
    assert _err(got, want) <= PREDICT_TOL
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    # predict read the moving statistics and left them as they were
    assert all(torch.equal(before[n], b)
               for n, b in tclf.model.named_buffers())


def test_image_classifier_surface():
    assert set(tic.backbones) == set(jic.backbones) == {
        "lenet", "vgg-16", "mobilenet", "resnet-50", "squeezenet"}
    with pytest.raises(ValueError, match="unknown model"):
        tic.ImageClassifier(model_name="alexnet")
    with pytest.raises(ValueError, match="only supported for resnet-50"):
        tic.ImageClassifier(model_name="lenet", data_format="tf")
    clf = tic.ImageClassifier(class_num=3, model_name="lenet",
                              label_map={0: "cat", 1: "dog", 2: "frog"})
    assert isinstance(clf.config, ImageConfigure) and \
        clf.config.pre_processor is None
    feature = clf.config.post_processor({}, np.array([0.2, 0.7, 0.1]))
    assert feature["clses"] == ["dog", "cat", "frog"]
    np.testing.assert_allclose(feature["probs"], [0.7, 0.2, 0.1])
    want = {}
    jic_out = JLabelOutput({0: "cat", 1: "dog", 2: "frog"}, top_n=2)
    jic_out(want, np.array([0.2, 0.7, 0.1]))
    got = LabelOutput({0: "cat", 1: "dog", 2: "frog"}, top_n=2)(
        {}, np.array([0.2, 0.7, 0.1]))
    assert got["clses"] == want["clses"]
    # the default chain is the JAX package's, class for class
    from analytics_zoo_tpu.models.image.common import \
        imagenet_preprocess as jimagenet_preprocess
    got = imagenet_preprocess(96)
    want = jimagenet_preprocess(96)
    assert [type(p).__name__ for p in got.transformers] == \
        [type(p).__name__ for p in want.transformers]
    assert (got.transformers[0].h, got.transformers[1].cw) == \
        (want.transformers[0].h, want.transformers[1].cw) == (256, 96)
    sq = tic.ImageClassifier(class_num=3, model_name="squeezenet",
                              input_shape=(3, 96, 96))
    assert sq.config.pre_processor.transformers[1].cw == 96


# ---------------------------------------------------------------------------
# ResNet-50 through fit, step for step
# ---------------------------------------------------------------------------

FIT_SHAPE, FIT_ROWS, FIT_BATCH, FIT_CLASSES = (3, 64, 64), 4, 2, 10


def _jax_trees(jmodel, tmodel, state_seed):
    """``tmodel``'s weights as a JAX params tree under ``jmodel``'s layer
    names (the two graphs' layers paired in order: the same code built
    both), and seeded moving statistics as its ``net_state``."""
    pairs = list(zip(jmodel.graph_function().layers,
                     tmodel.graph_function().layers))
    assert all(type(j).__name__ == type(t).__name__ for j, t in pairs)
    params = {j.name: {k: v.detach().numpy().copy()
                       for k, v in t.param_tree().items()}
              for j, t in pairs if t.param_tree()}
    state = _random_state({j.name: {k: v.numpy() for k, v in
                                    t.state_tree().items()}
                           for j, t in pairs if t.state_tree()}, state_seed)
    return params, state


@pytest.fixture(scope="module")
def resnet_start():
    """ResNet-50 at 3x64x64 built in both packages with the same layer
    names (fresh name counters), the port's initial weights and seeded
    moving statistics as JAX's params and ``net_state``, and the start
    of the ``fit`` test: those params with the gamma of the last
    BatchNorm of every bottleneck branch drawn from U(0.02, 0.05), as
    numpy. Every convolution and BatchNorm then carries a gradient from
    the first step on.

    Why these: this ResNet-50's one-step float32 gradient on 2 images is
    sensitive to rounding, since ReLU masks near zero flip, and the two
    packages' gradients part by as much as rounding moves them
    (``tools/resnet_grad_conditioning.py`` at 3x64x64, 3 draws each: a
    relative 1e-6 change of the input moves the worst tensor's gradient
    by 8e-5 to 5.4e-2 from U(0.02, 0.05), 1e-3 to 1.7e-2 from U(0.1,
    0.25); from zero-init branches, where most gradients are 0, by
    6.8e-5 at most). On this start and these images the two packages
    agree step for step (the module docstring's readings); another draw
    may not, and then shows it in a few BatchNorm betas first."""
    from analytics_zoo_tpu.pipeline.api.keras.engine import base as jbase
    from analytics_zoo_tpu.pipeline.api.keras.layers.merge import Add
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
        base as tbase
    jbase._name_counters.clear()
    tbase._name_counters.clear()
    jnn.set_nncontext(_jax_context())
    jclf = jic.ImageClassifier(class_num=FIT_CLASSES, model_name="resnet-50",
                               input_shape=FIT_SHAPE)
    tclf = tic.ImageClassifier(class_num=FIT_CLASSES, model_name="resnet-50",
                               input_shape=FIT_SHAPE)
    params, state = _jax_trees(jclf.model, tclf.model, 3)
    jclf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    jclf.model._built_params = (params, state)
    weights = [np.array(w) for w in jclf.get_weights()]
    fit_params = _np_tree(params)
    rs = np.random.default_rng(4)
    for node in jclf.model.graph_function().nodes:
        if isinstance(node.layer, Add):
            gamma = fit_params[node.inputs[0].node.layer.name]["gamma"]
            gamma[:] = rs.uniform(0.02, 0.05, gamma.shape)
    return dict(jclf=jclf, tclf=tclf, weights=weights, params=params,
                state=state, fit_params=fit_params)


def test_get_weights_lists_jax_parameters_without_state(resnet_start):
    tclf, jweights = resnet_start["tclf"], resnet_start["weights"]
    state = resnet_start["state"]
    load_jax_params(tclf.model, resnet_start["params"], state=state)
    tweights = tclf.get_weights()
    # 53 convolutions, 53 BatchNorms' gamma and beta, the Dense's two;
    # the same names on both sides, so the same order
    assert len(tweights) == len(jweights) == 53 + 2 * 53 + 2
    for t, j in zip(tweights, jweights):
        assert t.shape == j.shape and t.dtype == np.float32
        np.testing.assert_array_equal(t, j)
    assert len(tclf.model.state_tree()) == 53
    tclf.set_weights([w + 1 for w in tweights])
    assert all(np.array_equal(a, b + 1)
               for a, b in zip(tclf.get_weights(), jweights))
    assert all(np.array_equal(v.numpy(), state[n][k])
               for n, s in tclf.model.state_tree().items()
               for k, v in s.items())


def _residual_net():
    """A small residual block: conv, BatchNorm, ReLU, conv, BatchNorm,
    the Add of the shortcut, ReLU, global pooling and a softmax Dense."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    inp = tl.Input((3, 8, 8))
    h = tl.Activation("relu")(tl.BatchNormalization()(
        tl.Convolution2D(4, 3, 3, border_mode="same")(inp)))
    r = tl.BatchNormalization()(tl.Convolution2D(4, 3, 3,
                                                 border_mode="same")(h))
    out = tl.Activation("relu")(tl.Add()([r, h]))
    out = tl.Dense(3, activation="softmax")(tl.GlobalAveragePooling2D()(out))
    return Model(inp, out, seed=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_recorder_holds_each_layer_against_a_reference(dtype):
    """``utils/layer_parity.py`` on the CPU: a ``train_step`` recorded
    layer by layer and run again on a twin with the same weights agrees
    exactly (the same device does the same arithmetic); a twin with one
    convolution's kernel changed differs in that layer's output and
    gradients; in bf16 each layer's distance from float32 arithmetic on
    the same inputs is reported, and is a bf16 rounding's size."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
    from analytics_zoo_tpu_torch.utils.layer_parity import (LayerRecorder,
                                                            compare_layers)
    model, twin, changed = _residual_net(), _residual_net(), _residual_net()
    with torch.no_grad():
        for m in (twin, changed):
            for a, b in zip(m.parameters(), model.parameters()):
                a.copy_(b)
        convs = [[layer for layer in m.graph_function().layers
                  if isinstance(layer, tl.Convolution2D)]
                 for m in (changed, model)]
        convs[0][1].kernel.mul_(1.5)
    rs = np.random.default_rng(6)
    x = rs.standard_normal((4, 3, 8, 8)).astype(np.float32)
    y = rs.integers(0, 3, 4).astype(np.int32)
    trainer = SPMDTrainer(model, get_loss("sparse_categorical_crossentropy"),
                          get_optimizer("sgd"), device="cpu",
                          compute_dtype=dtype)
    trainer.ensure_initialized()
    with LayerRecorder(model) as recorder:
        trainer.train_step(trainer.put_batch(([x], y,
                                              np.ones(4, np.float32))))
    wide = torch.float32 if dtype == "bfloat16" else None
    same = compare_layers(recorder, twin, also_in=wide)
    assert len(same) == len(model.graph_function().layers) == 9
    for name, r in same.items():
        assert r["y"] == 0.0 and all(d in (None, 0.0) for d in r["dx"])
        assert all(r[k] == 0.0 and r["ref_norm"][k] > 0 for k in r["ref_norm"])
        if wide is not None and r["ref_norm"]:
            assert 0.0 < r["vs_float32"] <= 2e-2, name
    # the Add's two inputs and the first ReLU's gradient (a shortcut
    # consumer too) are each this layer's own share
    add = next(r for n, r in same.items() if n.startswith("add"))
    assert len(add["dx"]) == 2 and None not in add["dx"]
    diff = compare_layers(recorder, changed)
    moved = {n for n, r in diff.items()
             if r["y"] > 1e-2 or r.get("kernel", 0.0) > 1e-2}
    assert moved == {convs[1][1].name}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_fit_matches_jax_step_for_step(resnet_start, dtype,
                                                tmp_path):
    jclf = resnet_start["jclf"]
    params, state = resnet_start["fit_params"], resnet_start["state"]
    rs = np.random.default_rng(11)
    x = rs.standard_normal((FIT_ROWS,) + FIT_SHAPE).astype(np.float32)
    y = rs.integers(0, FIT_CLASSES, FIT_ROWS).astype(np.int32)
    jclf.model.set_compute_dtype(dtype)    # a new trainer from:
    jclf.model._built_params = (params, state)
    jclf.model.set_tensorboard(str(tmp_path), "jax")
    jclf.fit(x, y, batch_size=FIT_BATCH, nb_epoch=1)
    jlosses = [v for _, _, _, v in jclf.model.get_train_summary("Loss")]
    jparams, jstate = _np_tree(jclf.model._params_tuple())

    tclf = tic.ImageClassifier(class_num=FIT_CLASSES, model_name="resnet-50",
                               input_shape=FIT_SHAPE)
    load_jax_params(tclf.model, params, state=state)
    tclf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    tclf.model.set_compute_dtype(dtype)
    tclf.fit(x, y, batch_size=FIT_BATCH, nb_epoch=1)
    tlosses = tclf.model.trainer.step_losses
    tol = FIT_TOL[dtype]
    assert len(tlosses) == len(jlosses) == FIT_ROWS // FIT_BATCH
    assert _err(tlosses, jlosses) <= tol
    # JAX's trained weights and state in a port twin built by the same
    # code: its parameters and buffers come in the same order
    twin = tic.ImageClassifier(class_num=FIT_CLASSES,
                               model_name="resnet-50", input_shape=FIT_SHAPE)
    load_jax_params(twin.model, jparams, state=jstate)
    start = tic.ImageClassifier(class_num=FIT_CLASSES,
                                model_name="resnet-50", input_shape=FIT_SHAPE)
    load_jax_params(start.model, params)
    for (name, p), (_, want), p0 in zip(tclf.model.named_parameters(),
                                        twin.model.named_parameters(),
                                        start.model.parameters()):
        assert p.dtype == torch.float32
        assert _err(p.detach().numpy(), want.detach().numpy()) <= tol, name
        # each leaf's own update, over the norm of JAX's
        mine, theirs = (p - p0).detach().double(), (want - p0).double()
        if name.endswith(".kernel"):
            assert theirs.norm() > 0, f"{name}: JAX did not update it"
        assert (mine - theirs).norm() <= \
            FIT_UPDATE_TOL[dtype] * theirs.norm(), name
    for (name, b), (_, want) in zip(tclf.model.named_buffers(),
                                    twin.model.named_buffers()):
        assert b.dtype == torch.float32
        assert _err(b.numpy(), want.numpy()) <= tol, name
    # the moving statistics and the weights moved
    assert max(_err(jstate[n][k], state[n][k])
               for n in state for k in state[n]) > 1e-3
    assert max(_err(jparams[n][k], params[n][k])
               for n in params for k in params[n]) > 1e-4
