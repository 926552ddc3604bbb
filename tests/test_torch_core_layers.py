"""The rest of ``core.py`` in the port against the JAX package on the CPU:
every layer's forward from copied weights, and where a layer has weights
its gradients (``jax.grad`` against autograd), as cases of parametrised
tests; the stochastic layers' training-mode draws (from a
``torch.Generator``, so their bits differ from JAX's by design) by their
statistics; and a graph of the new weighted layers taking JAX's params by
name through ``load_jax_params``.

Tolerances (largest |port - JAX|): forward 1e-5 (ResizeBilinear 1e-4:
two resampling kernels summing in another order); gradients 1e-5 of the
gradient's largest element; the stochastic layers' sample statistics
within 5 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.utils import load_jax_params

FWD_TOL = 1e-5
RESIZE_TOL = 1e-4
GRAD_TOL = 1e-5
SIGMAS = 5.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max())


POSITIVE = "positive"
CASES = {   # name -> (make(module), input shape(s) without batch, kind)
    "reshape": (lambda m: m.Reshape((4, -1)), (2, 3, 4), None),
    "reshape_full": (lambda m: m.Reshape((6, 4)), (2, 3, 4), None),
    "permute": (lambda m: m.Permute((2, 3, 1)), (2, 3, 4), None),
    "repeat_vector": (lambda m: m.RepeatVector(3), (5,), None),
    "masking": (lambda m: m.Masking(0.0), (4, 3), "masked"),
    "highway_tanh": (lambda m: m.Highway(), (6,), None),
    "highway_relu_nobias": (lambda m: m.Highway("relu", bias=False), (6,),
                            None),
    "maxout_dense": (lambda m: m.MaxoutDense(5, nb_feature=3), (6,), None),
    "narrow": (lambda m: m.Narrow(1, 1, 2), (5, 3), None),
    "narrow_to_end": (lambda m: m.Narrow(2, 1, 0), (2, 5), None),
    "squeeze": (lambda m: m.Squeeze(2), (3, 1, 4), None),
    "squeeze_two": (lambda m: m.Squeeze([1, 3]), (1, 3, 1), None),
    "expand_dim": (lambda m: m.ExpandDim(1), (3, 4), None),
    "expand_dim_last": (lambda m: m.ExpandDim(-1), (3, 4), None),
    "identity": (lambda m: m.Identity(), (3, 4), None),
    "max": (lambda m: m.Max(1), (4, 3), None),
    "max_index": (lambda m: m.Max(2, return_value=False), (4, 3), None),
    "split_tensor": (lambda m: m.SplitTensor(1, 2), (4, 3), None),
    "exp": (lambda m: m.Exp(), (3, 4), None),
    "log": (lambda m: m.Log(), (3, 4), POSITIVE),
    "sqrt": (lambda m: m.Sqrt(), (3, 4), POSITIVE),
    "square": (lambda m: m.Square(), (3, 4), None),
    "negative": (lambda m: m.Negative(), (3, 4), None),
    "power": (lambda m: m.Power(2, 0.5, 1.0), (3, 4), None),
    "power_cube": (lambda m: m.Power(3), (3, 4), None),
    "add_constant": (lambda m: m.AddConstant(2.5), (3, 4), None),
    "mul_constant": (lambda m: m.MulConstant(-1.5), (3, 4), None),
    "cadd": (lambda m: m.CAdd((1, 4)), (3, 4), None),
    "cmul": (lambda m: m.CMul((3, 1)), (3, 4), None),
    "mul": (lambda m: m.Mul(), (3, 4), None),
    "scale": (lambda m: m.Scale((3, 4)), (3, 4), None),
    "binary_threshold": (lambda m: m.BinaryThreshold(0.1), (3, 4), None),
    "threshold": (lambda m: m.Threshold(0.2, -1.0), (3, 4), None),
    "hard_tanh": (lambda m: m.HardTanh(-0.5, 0.7), (3, 4), None),
    "hard_shrink": (lambda m: m.HardShrink(0.4), (3, 4), None),
    "soft_shrink": (lambda m: m.SoftShrink(0.3), (3, 4), None),
    "gaussian_noise": (lambda m: m.GaussianNoise(0.5), (3, 4), None),
    "gaussian_dropout": (lambda m: m.GaussianDropout(0.3), (3, 4), None),
    "spatial_dropout1d": (lambda m: m.SpatialDropout1D(0.5), (4, 3), None),
    "spatial_dropout2d": (lambda m: m.SpatialDropout2D(0.5), (2, 3, 4),
                          None),
    "spatial_dropout3d_tf": (lambda m: m.SpatialDropout3D(
        0.5, dim_ordering="tf"), (2, 3, 4, 2), None),
    "gaussian_sampler": (lambda m: m.GaussianSampler(), [(5,), (5,)], None),
    "resize_bilinear_up": (lambda m: m.ResizeBilinear(6, 10), (2, 4, 5),
                           None),
    "resize_bilinear_down": (lambda m: m.ResizeBilinear(3, 4), (2, 7, 9),
                             None),
    "resize_bilinear_tf": (lambda m: m.ResizeBilinear(
        5, 3, dim_ordering="tf"), (4, 6, 2), None),
    "sparse_dense": (lambda m: m.SparseDense(4, activation="relu"), (6,),
                     None),
    "sparse_dense_window": (lambda m: m.SparseDense(
        4, backward_start=2, backward_length=3), (6,), None),
    "select_table": (lambda m: m.SelectTable(1), [(3,), (4,)], None),
    "expand": (lambda m: m.Expand((-1, 3, 4)), (1, 4), None),
    "get_shape": (lambda m: m.GetShape(), (3, 4), None),
}

WEIGHTED = ["highway_tanh", "highway_relu_nobias", "maxout_dense", "cadd",
            "cmul", "mul", "scale", "sparse_dense", "sparse_dense_window"]


def _inputs(case, batch=2):
    _, shapes, kind = CASES[case]
    rs = np.random.default_rng(sorted(CASES).index(case))
    multi = isinstance(shapes, list)
    xs = [rs.standard_normal((batch,) + tuple(s)).astype(np.float32)
          for s in (shapes if multi else [shapes])]
    if kind == POSITIVE:
        xs = [np.abs(x) + 0.1 for x in xs]
    if kind == "masked":
        xs[0][:, 1] = 0.0
        xs[0][0, 3] = 0.0
    return (xs if multi else xs[0]), multi


def _pair(case):
    """The case's layer in both packages, the port holding JAX's params
    (drawn away from the ones/zeros inits), and the input."""
    make, shapes, _ = CASES[case]
    jlayer, tlayer = make(jl), make(tl)
    in_shape = [(None,) + tuple(s) for s in shapes] \
        if isinstance(shapes, list) else (None,) + tuple(shapes)
    rs = np.random.default_rng(100 + sorted(CASES).index(case))
    jparams = jax.tree.map(
        lambda a: (np.asarray(a) + rs.normal(0, 0.3, np.shape(a))).astype(
            np.float32),
        jlayer.build(jax.random.PRNGKey(0), in_shape))
    tlayer.build_params(torch.Generator().manual_seed(0), in_shape)
    if jparams:
        load_jax_params(tlayer, {tlayer.name: jparams})
    x, multi = _inputs(case)
    return jlayer, tlayer, jparams, x, multi, in_shape


def _as_torch(x, multi, grad=False):
    if multi:
        return [torch.from_numpy(a).requires_grad_(grad) for a in x]
    return torch.from_numpy(x).requires_grad_(grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_core_layer_forward_matches_jax(case):
    jlayer, tlayer, jparams, x, multi, in_shape = _pair(case)
    jx = [jnp.asarray(a) for a in x] if multi else jnp.asarray(x)
    want = jlayer.call(jparams, jx)
    got = tlayer(_as_torch(x, multi))
    tol = RESIZE_TOL if case.startswith("resize") else FWD_TOL
    wants = list(want) if isinstance(want, tuple) else [want]
    gots = list(got) if isinstance(got, tuple) else [got]
    shapes = tlayer.compute_output_shape(in_shape)
    shapes = shapes if isinstance(shapes, list) else [shapes]
    assert len(gots) == len(wants) == len(shapes)
    for g, w, s in zip(gots, wants, shapes):
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        assert g.shape == tuple(2 if d is None else d for d in s)
        if case == "max_index":
            np.testing.assert_array_equal(g, w)
        else:
            assert _err(g, w) <= tol


@pytest.mark.parametrize("case", WEIGHTED)
def test_core_layer_gradients_match_jax(case):
    jlayer, tlayer, jparams, x, multi, in_shape = _pair(case)
    cot = np.random.default_rng(7).standard_normal(
        np.shape(jlayer.call(jparams, jnp.asarray(x)))).astype(np.float32)

    def jloss(params, xin):
        return jnp.sum(jlayer.call(params, xin) * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = _as_torch(x, multi, grad=True)
    (tlayer(xt) * torch.from_numpy(cot)).sum().backward()
    assert {n for n, _ in tlayer.named_parameters()} == set(jgp)
    for name, p in tlayer.named_parameters():
        want = np.asarray(jgp[name])
        assert _err(p.grad.numpy(), want) <= \
            GRAD_TOL * max(np.abs(want).max(), 1e-6), name
    want = np.asarray(jgx)
    got = xt.grad.numpy() if xt.grad is not None else np.zeros_like(want)
    assert _err(got, want) <= GRAD_TOL * max(np.abs(want).max(), 1e-6)
    if case == "sparse_dense":
        assert np.abs(want).max() == 0.0      # no gradient to the input
    if case == "sparse_dense_window":
        assert np.abs(want[:, 1:4]).min() > 0 and \
            np.abs(want[:, [0, 4, 5]]).max() == 0.0


@pytest.mark.parametrize("case", ["spatial_dropout1d", "spatial_dropout2d",
                                  "spatial_dropout3d_tf", "gaussian_noise",
                                  "gaussian_dropout", "gaussian_sampler"])
def test_stochastic_layers_draw_from_the_generator(case):
    make, shapes, _ = CASES[case]
    layer = make(tl)
    gen = torch.Generator().manual_seed(3)
    rs = np.random.default_rng(4)
    if case == "gaussian_sampler":
        mean = torch.from_numpy(rs.standard_normal((4000, 5)).astype(
            np.float32))
        log_var = torch.full((4000, 5), np.log(0.25), dtype=torch.float32)
        eps = (layer([mean, log_var], training=True, generator=gen) -
               mean) / 0.5
        assert torch.equal(layer([mean, log_var]), mean)
    else:
        x = torch.ones((4000,) + tuple(shapes))
        y = layer(x, training=True, generator=gen)
        assert torch.equal(layer(x, training=True), x)   # no generator
        assert torch.equal(layer(x, training=False, generator=gen), x)
        if case.startswith("spatial"):
            axes = {"spatial_dropout1d": (1,), "spatial_dropout2d": (2, 3),
                    "spatial_dropout3d_tf": (1, 2, 3)}[case]
            zero = (y == 0).all(dim=axes)
            kept = (y == 2.0).all(dim=axes)
            assert bool((zero | kept).all())      # whole channels
            share = float(zero.float().mean())
            se = np.sqrt(0.25 / zero.numel())
            assert abs(share - 0.5) <= SIGMAS * se
            return
        eps = y - 1.0
        scale = 0.5 if case == "gaussian_noise" else np.sqrt(0.3 / 0.7)
        eps = eps / scale
    n = eps.numel()
    assert abs(float(eps.mean())) <= SIGMAS / np.sqrt(n)
    assert abs(float(eps.std()) - 1.0) <= SIGMAS * np.sqrt(0.5 / n)


def test_graph_of_new_layers_takes_jax_params_by_name():
    def build(m, seq):
        model = seq()
        model.add(m.Highway(input_shape=(6,), name="hw"))
        model.add(m.MaxoutDense(5, nb_feature=2, name="maxout"))
        model.add(m.Scale((5,), name="scale"))
        model.add(m.RepeatVector(2, name="rep"))
        model.add(m.Reshape((5, 2), name="rs"))
        model.add(m.Permute((2, 1), name="perm"))
        model.add(m.CMul((1, 5), name="cm"))
        model.add(m.Flatten(name="flat"))
        model.add(m.SparseDense(3, name="sd"))
        return model

    jmodel = build(jl, JSequential)
    rs = np.random.default_rng(9)
    params = jax.tree.map(lambda a: (np.asarray(a) + rs.normal(
        0, 0.2, np.shape(a))).astype(np.float32), jmodel.get_params())
    tmodel = build(tl, Sequential)
    load_jax_params(tmodel, params)
    x = rs.standard_normal((4, 6)).astype(np.float32)
    want = np.asarray(jmodel.graph_function().apply(params, [x]))
    got = tmodel.predict(x, batch_size=4)
    assert got.shape == want.shape == (4, 3)
    assert _err(got, want) <= FWD_TOL
    assert sorted(tmodel.param_tree()) == sorted(params)
