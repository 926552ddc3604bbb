"""The rest of the layer library against the JAX package on the CPU: the
advanced activations, the 3-D, transposed and locally connected
convolutions, their 3-D companions and ConvLSTM2D/3D.

Each case builds the JAX layer, copies its parameters into the port's
twin (``load_jax_params``), and feeds both the same seeded input.
Tolerances, the repo's parity rules for layers: the float32 forward
within 1e-5 of the output's scale; the input's and every parameter's
gradient (of the sum of the output times a seeded cotangent, against
``jax.grad``) within 1e-4 of that gradient's norm; the port in bf16
(parameters and input cast) within 2e-2 of the float32 output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    convolutional as tconv
from analytics_zoo_tpu_torch.utils import load_jax_params

FWD_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2

#: name -> (constructor over a layers module, input shape without batch)
CASES = {
    "LeakyReLU": (lambda m: m.LeakyReLU(0.2), (3, 5)),
    "ELU": (lambda m: m.ELU(0.7), (3, 5)),
    "PReLU_shared": (lambda m: m.PReLU(), (3, 5)),
    "PReLU_channels": (lambda m: m.PReLU(n_output_plane=3), (3, 4, 2)),
    "SReLU": (lambda m: m.SReLU(), (3, 4)),
    "SReLU_shared": (lambda m: m.SReLU(shared_axes=[1]), (3, 4)),
    "ThresholdedReLU": (lambda m: m.ThresholdedReLU(0.3), (3, 5)),
    "RReLU_inference": (lambda m: m.RReLU(0.1, 0.4), (3, 5)),
    "Softmax": (lambda m: m.Softmax(axis=1), (4, 3)),
    "Convolution3D_th": (lambda m: m.Convolution3D(
        4, 2, 3, 2, activation="relu"), (2, 5, 6, 4)),
    "Convolution3D_same_strided": (lambda m: m.Convolution3D(
        3, 3, 2, 3, border_mode="same", subsample=(2, 1, 2)),
        (2, 5, 4, 5)),
    "Convolution3D_tf": (lambda m: m.Convolution3D(
        3, 2, 2, 2, dim_ordering="tf"), (4, 5, 3, 2)),
    "ShareConvolution2D": (lambda m: m.ShareConvolution2D(
        3, 3, 2, border_mode="same"), (2, 6, 5)),
    "LocallyConnected2D": (lambda m: m.LocallyConnected2D(
        3, 2, 3, activation="tanh"), (2, 5, 6)),
    "LocallyConnected2D_same_tf": (lambda m: m.LocallyConnected2D(
        2, 3, 3, border_mode="same", subsample=(2, 2), dim_ordering="tf"),
        (5, 6, 2)),
    "LocallyConnected1D": (lambda m: m.LocallyConnected1D(3, 2), (7, 4)),
    "LocallyConnected1D_same_strided": (lambda m: m.LocallyConnected1D(
        2, 3, border_mode="same", subsample_length=2, bias=False), (7, 3)),
    "Cropping3D_th": (lambda m: m.Cropping3D(((1, 0), (0, 1), (1, 1))),
                      (2, 4, 4, 5)),
    "Cropping3D_tf": (lambda m: m.Cropping3D(((0, 1), (1, 1), (0, 0)),
                                             dim_ordering="tf"),
                      (4, 4, 3, 2)),
    "UpSampling3D": (lambda m: m.UpSampling3D((1, 2, 3)), (2, 2, 3, 2)),
    "ZeroPadding3D": (lambda m: m.ZeroPadding3D((1, 0, 2)), (2, 2, 3, 2)),
    "ConvLSTM2D": (lambda m: m.ConvLSTM2D(3, 3), (4, 2, 5, 6)),
    "ConvLSTM2D_seq_backwards": (lambda m: m.ConvLSTM2D(
        2, 3, return_sequences=True, go_backwards=True), (3, 2, 4, 4)),
    "ConvLSTM2D_strided": (lambda m: m.ConvLSTM2D(
        2, 3, subsample=2, return_sequences=True), (3, 1, 5, 6)),
    "ConvLSTM3D": (lambda m: m.ConvLSTM3D(2, 3, return_sequences=True),
                   (3, 1, 3, 4, 4)),
}
for _s in (1, 2, 3):
    for _k in (2, 3):
        for _mode in ("valid", "same"):
            CASES[f"Deconvolution2D_s{_s}_k{_k}_{_mode}"] = (
                lambda m, s=_s, k=_k, mode=_mode: m.Deconvolution2D(
                    3, k, k + 1, border_mode=mode, subsample=(s, s)),
                (2, 4, 5))
CASES["Deconvolution2D_tf"] = (lambda m: m.Deconvolution2D(
    2, 3, 2, subsample=(2, 1), border_mode="same", dim_ordering="tf"),
    (4, 3, 2))


def _pair(case, seed=0):
    make, shape = CASES[case]
    jlayer, tlayer = make(jl), make(tl)
    in_shape = (None,) + shape
    jparams = jlayer.build(jax.random.PRNGKey(seed), in_shape)
    tlayer.build_params(torch.Generator().manual_seed(seed), in_shape)
    if jparams:
        # nonzero biases and thresholds, so every parameter is exercised
        rs = np.random.default_rng(seed + 100)
        jparams = {k: np.asarray(v) + 0.1 * rs.standard_normal(
            np.shape(v)).astype(np.float32) for k, v in jparams.items()}
        load_jax_params(tlayer, {tlayer.name: jparams})
    return jlayer, tlayer, {k: jnp.asarray(v) for k, v in jparams.items()}


def _input(case, seed=1, batch=2):
    shape = (batch,) + CASES[case][1]
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    # keep inputs off the kinks of the piecewise activations
    return np.where(np.abs(x) < 1e-3, 0.01, x).astype(np.float32)


def _jcall(jlayer, params, x):
    out = jlayer.call(params, x, training=False)
    return out[0] if isinstance(out, tuple) else out


def _scale_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err} vs {tol} x {scale}"


def _norm_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert err <= tol * max(float(np.linalg.norm(want)), 1e-30), \
        f"{what}: err {err} vs norm {np.linalg.norm(want)}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    jlayer, tlayer, jp = _pair(case)
    x = _input(case)
    want = _jcall(jlayer, jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tlayer(tx)
    assert tuple(got.shape) == tuple(want.shape)
    _scale_close(got.detach().numpy(), want, FWD_TOL, "forward")
    cot = np.random.default_rng(2).standard_normal(
        tuple(want.shape)).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(_jcall(jlayer, p, xx) * cot),
        argnums=(0, 1))(jp, jnp.asarray(x))
    (got * torch.from_numpy(cot)).sum().backward()
    _norm_close(tx.grad.numpy(), jgx, GRAD_TOL, "dx")
    for name, p in tlayer.named_parameters():
        _norm_close(p.grad.numpy(), jgp[name], GRAD_TOL, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_within_tolerance(case):
    jlayer, tlayer, jp = _pair(case, seed=3)
    x = _input(case, seed=4)
    want = _jcall(jlayer, jp, jnp.asarray(x))
    cast = {k: v.detach().to(torch.bfloat16)
            for k, v in tlayer.named_parameters()}
    got = torch.func.functional_call(
        tlayer, cast, (torch.from_numpy(x).to(torch.bfloat16),))
    assert got.dtype == torch.bfloat16
    _scale_close(got.float().numpy(), want, BF16_TOL, "bf16")


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_shape_rule_matches_jax(case):
    make, shape = CASES[case]
    in_shape = (None,) + shape
    assert tuple(make(tl).compute_output_shape(in_shape)) == \
        tuple(make(jl).compute_output_shape(in_shape))


def test_rrelu_training_slopes_lie_in_range_with_the_mean_slope():
    """Training RReLU draws its slopes from the generator it is given;
    their bits are not JAX's, so the range and mean are held, and
    inference is exact (the test above)."""
    layer = tl.RReLU(0.1, 0.4)
    x = -torch.ones(200, 50)
    gen = torch.Generator().manual_seed(7)
    a = -layer(x, training=True, generator=gen)
    assert float(a.min()) >= 0.1 and float(a.max()) <= 0.4
    assert abs(float(a.mean()) - 0.25) < 5e-3
    again = -layer(x, training=True,
                   generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, again)
    assert torch.equal(layer(x), x * 0.25)
    pos = torch.rand(10, 3)
    assert torch.equal(layer(pos, training=True, generator=gen), pos)


@pytest.mark.parametrize("k,s,mode", [(k, s, m) for k in (1, 2, 3, 4)
                                      for s in (1, 2, 3)
                                      for m in ("valid", "same")])
def test_transpose_crops_follow_lax_conv_transpose(k, s, mode):
    """The crop rule against ``lax.conv_transpose`` on a 1-D signal."""
    x = np.random.default_rng(k * 10 + s).standard_normal((1, 5, 1)) \
        .astype(np.float32)
    w = np.random.default_rng(1).standard_normal((k, 1, 1)).astype(
        np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (s,),
                                  mode.upper(),
                                  dimension_numbers=("NWC", "WIO", "NWC"),
                                  transpose_kernel=True)
    full = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).permute(0, 2, 1),
        torch.from_numpy(w).permute(2, 1, 0), stride=s)[0, 0]
    before, after = tconv.transpose_crops(k, s, mode)
    got = full[before:full.shape[0] - max(after, 0)]
    if after < 0:
        got = torch.cat([got, torch.zeros(-after)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0, :, 0],
                               rtol=1e-6, atol=1e-6)


def test_convlstm_refuses_valid_border_like_jax():
    for m in (jl, tl):
        with pytest.raises(ValueError, match="same"):
            m.ConvLSTM2D(2, 3, border_mode="valid")
