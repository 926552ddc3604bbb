"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need an NVIDIA Hopper GPU and the CUDA toolkit (the
kernels build at first use), and skip where there is none. Run them on a
machine with the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
need not have; this file imports none.) Tolerances, element by element
``|o - ro| <= atol + rtol * |ro|``: 1e-4 in float32 (the kernel sums in
another order than the plain version); in bfloat16 two bf16 steps at
``|ro|`` plus a quarter step at unit scale, since both round o to bf16
and the kernel rounds p against its running max. lse is float32
arithmetic in both dtypes and is held at 1e-4 in both.

The backward and dropout+add+layer-norm kernels are held element by
element at ``|g - rg| <= a * max|rg| + r * |rg|`` (``_close``): float32
(1e-5, 1e-5) for values the kernel sums in another order (1e-4 of the max
for the 16384-row dgamma/dbeta sums); bfloat16 (2^-8, 2^-6), two bf16
steps at |rg| plus a half step at the tensor's scale, since both sides
round the same f32 intermediates and an ulp apart in f32 can flip a bf16
rounding. The key-bias gradient and the row statistics are float32 in
both dtypes.
"""

import math

import pytest
import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as ta
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as tdln

pytestmark = pytest.mark.gpu

O_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -9, 2 ** -6)}
LSE_TOL = 1e-4
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -8, 2 ** -6)}
F32_TOL = GRAD_TOL[torch.float32]
ROW_SUM_TOL = (1e-4, 1e-5)


def _close(got, want, tol):
    a, r = tol
    got, want = got.float(), want.float()
    limit = a * want.abs().max() + r * want.abs()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= limit).all(), \
        f"max err {(got - want).abs().max().item()}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode; its "
                    "plain version is tested against JAX on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv_views(b, lq, lk, h, d, dtype, device, gen):
    """q, k, v as the strided (B, L, H, d) views of one fused projection,
    as the transformer block hands them to the kernel."""
    lmax = max(lq, lk)
    qkv = torch.randn(b, lmax, 3 * h * d, device=device, generator=gen) \
        .to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    return (q[:, :lq].reshape(b, lq, h, d), k[:, :lk].reshape(b, lk, h, d),
            v[:, :lk].reshape(b, lk, h, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", [
    (2, 512, 512, 12, 64, False, True),
    (2, 256, 256, 4, 64, True, False),
    (2, 128, 512, 4, 64, True, True),
    (2, 300, 300, 4, 64, False, True),
    (2, 200, 200, 2, 128, True, True),
    (1, 1, 77, 2, 64, True, False),
    # a partial last key tile at each streamed tile size (32 keys in
    # float32, 64 in bf16) and a partial q tile, at d=64 and d=128
    (2, 77, 77, 4, 64, False, True),
    (2, 77, 77, 2, 128, False, True),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, d,
                                            causal, bias):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _qkv_views(b, lq, lk, h, d, dtype, cuda, gen)
    assert k.stride(1) == 3 * h * d     # rows of the fused projection
    kb = torch.zeros(b, lk, device=cuda)
    if bias:
        kb = 0.5 * torch.randn(b, lk, device=cuda, generator=gen)
        kb[:, lk // 3:] = -10000.0
    before = _kernels.LAUNCHES.get(ta.KERNEL_NAME)
    o, lse = ta.flash_forward_blhd(q, k, v, kb, causal)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES.get(ta.KERNEL_NAME) == before + 1
    ro, rl = ta.flash_forward_reference(q, k, v, kb, causal,
                                        1.0 / math.sqrt(d))
    assert o.dtype == dtype and o.shape == (b, lq, h, d)
    assert torch.isfinite(o.float()).all()
    atol, rtol = O_TOL[dtype]
    assert ((o.float() - ro.float()).abs()
            <= atol + rtol * ro.float().abs()).all()
    assert (lse - rl).abs().max().item() <= LSE_TOL


def test_bert_block_on_the_card_matches_the_cpu(cuda):
    """A small BERT classifier on the card (kernel route) against the
    same weights on the CPU (plain route)."""
    import copy

    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    l, hid = 256, 128
    ins = [tl.Input(shape=(l,)), tl.Input(shape=(l,)), tl.Input(shape=(l,)),
           tl.Input(shape=(1, 1, l))]
    _, pooled = tl.BERT(vocab=100, hidden_size=hid, n_block=2, n_head=2,
                        seq_len=l, output_all_block=False)(ins)
    model = Model(ins, tl.Dense(2, activation="softmax")(pooled), seed=0)
    lengths = torch.tensor([l, 100, 7])
    xs = [torch.randint(0, 100, (3, l)).float(),
          torch.arange(l).float().expand(3, l).contiguous(),
          torch.zeros(3, l),
          (torch.arange(l)[None] < lengths[:, None]).float()[:, None, None]]
    cpu_model = copy.deepcopy(model)
    model.to(cuda)
    with torch.inference_mode():
        want = cpu_model(xs)
        before = _kernels.LAUNCHES.get(ta.KERNEL_NAME)
        got = model([x.to(cuda) for x in xs]).cpu()
    assert _kernels.LAUNCHES.get(ta.KERNEL_NAME) == before + 2
    assert (got - want).abs().max().item() <= 1e-4


def _padding_bias(b, lk, device, gen):
    kb = 0.5 * torch.randn(b, lk, device=device, generator=gen)
    kb[:, lk // 3:] = -10000.0
    return kb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias", [
    (2, 512, 512, 12, 64, False, True),
    (2, 256, 256, 4, 64, True, False),
    (2, 128, 512, 4, 64, True, True),
    (2, 300, 300, 4, 64, False, True),
    (2, 200, 200, 2, 128, True, True),
    # a partial last tile at each streamed tile size (64 rows in bf16, 32
    # in float32) at d=64 and d=128, and causal Lq < Lk with a wide offset
    (2, 77, 77, 4, 64, False, True),
    (2, 77, 77, 2, 128, False, True),
    (2, 200, 200, 2, 128, False, True),
    (2, 64, 320, 4, 64, True, True),
])
def test_flash_backward_kernels_match_plain_version(cuda, dtype, b, lq, lk,
                                                    h, d, causal, bias):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = _qkv_views(b, lq, lk, h, d, dtype, cuda, gen)
    kb = _padding_bias(b, lk, cuda, gen) if bias else \
        torch.zeros(b, lk, device=cuda)
    scale = 1.0 / math.sqrt(d)
    o, lse = ta.flash_forward_reference(q, k, v, kb, causal, scale)
    do = torch.randn(b, lq, h, d, device=cuda, generator=gen).to(dtype)
    before = _kernels.LAUNCHES.snapshot()
    got = ta.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
    torch.cuda.synchronize()
    after = _kernels.LAUNCHES.snapshot()
    for name in (ta.DQ_KERNEL_NAME, ta.DKV_KERNEL_NAME):
        assert after.get(name, 0) == before.get(name, 0) + 1
    want = ta.flash_backward_reference(q, k, v, kb, o, lse, do, causal,
                                       scale)
    for g, w, tol in zip(got, want, [GRAD_TOL[dtype]] * 3 + [F32_TOL]):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_are_deterministic(cuda, dtype, causal):
    """Each output is summed by one block in a fixed order (no atomics):
    two calls on the same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, l, h, d = 2, 300, 4, 64
    q, k, v = _qkv_views(b, l, l, h, d, dtype, cuda, gen)
    kb = _padding_bias(b, l, cuda, gen)
    o, lse = ta.flash_forward_blhd(q, k, v, kb, causal)
    do = torch.randn(b, l, h, d, device=cuda, generator=gen).to(dtype)
    first = ta.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
    second = ta.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_kernel_is_deterministic(cuda, dtype, causal):
    """Each o row is summed by one block in a fixed order: two calls on
    the same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, l, h, d = 2, 300, 4, 64
    q, k, v = _qkv_views(b, l, l, h, d, dtype, cuda, gen)
    kb = _padding_bias(b, l, cuda, gen)
    first = ta.flash_forward_blhd(q, k, v, kb, causal)
    second = ta.flash_forward_blhd(q, k, v, kb, causal)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel",
                                    "flash_fwd_kernel"])
def test_flash_backward_kernels_run_on_the_tensor_cores(cuda, kernel):
    """Every instantiation (float32 and bf16, d = 64 and 128) of the
    flash kernels, the backward's and the forward's, holds tensor-core
    instructions in its SASS."""
    _kernels.library()
    sass = _kernels.sass_opcode_counts(_kernels.BUILD_INFO["library"])
    found = {sym: n for sym, n in sass.items() if kernel in sym}
    assert len(found) == 4, found
    for sym, n in found.items():
        assert n["HGMMA"] + n["HMMA"] > 0, (sym, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_runs_the_backward_kernels(cuda, dtype):
    """torch.autograd.grad through flash_attention_blhd on the card equals
    the plain backward on the same saved o and lse: the fault where the
    kernel route returned a tensor without autograd history is gone."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, l, h, d = 2, 256, 4, 64
    q, k, v = (t.detach().requires_grad_() for t in
               _qkv_views(b, l, l, h, d, dtype, cuda, gen))
    bias = _padding_bias(b, l, cuda, gen)[:, None, None, :]
    do = torch.randn(b, l, h, d, device=cuda, generator=gen).to(dtype)
    before = _kernels.LAUNCHES.snapshot()
    out = ta.flash_attention_blhd(q, k, v, bias=bias)
    assert out.grad_fn is not None
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    after = _kernels.LAUNCHES.snapshot()
    for name in (ta.KERNEL_NAME, ta.DQ_KERNEL_NAME, ta.DKV_KERNEL_NAME):
        assert after.get(name, 0) == before.get(name, 0) + 1
    kb = bias.reshape(b, l)
    o, lse = ta.flash_forward_blhd(q.detach(), k.detach(), v.detach(), kb)
    want = ta.flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                       kb, o, lse, do, False,
                                       1.0 / math.sqrt(d))
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,keep", [(16384, 768, 0.9), (300, 128, 0.75),
                                      (37, 1000, 0.5), (64, 64, 0.9),
                                      (301, 770, 0.8)])
def test_dropout_layer_norm_kernels_match_plain_version(cuda, dtype, n, d,
                                                        keep):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    r = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(d, device=cuda, generator=gen)
    beta = 0.1 * torch.randn(d, device=cuda, generator=gen)
    bits = tdln.draw_bits((n, d), gen, cuda)
    before = _kernels.LAUNCHES.snapshot()
    y, z, mean, inv = tdln.dln_forward(x, r, bits, gamma, beta, keep)
    torch.cuda.synchronize()
    ry, rz, rmean, rinv = tdln.dln_forward_reference(x, r, bits, gamma,
                                                     beta, keep, 1e-5)
    _close(y, ry, GRAD_TOL[dtype])
    _close(z, rz, GRAD_TOL[dtype])
    _close(mean, rmean, F32_TOL)
    _close(inv, rinv, F32_TOL)
    dy = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    got = tdln.dln_backward(dy, rz, bits, gamma, rmean, rinv, keep)
    torch.cuda.synchronize()
    after = _kernels.LAUNCHES.snapshot()
    for name in (tdln.FWD_KERNEL_NAME, tdln.BWD_KERNEL_NAME):
        assert after.get(name, 0) == before.get(name, 0) + 1
    want = tdln.dln_backward_reference(dy, rz, bits, gamma, rmean, rinv,
                                       keep)
    for g, w, tol in zip(got, want, [GRAD_TOL[dtype]] * 2 +
                         [ROW_SUM_TOL] * 2):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(16384, 768), (301, 770)])
def test_dropout_layer_norm_backward_is_deterministic(cuda, dtype, n, d):
    """dgamma/dbeta are summed in fixed orders (a warp's rows, the block's
    warps, then the blocks), with no atomics: two calls on the same inputs
    agree bit for bit, at the training shape (16-byte chunks) and at D off
    the chunk (one value a chunk)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    r = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(d, device=cuda, generator=gen)
    beta = 0.1 * torch.randn(d, device=cuda, generator=gen)
    bits = tdln.draw_bits((n, d), gen, cuda)
    _, z, mean, inv = tdln.dln_forward(x, r, bits, gamma, beta, 0.9)
    dy = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    first = tdln.dln_backward(dy, z, bits, gamma, mean, inv, 0.9)
    second = tdln.dln_backward(dy, z, bits, gamma, mean, inv, 0.9)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _small_classifier(l, hid, p_drop, seed):
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    ins = [tl.Input(shape=(l,)), tl.Input(shape=(l,)), tl.Input(shape=(l,)),
           tl.Input(shape=(1, 1, l))]
    _, pooled = tl.BERT(vocab=100, hidden_size=hid, n_block=2, n_head=2,
                        seq_len=l, hidden_p_drop=p_drop, attn_p_drop=p_drop,
                        output_all_block=False)(ins)
    return Model(ins, tl.Dense(2, activation="softmax")(pooled), seed=seed)


def _small_batch(l, device):
    lengths = torch.tensor([l, 100, 7])
    xs = [torch.randint(0, 100, (3, l),
                        generator=torch.Generator().manual_seed(0)).float(),
          torch.arange(l).float().expand(3, l).contiguous(),
          torch.zeros(3, l),
          (torch.arange(l)[None] < lengths[:, None]).float()[:, None, None]]
    y = torch.tensor([0, 1, 1])
    return [x.to(device) for x in xs], y.to(device), \
        torch.ones(3, device=device)


def test_bert_training_step_on_the_card_matches_the_cpu(cuda):
    """One training step of a small BERT classifier, dropout off: the
    card (flash forward and backward kernels) against the same weights on
    the CPU (plain versions). Loss within 1e-5; each parameter's gradient
    within 1e-4 of its norm (float32 both sides, sums in another order)."""
    import copy

    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer

    l = 256
    model = _small_classifier(l, 128, 0.0, seed=0)
    cpu_model = copy.deepcopy(model)
    loss = get_loss("sparse_categorical_crossentropy")
    gpu = SPMDTrainer(model, loss, get_optimizer("adam"), device=cuda)
    cpu = SPMDTrainer(cpu_model, loss, get_optimizer("adam"), device="cpu")
    gpu.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    got = gpu.loss_and_grads(_small_batch(l, cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES.snapshot() == {
        ta.KERNEL_NAME: 2, ta.DQ_KERNEL_NAME: 2, ta.DKV_KERNEL_NAME: 2}
    want = cpu.loss_and_grads(_small_batch(l, "cpu"))
    assert abs(got.item() - want.item()) <= 1e-5
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        g, w = p.grad.cpu(), cpu_params[name].grad
        assert torch.isfinite(g).all(), name
        assert (g - w).norm() <= 1e-4 * w.norm() + 1e-12, name


def test_bert_fit_with_dropout_runs_every_training_kernel(cuda):
    """Model.fit with dropout on, one step: every training kernel runs
    (per block one flash forward, dq and dkv launch, two dropout+add+LN
    forward and backward launches), the loss is finite and every block's
    qkv_w gets a nonzero gradient."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        l = 128
        model = _small_classifier(l, 128, 0.1, seed=1)
        model.compile(optimizer="adam",
                      loss="sparse_categorical_crossentropy")
        xs, y, _ = _small_batch(l, "cpu")
        _kernels.LAUNCHES.reset()
        model.fit([x.numpy() for x in xs], y.numpy(), batch_size=3,
                  nb_epoch=1)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES.snapshot() == {
            ta.KERNEL_NAME: 2, ta.DQ_KERNEL_NAME: 2, ta.DKV_KERNEL_NAME: 2,
            tdln.FWD_KERNEL_NAME: 4, tdln.BWD_KERNEL_NAME: 4}
        assert np.isfinite(model.trainer.step_losses).all()
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            if name.endswith("qkv_w"):
                assert p.grad.abs().max() > 0, name
    finally:
        tnn.set_nncontext(None)
