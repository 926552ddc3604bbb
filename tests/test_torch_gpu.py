"""The hand-written CUDA kernels against their plain versions, on the card,
and the paths without one (the recurrent layers, Seq2seq's ``infer``)
against the CPU.

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

import copy
import gc
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
    # the allocator's statistics calls (reset_peak_memory_stats) do not
    # initialise CUDA themselves: a test that starts a run with one fails
    torch.cuda.init()
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


def test_bert_bf16_fit_runs_every_training_kernel_in_bf16(cuda):
    """Model.fit under ``set_compute_dtype("bfloat16")`` with dropout on,
    one step on int32 ids: every training kernel runs once a block (the
    dropout+add+LN pair twice) and every launch is given bf16 tensors;
    the parameters, their gradients and Adam's moments stay float32."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        l = 128
        model = _small_classifier(l, 128, 0.1, seed=1)
        model.compile(optimizer="adam",
                      loss="sparse_categorical_crossentropy")
        model.set_compute_dtype("bfloat16")
        xs, y, _ = _small_batch(l, "cpu")
        xs = [x.int().numpy() for x in xs[:3]] + [xs[3].numpy()]
        _kernels.LAUNCHES.reset()
        model.fit(xs, y.numpy(), batch_size=3, nb_epoch=1)
        torch.cuda.synchronize()
        expected = {ta.KERNEL_NAME: 2, ta.DQ_KERNEL_NAME: 2,
                    ta.DKV_KERNEL_NAME: 2, tdln.FWD_KERNEL_NAME: 4,
                    tdln.BWD_KERNEL_NAME: 4}
        assert _kernels.LAUNCHES.snapshot() == expected
        assert _kernels.LAUNCHES.by_dtype() == {
            k: {"bfloat16": n} for k, n in expected.items()}
        assert np.isfinite(model.trainer.step_losses).all()
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32, name
            assert p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
        moments = model.trainer.opt_state[0]
        assert all(t.dtype == torch.float32 for part in ("mu", "nu")
                   for t in moments[part].values())
    finally:
        tnn.set_nncontext(None)


def test_neuralcf_predict_on_the_card_matches_the_cpu(cuda):
    """bench.py's NeuralCF (weights from a seed): ``predict`` on the card
    against the same weights on the CPU, within 1e-5 (float32 products
    of at most 60 terms summed in another order)."""
    import copy

    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        ncf = NeuralCF(6040, 3706, 5, user_embed=20, item_embed=20,
                       hidden_layers=[40, 20, 10], include_mf=True,
                       mf_embed=20)
        cpu_model = copy.deepcopy(ncf.model)
        rs = np.random.default_rng(0)
        x = np.stack([rs.integers(1, 6041, 3000), rs.integers(1, 3707, 3000)],
                     1).astype(np.float32)
        got = ncf.predict(x, batch_size=1024)
        cpu = SPMDTrainer(cpu_model, get_loss("mse"), get_optimizer("sgd"),
                          device="cpu")
        want = cpu.predict(x, batch_size=1024)
        assert got.shape == (3000, 5)
        assert np.abs(got - want).max() <= 1e-5
        assert next(ncf.model.parameters()).device.type == "cuda"
    finally:
        tnn.set_nncontext(None)


def test_embedding_out_of_range_id_gives_a_nan_row_on_the_card(cuda):
    """An id outside [-n, n) gives a NaN row on the card, with no
    device-side assert; the others select their rows."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Embedding

    layer = Embedding(10, 4)
    layer.build_params(torch.Generator().manual_seed(0), (None, 3))
    layer.to(cuda)
    ids = torch.tensor([[1.0, 10.0, -11.0], [9.0, -1.0, 1e6]], device=cuda)
    out = layer(ids)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(out).all(-1).cpu()
    assert nan_rows.tolist() == [[False, True, True], [False, False, True]]
    table = layer.table.detach()
    assert torch.equal(out[0, 0], table[1]) and \
        torch.equal(out[1, 0], table[9]) and torch.equal(out[1, 1], table[9])


def _small_decoder(seed):
    """A causal TransformerLayer (head dim 64) with seeded weights."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        TransformerLayer

    layer = TransformerLayer(n_block=2, hidden_size=128, n_head=2, vocab=97,
                             seq_len=128)
    layer.build_params(torch.Generator().manual_seed(seed), (None, 128))
    return layer.eval()


def test_prefill_on_the_card_matches_the_cpu(cuda):
    """``prefill`` of a ragged batch on the card (the flash forward kernel,
    causal with the -1e9 padding bias, one launch a block) against the
    same weights on the CPU: logits within 1e-4, slabs within 1e-5."""
    import copy

    layer = _small_decoder(0)
    cpu_layer = copy.deepcopy(layer)
    layer.to(cuda)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, 97, (3, 77), generator=gen)
    lengths = torch.tensor([77, 30, 5], dtype=torch.int32)
    want, want_state = cpu_layer.prefill(tokens, lengths,
                                         cpu_layer.init_decode_state(3, 128))
    _kernels.LAUNCHES.reset()
    got, state = layer.prefill(tokens.to(cuda), lengths.to(cuda),
                               layer.init_decode_state(3, 128))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES.snapshot() == {ta.KERNEL_NAME: 2}
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    for a, b in zip(state.k_cache + state.v_cache,
                    want_state.k_cache + want_state.v_cache):
        assert (a.cpu() - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kv_dtype", [torch.float32, "int8"])
def test_decode_chunk_matches_decode_step_on_the_card(cuda, kv_dtype):
    """C tokens through one ``decode_chunk`` against C ``decode_step``
    calls from the same cached state, on the card: logits within 1e-4 and
    the same greedy tokens; and neither runs an (S, S) contraction."""
    from analytics_zoo_tpu_torch.ops import kv_cache

    layer = _small_decoder(2).to(cuda)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, 97, (4, 40), generator=gen).to(cuda)
    lengths = torch.tensor([40, 12, 33, 1], dtype=torch.int32).to(cuda)
    _, state = layer.prefill(tokens, lengths,
                             layer.init_decode_state(4, 128, dtype=kv_dtype))
    feed = torch.randint(1, 97, (4, 6), generator=gen).to(cuda)
    assert kv_cache.decode_step_is_cached(layer.decode_step, state.clone(),
                                          feed[:, 0], capacity=128)
    assert kv_cache.decode_step_is_cached(layer.decode_chunk, state.clone(),
                                          feed, capacity=128)
    chunk, _ = layer.decode_chunk(state.clone(), feed)
    for c in range(feed.shape[1]):
        step, state = layer.decode_step(state, feed[:, c])
        assert (step - chunk[:, c]).abs().max().item() <= 1e-4
        assert torch.equal(step.argmax(-1), chunk[:, c].argmax(-1))


def _moving_decoder(n_block, seed):
    """A small causal TransformerLayer whose greedy streams move (the
    layer's own 0.02 init makes a tied-embedding model repeat its input
    token): embeddings N(0, 0.3), matrices N(0, 2/sqrt(fan_in)), LN gains
    1 + N(0, 0.1), biases N(0, 0.1)."""
    layer = _small_decoder(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 2:
                p.copy_(noise * (0.3 if "emb" in name
                                 else 2.0 / math.sqrt(p.shape[0])))
            elif name.endswith("_g"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)
    if n_block == layer.n_block:
        return layer
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        TransformerLayer

    draft = TransformerLayer(n_block=n_block, hidden_size=128, n_head=2,
                             vocab=97, seq_len=128)
    draft.build_params(torch.Generator().manual_seed(seed), (None, 128))
    weights = layer.state_dict()
    draft.load_state_dict({k: weights[k] for k in draft.state_dict()})
    return draft.eval()


def test_fast_path_streams_equal_plain_on_the_card(cuda):
    """On the card, with weights whose greedy streams move: chunked joins
    and a speculative engine with a 1-block draft (so some drafts are
    rejected and rolled back) give the plain engine's greedy streams."""
    import time

    import numpy as np

    from analytics_zoo_tpu_torch.serving import generation as tgen

    def drive(engine, **kw):
        out = {}
        sched = tgen.ContinuousBatchScheduler(
            engine, lambda uri, p: out.__setitem__(uri, p), max_slots=3,
            **kw)
        rs = np.random.RandomState(7)
        for i, n in enumerate((5, 40, 90, 17)):
            sched.submit(tgen.GenRequest(uri=f"r{i}",
                                         prompt=rs.randint(1, 97, size=n),
                                         max_new_tokens=12))
        sched.start()
        t0 = time.perf_counter()
        while len(out) < 4 and time.perf_counter() - t0 < 120:
            time.sleep(0.01)
        sched.stop(drain=True, timeout=120)
        return {u: p["tokens"] for u, p in out.items()}

    target = _moving_decoder(2, 4)
    plain = drive(tgen.TransformerDecodeEngine(target, device=cuda))
    assert len(plain) == 4 and len(set(plain["r2"])) > 1
    assert drive(tgen.TransformerDecodeEngine(target, device=cuda),
                 prefill_chunk=16) == plain
    spec = tgen.SpeculativeDecodeEngine(
        tgen.TransformerDecodeEngine(target, device=cuda),
        tgen.TransformerDecodeEngine(_moving_decoder(1, 4), device=cuda),
        k=3)
    assert drive(spec) == plain
    assert 0.0 < spec.acceptance_rate < 1.0


# ---------------------------------------------------------------------------
# the image slice: convolution, pooling and BatchNorm on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer_name", ["MaxPooling2D", "AveragePooling2D"])
@pytest.mark.parametrize("size", [112, 113])
def test_same_pooling_at_stride_2_on_the_card_matches_the_cpu(cuda,
                                                              layer_name,
                                                              size):
    """ResNet-50's stem pool, (3, 3) at stride 2 with XLA's "SAME" pads
    ((0, 1) on 112, (1, 1) on 113), on the card against the CPU: max
    pooling exactly, the unpadded-count average within 1e-6."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    layer = getattr(tl, layer_name)((3, 3), strides=(2, 2),
                                    border_mode="same")
    x = torch.randn(2, 8, size, size,
                    generator=torch.Generator().manual_seed(size))
    want = layer(x)
    got = layer(x.to(cuda)).cpu()
    assert got.shape == want.shape == (2, 8, (size + 1) // 2,
                                       (size + 1) // 2)
    assert (got - want).abs().max().item() <= \
        (0.0 if layer_name == "MaxPooling2D" else 1e-6)


@pytest.mark.parametrize("memory", ["nchw", "channels_last"])
@pytest.mark.parametrize("shape", [(2, 512, 7, 7), (2, 64, 56, 56)])
def test_batch_norm_bf16_parameter_gradients_on_the_card_match_float64(
        cuda, memory, shape):
    """``batch_norm_train`` on bf16 activations with float32 gamma and
    beta: dgamma and dbeta within 1e-5 of their float64 values (the
    float32 sums' accuracy), dx and y within a bf16 rounding (1e-2), in
    NCHW memory as in channels-last. PyTorch's fused backward on NCHW
    bf16 rounds dgamma and dbeta through bf16; the op runs on the
    channel-innermost view, which does not."""
    from analytics_zoo_tpu_torch.ops.batchnorm import batch_norm_train

    gen = torch.Generator().manual_seed(shape[1])
    x = (2 * torch.randn(shape, generator=gen) + 0.5).bfloat16()
    # constant over each image's positions, as global pooling's gradient
    dy = (torch.randn(shape[:2] + (1, 1), generator=gen) *
          (torch.rand(shape, generator=gen) > 0.5)).bfloat16()
    gamma = torch.rand(shape[1], generator=gen) + 0.5
    beta = torch.randn(shape[1], generator=gen)

    def run(device, dtype, fmt):
        wide = torch.promote_types(dtype, torch.float32)
        xd = x.to(device=device, dtype=dtype).contiguous(
            memory_format=fmt).requires_grad_(True)
        g, b = (t.to(device=device, dtype=wide).requires_grad_(True)
                for t in (gamma, beta))
        y, _, _ = batch_norm_train(xd, g, b, 1, 1e-3)
        y.backward(dy.to(device=device, dtype=dtype).contiguous(
            memory_format=fmt))
        return [t.detach().double().cpu()
                for t in (y, xd.grad, g.grad, b.grad)]

    fmt = torch.channels_last if memory == "channels_last" else \
        torch.contiguous_format
    want = run("cpu", torch.float64, torch.contiguous_format)
    got = run(cuda, torch.bfloat16, fmt)
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    assert rel[0] <= 1e-2 and rel[1] <= 1e-2, rel
    assert rel[2] <= 1e-5 and rel[3] <= 1e-5, rel


def _draw_branch_gammas(model, seed):
    """The gamma of the last BatchNorm of every bottleneck branch drawn
    from U(0.1, 0.25): every convolution and BatchNorm in a branch then
    carries a gradient."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for node in model.graph_function().nodes:
            if isinstance(node.layer, tl.Add):
                gamma = node.inputs[0].node.layer.gamma
                gamma.copy_(0.1 + 0.15 * torch.rand(gamma.shape,
                                                    generator=gen))


def test_resnet50_predict_and_train_step_on_the_card_match_the_cpu(cuda):
    """ResNet-50 at 3x64x64 (weights from a seed, random moving
    statistics): ``predict`` on the card against the CPU within 1e-5
    (float32 softmax rows; cuDNN's convolutions sum in another order);
    then one SGD ``train_step`` on 4 images with the residual branches'
    last gammas drawn from U(0.1, 0.25): loss within 1e-5, the moving
    statistics within 1e-5, no launch of the five hand-written kernels,
    and every layer's output, input gradients and parameter gradients,
    recorded on the card and recomputed on the CPU from the card's own
    inputs (``utils/layer_parity.py``), within 1e-4 of the CPU's norm,
    with a nonzero CPU gradient on each of the 53 convolution kernels.
    The whole model's gradients are not compared: a rounding-sized change
    of this step's input moves them by up to 1.7e-2 of a tensor's norm,
    as ReLU masks near zero flip (tools/resnet_grad_conditioning.py). The CPU models are second builds whose weights
    and statistics are copied in order (``copy.deepcopy`` recurses once
    a graph node deep, too deep for ResNet-50's graph)."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
    from analytics_zoo_tpu_torch.utils.layer_parity import (LayerRecorder,
                                                            compare_layers)

    def cpu_twin(model):
        twin = ImageClassifier(class_num=10, model_name="resnet-50",
                               input_shape=(3, 64, 64)).model
        with torch.no_grad():
            for mine, theirs in ((twin.parameters(), model.parameters()),
                                 (twin.buffers(), model.buffers())):
                for a, b in zip(mine, theirs):
                    a.copy_(b)
        return twin

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        clf = ImageClassifier(class_num=10, model_name="resnet-50",
                              input_shape=(3, 64, 64))
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, b in clf.model.named_buffers():
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5
                        if name.endswith("moving_var") else
                        0.2 * torch.randn(b.shape, generator=gen))
        rs = np.random.default_rng(0)
        x = rs.standard_normal((6, 3, 64, 64)).astype(np.float32)
        y = rs.integers(0, 10, 4).astype(np.int32)
        cpu_model = cpu_twin(clf.model)
        got = clf.predict(x, batch_size=4)
        loss = get_loss("sparse_categorical_crossentropy")
        cpu = SPMDTrainer(cpu_model, loss, get_optimizer("sgd"),
                          device="cpu")
        assert np.abs(got - cpu.predict(x, batch_size=4)).max() <= 1e-5
        _draw_branch_gammas(clf.model, 2)
        _draw_branch_gammas(cpu_model, 2)
        reference = cpu_twin(cpu_model)
        gpu = SPMDTrainer(clf.model, loss, get_optimizer("sgd"), device=cuda)
        for t in (gpu, cpu):
            t.ensure_initialized()
        batch = ([x[:4]], y, np.ones(4, np.float32))
        _kernels.LAUNCHES.reset()
        with LayerRecorder(clf.model) as recorder:
            got_loss = gpu.train_step(gpu.put_batch(batch)).item()
        assert _kernels.LAUNCHES.snapshot() == {}
        want_loss = cpu.train_step(cpu.put_batch(batch)).item()
        assert abs(got_loss - want_loss) <= 1e-5
        for (name, b), c in zip(clf.model.named_buffers(),
                                cpu_model.buffers()):
            assert b.dtype == torch.float32
            assert (b.cpu() - c).abs().max() <= 1e-5, name
        for name, p in clf.model.named_parameters():
            assert torch.isfinite(p.grad).all(), name
        layers = compare_layers(recorder, reference)
        assert len(layers) == len(recorder.layers)
        convs = [n for n in layers if n.startswith("convolution2d")]
        assert len(convs) == 53
        assert all(layers[n]["ref_norm"]["kernel"] > 0 for n in convs)
        for name, r in layers.items():
            errs = [r["y"]] + [d for d in r["dx"] if d is not None] + \
                [r[k] for k in r["ref_norm"]]
            assert max(errs) <= 1e-4, (name, r)
    finally:
        tnn.set_nncontext(None)


# ---------------------------------------------------------------------------
# the checkpoint store on the card
# ---------------------------------------------------------------------------

def _small_trainer(device, tmp_path, async_checkpoint=False):
    """A Dense + BatchNorm model under Adam on ``device``, 3 steps in."""
    import numpy as np
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer

    tnn.set_nncontext(tnn.ZooContext(tnn.ZooConfig(
        async_checkpoint=async_checkpoint), device=device))
    model = Sequential(seed=3)
    model.add(tl.Dense(32, input_shape=(16,), name="ck_d1"))
    model.add(tl.BatchNormalization(name="ck_bn"))
    model.add(tl.Activation("relu", name="ck_relu"))
    model.add(tl.Dense(4, name="ck_d2"))
    model.graph_function()
    trainer = SPMDTrainer(model, get_loss("mse"), Adam(lr=1e-2))
    trainer.checkpoint_dir = str(tmp_path)
    rs = np.random.default_rng(0)
    batch = trainer.put_batch(([rs.standard_normal((8, 16)).astype(
        np.float32)], rs.standard_normal((8, 4)).astype(np.float32),
        np.ones(8, np.float32)))
    trainer.ensure_initialized()
    for _ in range(3):
        trainer.train_step(batch)
    return trainer, batch


def _device_state(trainer):
    from analytics_zoo_tpu_torch.utils.jax_weights import (optimizer_leaves,
                                                           param_order)
    tensors = list(trainer.model.parameters()) + \
        list(trainer.model.buffers()) + \
        [l for l in optimizer_leaves(trainer.opt_state,
                                     param_order(trainer.model))
         if torch.is_tensor(l)]
    return [t.detach().clone() for t in tensors]


def test_a_checkpoint_restores_a_cuda_trainer_bit_for_bit(cuda, tmp_path):
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    try:
        trainer, batch = _small_trainer(cuda, tmp_path)
        want = _device_state(trainer)
        trainer.save_checkpoint()
        fresh, _ = _small_trainer(cuda, tmp_path / "other")
        for _ in range(2):
            fresh.train_step(batch)
        fresh.load_checkpoint(str(tmp_path))
        got = _device_state(fresh)
        assert fresh.step == 3 and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and torch.equal(g, w)
        assert fresh.opt_state[0]["count"] == 3
    finally:
        tnn.set_nncontext(None)


def test_an_async_save_then_a_step_keeps_the_saved_state(cuda, tmp_path):
    """The snapshot is complete before ``save_checkpoint`` returns: the
    step launched right after it changes the parameters in place, and the
    files hold the state from before that step."""
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    try:
        trainer, batch = _small_trainer(cuda, tmp_path,
                                        async_checkpoint=True)
        want = _device_state(trainer)
        trainer.save_checkpoint()
        trainer.train_step(batch)
        trainer.wait_for_checkpoint()
        assert not torch.equal(_device_state(trainer)[0], want[0])
        fresh, _ = _small_trainer(cuda, tmp_path / "other")
        fresh.load_checkpoint(str(tmp_path))
        for g, w in zip(_device_state(fresh), want):
            assert torch.equal(g, w)
    finally:
        tnn.set_nncontext(None)


def test_native_crc32c_equals_the_reference_on_64_mb(cuda):
    from analytics_zoo_tpu_torch.utils.crc32c import (crc32c,
                                                      crc32c_reference)
    data = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0)).numpy()
    assert crc32c(data) == crc32c_reference(data.tobytes())


# -- the recurrent layers and Seq2seq (no hand-written kernel) --------------

RNN_TOL = (1e-4, 1e-4)


@pytest.mark.parametrize("layer_name", ["LSTM", "GRU", "Bidirectional"])
def test_recurrent_layer_on_the_card_matches_the_cpu(cuda, layer_name):
    """Forward and backward at B=32, T=128, H=256 against the same
    layer's CPU run (float32, TF32 off): the output and every gradient
    within 1e-4 of the CPU's max plus 1e-4 relative, a T-step recurrence
    of matmuls summed in another order by cuBLAS. No hand-written kernel
    launches."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    make = {"LSTM": lambda: tl.LSTM(256, return_sequences=True),
            "GRU": lambda: tl.GRU(256, go_backwards=True),
            "Bidirectional": lambda: tl.Bidirectional(
                tl.LSTM(256, return_sequences=True))}[layer_name]
    cpu = make()
    cpu.build_params(torch.Generator().manual_seed(0), (None, 128, 64))
    card = make()
    card.build_params(torch.Generator().manual_seed(0), (None, 128, 64))
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(32, 128, 64, generator=gen)
    runs = {}
    _kernels.LAUNCHES.reset()
    for name, layer, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        xi = x.to(dev).clone().requires_grad_()
        out = layer(xi)
        ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
        (out * ct.to(dev)).sum().backward()
        runs[name] = [out.detach(), xi.grad] + \
            [p.grad for _, p in layer.named_parameters()]
    assert not _kernels.LAUNCHES.snapshot()
    for got, want in zip(runs["card"], runs["cpu"]):
        _close(got.cpu(), want, RNN_TOL)


def test_seq2seq_infer_on_the_card_matches_the_cpu(cuda):
    """``Seq2seq.infer`` on the card (LSTM, 2 layers, hidden 256, a dense
    bridge, a TimeDistributed generator) against the same model's CPU
    ``infer`` within 1e-4; then a stop sign from the card's own stream
    freezes its row there and leaves the other rows as they were."""
    import copy

    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.models.seq2seq import (Bridge, RNNDecoder,
                                                        RNNEncoder, Seq2seq)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer

    tnn.set_nncontext(None)
    try:
        tnn.init_nncontext()
        model = Seq2seq(RNNEncoder.initialize("lstm", 2, 256),
                        RNNDecoder.initialize("lstm", 2, 256), [20, 32],
                        [1, 32], bridge=Bridge("dense", 256),
                        generator=tl.TimeDistributed(tl.Dense(32)))
        rs = np.random.default_rng(3)
        x = rs.standard_normal((4, 20, 32)).astype(np.float32)
        start = rs.standard_normal(32).astype(np.float32)
        twin = copy.deepcopy(model)
        twin.model.trainer = SPMDTrainer(
            twin.model, get_loss("mse"), get_optimizer("sgd"), device="cpu")
        want = twin.infer(x, start, max_seq_len=12)
        got = model.infer(x, start, max_seq_len=12)
        assert next(model.model.parameters()).is_cuda
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        stop = got[0, 5]
        stopped = model.infer(x, start, max_seq_len=12, stop_sign=stop)
        assert stopped.shape == got.shape
        np.testing.assert_array_equal(stopped[0, 5:],
                                      np.repeat(stop[None], 8, axis=0))
        np.testing.assert_array_equal(stopped[1:], got[1:])
    finally:
        tnn.set_nncontext(None)


def _serve_on(device, model, records, generate_layer=None, **params):
    """Queue ``records`` ({uri: image}, then {uri: prompt} for generate),
    serve them with the port's pipelined ClusterServing on ``device`` and
    return (results, the server)."""
    import numpy as np

    from analytics_zoo_tpu_torch import serving as ts
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    backend = ts.InProcessStreamQueue()
    iq = ts.InputQueue(backend=backend)
    images, prompts = records
    for uri, x in images.items():
        iq.enqueue(uri, t=x)
    for uri, p in prompts.items():
        iq.enqueue_generate(uri, np.asarray(p))
    helper = ts.ClusterServingHelper(config={
        "data": {"image_shape": "3, 16, 16"},
        "params": {"batch_size": 4, "top_n": 0, **params},
        "generate": {"slots": 2, "max_len": 128, "max_new_tokens": 5}})
    tnn.set_nncontext(None)
    try:
        tnn.init_nncontext()
        im = InferenceModel().load_keras_net(model, device=device)
        server = ts.ClusterServing(model=im, helper=helper, backend=backend)
        if generate_layer is not None:
            server.build_transformer_engine(generate_layer)
        server.start()
        try:
            got = ts.OutputQueue(backend=backend).wait_all(
                list(images) + list(prompts), timeout=120)
        finally:
            server.stop()
    finally:
        tnn.set_nncontext(None)
    return got, server


def _serving_cnn():
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras import models as tm

    seq = tm.Sequential()
    seq.add(tl.Convolution2D(4, 3, 3, activation="relu",
                             input_shape=(3, 16, 16)))
    seq.add(tl.Flatten())
    seq.add(tl.Dense(10, activation="softmax"))
    return seq


def test_cluster_serving_on_the_card_copies_through_pinned_memory(cuda):
    """The pipelined loop on the card: each batch's outputs come back
    through a ``HostCopy`` (pinned memory, a CUDA event), the rows equal
    the same model's CPU ``predict`` within 1e-5, and a bf16 output comes
    back as float32."""
    import copy

    import numpy as np

    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        HostCopy

    model = _serving_cnn()
    cpu_model = copy.deepcopy(model)
    rs = np.random.default_rng(0)
    images = {f"r{i}": rs.standard_normal((3, 16, 16)).astype(np.float32)
              for i in range(11)}
    got, server = _serve_on(cuda, model, (images, {}))
    want = cpu_model.predict(np.stack(list(images.values())), batch_size=16)
    for i, uri in enumerate(images):
        assert np.abs(np.asarray(got[uri]) - want[i]).max() <= 1e-5
    stats = server.pipeline_stats()
    assert stats["results_out"] == 11 and stats["dropped"] == 0
    out = torch.randn(4, 10, device=cuda, dtype=torch.bfloat16)
    copy_ = HostCopy([out, out.float()])
    assert copy_._event is not None and copy_._host[0].is_pinned()
    a, b = copy_.wait()
    assert a.dtype == np.float32 and np.array_equal(a, b)


def test_cluster_serving_generate_on_the_card_launches_k1_a_prefill(cuda):
    """Generate records through the loop on the card: K1 is launched once
    a block for every prefill the engine counted and the other kernels
    never; the streams equal ``decode_step``'s greedy stream."""
    import numpy as np

    layer = _small_decoder(0)
    rs = np.random.default_rng(1)
    prompts = {f"g{i}": rs.integers(1, 97, size=int(n))
               for i, n in enumerate((5, 40, 77))}
    _kernels.LAUNCHES.reset()
    got, server = _serve_on(cuda, _serving_cnn(), ({}, prompts),
                            generate_layer=layer)
    launches = _kernels.LAUNCHES.snapshot()
    calls = server._gen_engine.prefill_calls
    assert calls >= 1
    assert launches == {ta.KERNEL_NAME: 2 * calls}
    for uri, prompt in prompts.items():
        state = layer.init_decode_state(1, 128)
        logits, state = layer.prefill(
            torch.as_tensor(prompt[None], device=cuda),
            torch.tensor([prompt.size], device=cuda), state)
        want = []
        for _ in range(5):
            want.append(int(torch.argmax(logits[0])))
            logits, state = layer.decode_step(
                state, torch.tensor([want[-1]], device=cuda))
        assert [int(t) for t in np.asarray(got[uri])] == want, uri


# ---------------------------------------------------------------------------
# int8 inference: torch._int_mm on the card against the CPU's plain version
# ---------------------------------------------------------------------------

def _int8_pair(rs_seed, kshape, act_scale, requant_scale=None):
    from analytics_zoo_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(rs_seed)
    w = torch.randn(kshape, generator=g) * 0.2
    qt = quant.quantize_weight(w, "k").with_act_scale(act_scale)
    if requant_scale is not None:
        qt = qt.with_requant(quant.chain_requant(act_scale, qt.scale,
                                                 requant_scale))
    return qt


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 64])
@pytest.mark.parametrize("k,n", [(147, 64), (512, 1000), (24, 12)])
def test_int8_matmul_on_the_card_equals_the_cpu(cuda, rows, k, n):
    """Rows below ``torch._int_mm``'s 17, an inner size of 147 (ResNet-50's
    stem) and an output of 12 are padded to its rules: the int32
    products, int8 requantized outputs and float outputs equal the CPU's
    int32 matmul (float within 1e-6 relative)."""
    from analytics_zoo_tpu_torch.ops import quant
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine.base import \
        NamedActivation

    g = torch.Generator().manual_seed(rows + k)
    x = torch.randn(rows, k, generator=g)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    qt = _int8_pair(k, (k, n), 0.02, 0.5)
    want = quant.int_product(a, qt)
    got = quant.int_product(a.to(cuda), qt.to(cuda))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    bias = torch.randn(n, generator=g)
    relu = NamedActivation("relu")
    for w in (qt, qt.with_requant(None)):
        want = quant.matmul(x, w, bias, relu)
        got = quant.matmul(x.to(cuda), w.to(cuda), bias.to(cuda), relu)
        if want.dtype == torch.int8:
            assert torch.equal(got.cpu(), want)
        else:
            _close(got.cpu(), want, (1e-6, 1e-6))


@pytest.mark.parametrize("case", [
    ((2, 3, 32, 32), (7, 7, 3, 64), (2, 2), "SAME"),     # k = 147
    ((4, 64, 14, 14), (3, 3, 64, 128), (1, 1), "SAME"),
    ((1, 16, 9, 9), (1, 1, 16, 24), (2, 2), "VALID"),
])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_int8_conv2d_on_the_card_equals_the_cpu(cuda, case, layout):
    from analytics_zoo_tpu_torch.ops import quant

    xshape, kshape, strides, padding = case
    g = torch.Generator().manual_seed(sum(xshape))
    x = torch.randn(xshape, generator=g)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    dn = (layout, "HWIO", layout)
    qt = _int8_pair(7, kshape, float(x.abs().max()) / 127, 0.3)
    xq = quant._quantize_act(x, qt.act_scale)
    want = quant._conv_int8(xq, qt, strides, padding, None, dn)
    got = quant._conv_int8(xq.to(cuda), qt.to(cuda), strides, padding,
                           None, dn)
    assert torch.equal(got.cpu(), want)
    bias = torch.randn(kshape[-1], generator=g)
    for w in (qt, qt.with_requant(None)):
        want = quant.conv2d(x, w, strides, padding, None, dn, bias)
        got = quant.conv2d(x.to(cuda), w.to(cuda), strides, padding, None,
                           dn, bias.to(cuda))
        if want.dtype == torch.int8:
            assert torch.equal(got.cpu(), want)
        else:
            _close(got.cpu(), want, (1e-6, 1e-6))


@pytest.mark.parametrize("border_mode", ["valid", "same"])
def test_int8_max_pooling_on_the_card_equals_the_cpu(cuda, border_mode):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        MaxPooling2D

    x = torch.randint(-128, 128, (2, 8, 9, 9), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1))
    layer = MaxPooling2D((3, 3), strides=(2, 2), border_mode=border_mode)
    want = layer(x)
    got = layer(x.to(cuda))
    assert got.dtype == torch.int8 and torch.equal(got.cpu(), want)


def test_chained_cnn_predict_on_the_card_equals_the_cpu(cuda):
    """A calibrated, fully chained CNN: the card's int8 predict equals
    the CPU's run with the same scales, one division and one int32
    product per kernel."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
        Sequential
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.utils.op_census import OpCensus

    def build():
        m = Sequential(seed=3)
        m.add(L.Convolution2D(16, 3, 3, activation="relu",
                              border_mode="same", input_shape=(3, 32, 32),
                              name="c1"))
        m.add(L.MaxPooling2D((2, 2), name="mp"))
        m.add(L.Convolution2D(16, 3, 3, activation="relu", name="c2"))
        m.add(L.Flatten(name="fl"))
        m.add(L.Dense(32, activation="relu", name="d1"))
        m.add(L.Dense(10, activation="softmax", name="out"))
        return m

    g = torch.Generator().manual_seed(4)
    calib = [torch.randn(8, 3, 32, 32, generator=g).numpy()
             for _ in range(3)]
    x = torch.randn(4, 3, 32, 32, generator=g).numpy()
    cpu = InferenceModel().load_keras_net(build(), device="cpu",
                                          calibration=calib)
    card = InferenceModel().load_keras_net(
        build(), device=cuda, scales=cpu.model.export_calibration())
    assert card.model.chains == cpu.model.chains == [
        ("c1", "c2"), ("c2", "d1"), ("d1", "out")]
    with OpCensus() as census:
        got = card.predict(x)
    s = census.int8_summary()
    assert (s["int32_products"], s["float_products"], s["divisions"]) == \
        (4, 0, 1), s
    _close(torch.from_numpy(got), torch.from_numpy(cpu.predict(x)),
           (1e-6, 1e-6))


# ---------------------------------------------------------------------------
# training observability on the card: the health monitor, the memory
# accountant, the FLOP count and OOM forensics
# ---------------------------------------------------------------------------

_OBS_L, _OBS_HID, _OBS_VOCAB, _OBS_BATCH = 32, 64, 100, 4
_OBS_TAGS = {"Loss", "LearningRate", "Throughput", "StepTimeMs",
             "HealthState", "HBMTotalMB", "HBMParamsMB", "HBMOptStateMB",
             "HBMActivationsMB", "HBMTransfersMB", "InfeedWaitMs",
             "InputBoundFraction", "MFU"}


def _obs_context(device, **cfg):
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig(**cfg), device=device)


def _obs_classifier():
    """bench.py's classifier at 2 blocks of 64 (one head, d = 64), seq 32,
    dropout 0.1 (so every kernel runs), bf16, Adam."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    bert = tl.BERT(vocab=_OBS_VOCAB, hidden_size=_OBS_HID, n_block=2,
                   n_head=1, seq_len=_OBS_L, intermediate_size=4 * _OBS_HID,
                   hidden_p_drop=0.1, attn_p_drop=0.1,
                   output_all_block=False, name="obs_bert")
    ins = [tl.Input(shape=(_OBS_L,), name=n) for n in
           ("tokens", "positions", "segments")] + \
        [tl.Input(shape=(1, 1, _OBS_L), name="mask")]
    _, pooled = bert(ins)
    model = Model(ins, tl.Dense(2, activation="softmax",
                                name="obs_head")(pooled), seed=5)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    model.set_compute_dtype("bfloat16")
    return model


def _obs_data(n):
    import numpy as np
    rs = np.random.default_rng(0)
    lengths = rs.integers(8, _OBS_L + 1, size=n)
    pos = np.arange(_OBS_L)[None, :]
    y = rs.integers(0, 2, size=n)
    tokens = rs.integers(3, _OBS_VOCAB, size=(n, _OBS_L))
    tokens[:, 0] = 1 + y
    x = [tokens.astype(np.int32), np.repeat(pos.astype(np.int32), n, 0),
         (pos >= lengths[:, None] // 2).astype(np.int32),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, y.astype(np.float32)


def test_monitored_fit_on_the_card_writes_every_scalar(cuda, tmp_path,
                                                       monkeypatch):
    """8 monitored bf16 steps: every scalar at every window with the
    health state 0, the kernels launched, the parameters' bytes exact,
    saved activations <= the allocator's step peak <= its maximum, the
    FLOP count bench.py's formula (the CPU's count), the card's
    allocator read."""
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.utils import memory, telemetry
    monkeypatch.setenv("ZOO_TPU_PEAK_FLOPS", "989.4e12")
    try:
        _obs_context(cuda, log_every_n_steps=2, health_monitor=True,
                     memory_accounting=True)
        model = _obs_classifier()
        model.set_tensorboard(str(tmp_path), "obs")
        x, y = _obs_data(8 * _OBS_BATCH)
        # the accountant measures a step's peak only where the step raises
        # the allocator's high-water mark, which it never resets itself;
        # earlier tests' garbage (reference cycles holding card memory)
        # is collected first, so that its release inside the measured
        # window cannot keep this small step under the mark
        gc.collect()
        torch.cuda.reset_peak_memory_stats(cuda)
        _kernels.LAUNCHES.reset()
        model.fit(x, y, batch_size=_OBS_BATCH, nb_epoch=1)
        launches = _kernels.LAUNCHES.snapshot()
        assert launches[ta.KERNEL_NAME] == launches[ta.DQ_KERNEL_NAME] == \
            16 and launches[tdln.FWD_KERNEL_NAME] == 32
        tags = {}
        for s, _, t, v in model.get_train_summary():
            tags.setdefault(t, []).append((s, v))
        assert _OBS_TAGS <= set(tags)
        assert all([s for s, _ in tags[t]] == [2, 4, 6, 8]
                   for t in _OBS_TAGS)
        assert all(v == 0.0 for _, v in tags["HealthState"])
        bd = model.trainer.hbm_breakdown
        assert bd["params_bytes"] == sum(p.numel() * 4
                                         for p in model.parameters())
        assert 0 < bd["activations_temp_bytes"] <= bd["step_peak_bytes"]
        assert bd["total_bytes"] <= torch.cuda.max_memory_allocated(cuda) \
            <= torch.cuda.memory_reserved(cuda)
        tokens = _OBS_BATCH * _OBS_L
        h = _OBS_HID
        fwd = tokens * 2 * (24 * h * h + 4 * _OBS_L * h) + \
            _OBS_BATCH * 2 * h * h + _OBS_BATCH * 2 * h * 2
        assert model.trainer.flops_per_step == 3 * fwd
        snap = memory.poll_device_memory([cuda])
        assert snap is not None and snap["per_device"][0]["bytes_limit"] > 0
        assert telemetry.counter("zoo_train_steps_total").value >= 8
    finally:
        tnn.set_nncontext(None)


def test_step_accountant_leaves_the_callers_peak(cuda):
    """The accountant reads the allocator's peak and never resets it: a
    step under the caller's earlier high-water mark leaves that mark and
    reports its own peak as not measured; after the caller's reset the
    step raises the mark and its peak is measured."""
    from analytics_zoo_tpu_torch.utils import memory
    w = torch.randn(256, 256, device=cuda, requires_grad=True)
    big = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    del big
    mark = torch.cuda.max_memory_allocated(cuda)
    with memory.StepAccountant(cuda, exclude=[w]) as acc:
        torch.tanh(torch.randn(128, 256, device=cuda) @ w).sum().backward()
    assert torch.cuda.max_memory_allocated(cuda) == mark
    assert acc.step_peak_bytes is None and acc.saved_bytes > 0
    torch.cuda.reset_peak_memory_stats(cuda)
    with memory.StepAccountant(cuda, exclude=[w]) as acc:
        torch.tanh(torch.randn(128, 256, device=cuda) @ w).sum().backward()
    assert 0 < acc.saved_bytes <= acc.step_peak_bytes


def test_step_nan_on_the_card_halts_at_the_last_good_checkpoint(
        cuda, tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.common.zoo_trigger import SeveralIteration
    from analytics_zoo_tpu_torch.pipeline import engine
    from analytics_zoo_tpu_torch.utils import faults
    monkeypatch.setenv("ZOO_TPU_FAULT", "step:nan@3")
    faults.reset()
    try:
        _obs_context(cuda, log_every_n_steps=2, health_monitor=True,
                     health_halt=True, failure_retry_times=0)
        model = _obs_classifier()
        model.set_checkpoint(str(tmp_path), trigger=SeveralIteration(2))
        x, y = _obs_data(8 * _OBS_BATCH)
        with pytest.raises(engine.TrainingHalted):
            model.fit(x, y, batch_size=_OBS_BATCH, nb_epoch=1)
        assert model.trainer._health.halt_step == 3
        assert (tmp_path / "latest").read_text().strip() == "ckpt-2"
        assert not engine.preemption_requested()
    finally:
        faults.reset()
        tnn.set_nncontext(None)


def test_an_allocation_failure_on_the_card_writes_oom_forensics(cuda,
                                                                 tmp_path):
    import json
    from analytics_zoo_tpu_torch.utils import memory
    total = torch.cuda.mem_get_info(cuda)[1]
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    path = memory.maybe_oom_forensics(err.value, out_dir=str(tmp_path))
    with open(path) as f:
        dump = json.load(f)
    assert set(dump) == {"reason", "ts", "programs", "device_memory",
                         "hlo_tail"}
    assert dump["device_memory"]["per_device"][0]["num_ooms"] >= 1
    assert "cuda:0" in dump["hlo_tail"]


# ---------------------------------------------------------------------------
# the training path's pinned side-stream staging (pipeline/engine.py)
# ---------------------------------------------------------------------------

def _host_batch(rs, i, rows=64):
    """A host batch with float64 (staged as float32), int32 and uint8
    inputs, a list of targets and weights."""
    import numpy as np
    from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch
    return MiniBatch(
        (rs.standard_normal((rows, 3, 5)) + i,
         rs.integers(0, 1000, (rows, 7)).astype(np.int32),
         rs.integers(0, 256, (rows, 2, 2)).astype(np.uint8)),
        [np.full(rows, i, np.float32), np.arange(rows, dtype=np.int64)],
        np.ones(rows, np.float32))


def _assert_staged(dev, host):
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.engine import _batch_leaves
    for d, h in zip(_batch_leaves(dev), _batch_leaves(host), strict=True):
        h = np.asarray(h)
        want = h.astype(np.float32) if h.dtype == np.float64 else h
        assert d.device.type == "cuda"
        assert d.cpu().numpy().dtype == want.dtype
        np.testing.assert_array_equal(d.cpu().numpy(), want)


def test_pinned_staging_on_the_card_equals_the_host_arrays(cuda):
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.engine import (PinnedStager,
                                                         stack_host_batches)
    rs = np.random.default_rng(0)
    stager = PinnedStager(cuda, depth=2)
    hosts = [_host_batch(rs, i) for i in range(7)]
    staged = []
    for h in hosts:
        dev, event = stager.put(h)
        torch.cuda.current_stream(cuda).wait_event(event)
        staged.append(dev)
    dev, event = stager.put_stacked(hosts[:3])
    torch.cuda.current_stream(cuda).wait_event(event)
    torch.cuda.synchronize(cuda)
    for dev_b, h in zip(staged, hosts):
        _assert_staged(dev_b, h)
    _assert_staged(dev, stack_host_batches(hosts[:3]))
    # a ring of depth + 1 pinned buffers per leaf position (7 leaves),
    # plus the stacked chunk's reallocations
    assert stager.slots == 3
    assert all(b[0].is_pinned() for ring in stager._rings.values()
               for b in ring)
    assert stager.batches == 8


def test_a_pinned_buffer_is_refilled_only_after_its_copy(cuda):
    """The side stream is held behind a long sleep, so every copy is
    still queued when the next batches are staged. Without the wait on
    a buffer's last event, batch i + slots would overwrite batch i's
    pinned bytes before its copy ran, and batch i would arrive on the
    card holding batch i + slots's values."""
    import numpy as np
    from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch
    from analytics_zoo_tpu_torch.pipeline.engine import PinnedStager
    stager = PinnedStager(cuda, depth=1)            # 2 buffers a leaf
    with torch.cuda.stream(stager.stream):
        torch.cuda._sleep(int(2e8))                 # ~0.1 s of cycles
    hosts = [MiniBatch((np.full((256, 1024), i, np.float32),), None,
                       np.full(256, i, np.float32)) for i in range(6)]
    staged = [stager.put(h) for h in hosts]
    for (dev, event), i in zip(staged, range(6)):
        torch.cuda.current_stream(cuda).wait_event(event)
        assert torch.equal(dev[0][0], torch.full_like(dev[0][0], i)), i
        assert torch.equal(dev[2], torch.full_like(dev[2], i)), i


def test_fit_after_predict_on_the_card_refills_the_pinned_ring(cuda):
    """``predict`` stages its batches under inference mode; the pinned
    buffers it leaves in the trainer's ring are normal tensors, so a
    ``fit`` on batches of the same shapes refills them in place (an
    inference tensor would refuse the copy outside inference mode)."""
    import numpy as np
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        m = Sequential()
        m.add(Dense(8, input_shape=(16,)))
        m.compile(optimizer="sgd", loss="mse")
        rs = np.random.default_rng(2)
        x = rs.standard_normal((64, 16)).astype(np.float32)
        y = rs.standard_normal((64, 8)).astype(np.float32)
        m.predict(x, batch_size=32)
        m.fit(x, y, batch_size=32, nb_epoch=1)
        assert np.isfinite(m.trainer.step_losses).all()
        ring = [slot[0] for r in m.trainer._pinned._rings.values()
                for slot in r if slot[0] is not None]
        assert ring and not any(b.is_inference() for b in ring)
    finally:
        tnn.set_nncontext(None)


def test_fit_through_staging_equals_fit_from_device_tensors(cuda):
    """``fit`` (the host pipeline, pinned side-stream staging and the
    event wait) trains a float32 MLP to the same parameters, bit for bit,
    as ``train_step`` fed ``put_batch``'s plain copies of the same
    batches."""
    import numpy as np
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    def mlp():
        m = Sequential()
        m.add(Dense(256, activation="relu", input_shape=(64,)))
        m.add(Dense(1))
        m.compile(optimizer="sgd", loss="mse")
        return m

    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig(transform_workers=2), device=cuda)
    try:
        rs = np.random.default_rng(1)
        x = rs.standard_normal((512, 64)).astype(np.float32)
        y = rs.standard_normal((512, 1)).astype(np.float32)
        fs = FeatureSet.array(x, y)
        a, b = mlp(), mlp()
        with torch.no_grad():
            for p, q in zip(a.parameters(), b.parameters()):
                q.copy_(p)
        a.fit(fs, batch_size=32, nb_epoch=2)
        assert a.trainer._pinned is not None and \
            a.trainer._pinned.batches == 32
        tb = b._ensure_trainer()
        tb.ensure_initialized()
        for epoch in range(2):
            for batch in fs.batches(32, shuffle=True, seed=tb.seed + epoch):
                tb.train_step(tb.put_batch(batch))
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
        np.testing.assert_array_equal(a.predict(x, batch_size=96),
                                      b.predict(x, batch_size=96))
        # a trained model (its trainer and stager with it) deep-copies;
        # the copy stages through a stager of its own
        twin = copy.deepcopy(a)
        assert twin.trainer._pinned is not a.trainer._pinned
        np.testing.assert_array_equal(twin.predict(x, batch_size=96),
                                      a.predict(x, batch_size=96))
    finally:
        tnn.set_nncontext(None)


# -- object detection (SSD) on the card ---------------------------------------

def _ssd_preds(seed, b, n, c, device):
    """Head outputs without tied scores (the tie-breaking is held against
    JAX on the CPU: PyTorch's CPU softmax can round equal inputs apart by
    their vector lane) and one class below the threshold."""
    gen = torch.Generator().manual_seed(seed)
    loc = torch.randn((b, n, 4), generator=gen) * 0.5
    logits = torch.randn((b, n, c), generator=gen) * 2.0
    logits[..., c - 1] = -30.0
    return torch.cat([loc, logits], -1).to(device)


@pytest.mark.parametrize("num_classes,top_k", [(21, 100), (4, 12)])
def test_detection_output_on_the_card_equals_the_cpu(cuda, num_classes,
                                                     top_k):
    """``detection_output`` (softmax, decode, batched NMS, stable top-k)
    on the card: the labels equal the CPU's, scores and boxes within
    1e-5 (the card's exp and softmax round differently)."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import ssd
    priors = torch.from_numpy(ssd.generate_priors())
    preds = _ssd_preds(3, 4, len(priors), num_classes, "cpu")
    want = ssd.detection_output(preds, priors, num_classes, 0.05, 0.45,
                                top_k)
    got = ssd.detection_output(preds.cuda(), priors.cuda(), num_classes,
                               0.05, 0.45, top_k).cpu()
    assert got.shape == want.shape == (4, top_k, 6)
    assert torch.equal(got[..., 0], want[..., 0])
    real = torch.isfinite(want[..., 1])
    assert torch.equal(torch.isfinite(got[..., 1]), real)
    assert (got[..., 1:][real] - want[..., 1:][real]).abs().max() <= 1e-5


def test_multibox_loss_on_the_card_equals_the_cpu(cuda):
    from analytics_zoo_tpu_torch.models.image.objectdetection import ssd
    gen = torch.Generator().manual_seed(5)
    y_pred = torch.randn((3, 500, 25), generator=gen)
    y_true = torch.zeros((3, 500, 5))
    y_true[..., :4] = torch.randn((3, 500, 4), generator=gen)
    y_true[0, :10, 4] = torch.randint(1, 21, (10,), generator=gen).float()
    y_true[1, 100:160, 4] = 3.0
    loss = ssd.MultiBoxLoss(21)
    xc = y_pred.clone().requires_grad_(True)
    want = loss(xc, y_true)
    want.backward()
    xg = y_pred.cuda().requires_grad_(True)
    got = loss(xg, y_true.cuda())
    got.backward()
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    err = (xg.grad.cpu() - xc.grad).abs().max()
    assert err <= 1e-5 * xc.grad.abs().max()


def test_object_detector_on_the_card_equals_the_cpu(cuda):
    """A small ``ObjectDetector``'s head output on the card against a CPU
    twin of the same weights (TF32 off), within 1e-4 of its scale; its
    rows: every row whose score is 1e-4 clear of the others' carries the
    CPU row's label."""
    from analytics_zoo_tpu_torch.common import nncontext
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
    nncontext.set_nncontext(None)
    try:
        nncontext.init_nncontext()
        det = ObjectDetector(class_num=5, image_size=96, base_channels=8)
        twin = ObjectDetector(class_num=5, image_size=96, base_channels=8)
        with torch.no_grad():   # the same graph: copy in order
            for a, b in zip(twin.model.parameters(), det.model.parameters()):
                a.copy_(b)
            for a, b in zip(twin.model.buffers(), det.model.buffers()):
                a.copy_(b)
        twin.model.trainer = SPMDTrainer(twin.model, get_loss("mse"),
                                         get_optimizer("sgd"), device="cpu")
        x = torch.randn((3, 3, 96, 96),
                        generator=torch.Generator().manual_seed(2)).numpy()
        head = det.forward_device(x)
        assert head.is_cuda
        want = twin.forward_device(x)
        assert (head.cpu() - want).abs().max() <= 1e-4 * max(
            1.0, want.abs().max().item())
        rows, wrows = det.detect(x), twin.detect(x)
        assert rows.shape == wrows.shape == (3, 100, 6)
        for r, w in zip(rows, wrows):
            for i, row in enumerate(r):
                if not row[1] > 0:
                    continue
                gap = abs(r[:, 1] - row[1])
                gap[i] = 1.0
                if gap.min() > 1e-4:
                    assert row[0] == w[i, 0] and abs(row[1] - w[i, 1]) <= \
                        1e-4
    finally:
        nncontext.set_nncontext(None)


# -- the rest of the layer library (no hand-written kernel) -----------------

LAYER_TOL = (1e-4, 1e-4)


def _card_and_cpu(make, in_shape, seed=0):
    cpu = make()
    cpu.build_params(torch.Generator().manual_seed(seed), in_shape)
    with torch.no_grad():   # nonzero biases
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                     .manual_seed(seed + 1)))
    return cpu, copy.deepcopy(cpu)


def _fwd_bwd(layer, x, dev):
    layer.to(dev)
    xi = x.to(dev).clone().requires_grad_()
    out = layer(xi)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * torch.randn(
        o.shape, generator=torch.Generator().manual_seed(9 + i)).to(dev))
        .sum() for i, o in enumerate(outs))
    loss.backward()
    return [o.detach().cpu() for o in outs] + [xi.grad.cpu()] + \
        [p.grad.cpu() for _, p in layer.named_parameters()]


def test_sparse_moe_on_the_card_matches_the_cpu_without_a_host_sync(cuda):
    """SparseMoE at 8 experts, top-2, on 4 x 128 tokens: the output and
    every gradient within 1e-4 of the CPU's, and neither the forward nor
    the backward synchronises with the host (no shape hangs on the
    routing)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    cpu, card = _card_and_cpu(lambda: tl.SparseMoE(8, 64, top_k=2),
                              (None, 128, 32))
    x = torch.randn(4, 128, 32, generator=torch.Generator().manual_seed(3))
    want = _fwd_bwd(cpu, x, "cpu")
    card.to(cuda)
    xi = x.to(cuda).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = card(xi)
        (out * torch.ones_like(out)).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for p in card.parameters():
        p.grad = None
    got = _fwd_bwd(card, x, cuda)
    for g, w in zip(got, want):
        _close(g, w, LAYER_TOL)


@pytest.mark.parametrize("case", ["deconv_s2_same", "deconv_s3_valid",
                                  "conv3d_same", "local2d", "convlstm2d",
                                  "crf"])
def test_new_layer_on_the_card_matches_the_cpu(cuda, case):
    """Forward and backward of the layer library's new layers (float32,
    TF32 off) within 1e-4 of the CPU's max plus 1e-4 relative: cuDNN's
    transposed and 3-D convolutions pad as the port's CPU path does."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    make, shape = {
        "deconv_s2_same": (lambda: tl.Deconvolution2D(
            8, 3, 4, border_mode="same", subsample=(2, 2)), (4, 9, 11)),
        "deconv_s3_valid": (lambda: tl.Deconvolution2D(
            8, 2, 2, subsample=(3, 3)), (4, 9, 11)),
        "conv3d_same": (lambda: tl.Convolution3D(
            8, 3, 3, 3, border_mode="same", subsample=(2, 1, 2)),
            (4, 9, 10, 11)),
        "local2d": (lambda: tl.LocallyConnected2D(
            6, 3, 3, border_mode="same", subsample=(2, 2)), (4, 11, 10)),
        "convlstm2d": (lambda: tl.ConvLSTM2D(8, 3, return_sequences=True),
                       (5, 3, 12, 12)),
        "crf": (lambda: tl.CRF(7), (16, 7)),
    }[case]
    cpu, card = _card_and_cpu(make, (None,) + shape)
    x = torch.randn((3,) + shape, generator=torch.Generator().manual_seed(4))
    _kernels.LAUNCHES.reset()
    want = _fwd_bwd(cpu, x, "cpu")
    got = _fwd_bwd(card, x, cuda)
    assert not _kernels.LAUNCHES.snapshot()
    for g, w in zip(got, want):
        _close(g, w, LAYER_TOL)


def test_viterbi_on_the_card_equals_the_cpu(cuda):
    from analytics_zoo_tpu_torch.ops import crf

    gen = torch.Generator().manual_seed(5)
    unary = torch.randn(16, 40, 9, generator=gen)
    trans = torch.randn(9, 9, generator=gen)
    lengths = torch.randint(1, 41, (16,), generator=gen)
    mask = (torch.arange(40)[None] < lengths[:, None]).float()
    want, wscore = crf.crf_decode(unary, trans, mask)
    got, score = crf.crf_decode(unary.to(cuda), trans.to(cuda),
                                mask.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert (score.cpu() - wscore).abs().max() <= 1e-4
    ll = crf.crf_log_likelihood(unary.to(cuda), want.to(cuda),
                                trans.to(cuda), mask.to(cuda))
    wll = crf.crf_log_likelihood(unary, want, trans, mask)
    assert (ll.cpu() - wll).abs().max() <= 1e-4


# ---------------------------------------------------------------------------
# ranks sharing the card over gloo (data and sequence parallelism)
# ---------------------------------------------------------------------------

GANG_TIMEOUT_S = 240.0


def test_collectives_over_gloo_on_the_card_match_the_cpu(cuda):
    """Two ranks on one card (gloo: NCCL refuses two ranks on one GPU):
    each collective and its backward on CUDA tensors equals the CPU
    gang's (sums of two float32 terms), and only the ppermute goes
    through host memory."""
    import torch_dist_workers as workers

    kw = dict(args=(3,), config=dict(data_parallel=2),
              timeout=GANG_TIMEOUT_S)
    card = workers.run_gang(workers.collectives_worker, 2, device="cuda",
                            **kw)
    cpu = workers.run_gang(workers.collectives_worker, 2, **kw)
    for r in range(2):
        for name, value in cpu[r].items():
            if name in ("calls", "mesh"):
                continue
            y, g = value
            torch.testing.assert_close(torch.from_numpy(card[r][name][0]),
                                       torch.from_numpy(y), rtol=0,
                                       atol=1e-6)
            torch.testing.assert_close(torch.from_numpy(card[r][name][1]),
                                       torch.from_numpy(g), rtol=0,
                                       atol=1e-6)
        calls = card[r]["calls"]
        assert calls["ppermute"]["host_routed"] == calls["ppermute"]["calls"]
        assert all(v["host_routed"] == 0 for k, v in calls.items()
                   if k != "ppermute")
        assert card[r]["mesh"][1] == "gloo"


def test_sequence_parallel_attention_on_the_card_runs_the_kernels(cuda):
    """Ulysses at sp = 2 on the card runs the flash kernels (forward and
    both backward kernels) on H/2 heads at full L, and the ring none;
    both match the CPU gang's output and gradients (float32, the kernel
    against the plain version: 1e-4)."""
    import numpy as np

    import torch_dist_workers as workers

    rs = np.random.default_rng(5)
    b, l, h, d = 2, 256, 4, 64
    q, k, v, do = (rs.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    kbias = np.where(np.arange(l)[None, :] < np.array([[l], [l - 37]]),
                     0.0, -10000.0).astype(np.float32)
    cases = [("ulysses", False, "blhd"), ("ring", True, "blhd")]
    kw = dict(args=(q, k, v, kbias, do, cases),
              config=dict(data_parallel=1, sequence_parallel=2),
              timeout=GANG_TIMEOUT_S)
    card = workers.run_gang(workers.seq_attention_worker, 2, device="cuda",
                            **kw)
    cpu = workers.run_gang(workers.seq_attention_worker, 2, **kw)
    for r in range(2):
        # the Ulysses case: one forward and its two backward kernels
        assert card[r]["launches"] == {ta.KERNEL_NAME: 1,
                                       ta.DQ_KERNEL_NAME: 1,
                                       ta.DKV_KERNEL_NAME: 1}
        for case in cases:
            for got, want in zip(card[r][case], cpu[r][case]):
                torch.testing.assert_close(torch.from_numpy(got),
                                           torch.from_numpy(want),
                                           rtol=0, atol=1e-4)


# -- interop: one test a leg of chip_smoke.py's interop phase -------------

def _onnx_cnn_bytes():
    import numpy as np

    from analytics_zoo_tpu_torch.pipeline.api.onnx import builder

    rs = np.random.default_rng(0)

    def w(*shape):
        return (rs.standard_normal(shape) * 0.3).astype(np.float32)

    N = builder.make_node
    nodes = [N("Conv", ["x", "c1_w", "c1_b"], ["a"], pads=[1, 1, 1, 1],
               kernel_shape=[3, 3]),
             N("BatchNormalization", ["a", "g", "b", "m", "v"], ["bn"]),
             N("Relu", ["bn"], ["r"]),
             N("MaxPool", ["r"], ["p"], kernel_shape=[3, 3], strides=[2, 2],
               pads=[0, 0, 1, 1]),
             N("Conv", ["p", "c2_w"], ["c"], strides=[2, 2],
               kernel_shape=[1, 1]),
             N("Add", ["c", "c"], ["s"]),
             N("GlobalAveragePool", ["s"], ["gap"]),
             N("Flatten", ["gap"], ["f"]),
             N("Gemm", ["f", "fc_w", "fc_b"], ["logits"]),
             N("Softmax", ["logits"], ["y"], axis=1)]
    inits = {"c1_w": w(8, 3, 3, 3), "c1_b": w(8), "g": w(8), "b": w(8),
             "m": w(8), "v": np.abs(w(8)) + 0.5, "c2_w": w(16, 8, 1, 1),
             "fc_w": w(16, 10), "fc_b": w(10)}
    g = builder.make_graph(nodes, "cnn",
                           [builder.value_info("x", (None, 3, 32, 32))],
                           [builder.value_info("y", (None, 10))], inits)
    return builder.make_model(g)


def test_onnx_model_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Leg A's path at small size: ``load_onnx`` on the card (cuDNN) and
    on the CPU, float32 rows within 1e-5; ``quantize=True`` gives the same
    int8 kernels on both."""
    import numpy as np

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    path = str(tmp_path / "cnn.onnx")
    with open(path, "wb") as f:
        f.write(_onnx_cnn_bytes())
    x = np.random.default_rng(1).standard_normal((4, 3, 32, 32)).astype(
        np.float32)
    card = InferenceModel().load_onnx(path, device=cuda).predict(x)
    cpu = InferenceModel().load_onnx(path, device="cpu").predict(x)
    assert np.abs(card - cpu).max() <= 1e-5
    qc = InferenceModel().load_onnx(path, quantize=True, device=cuda)
    qh = InferenceModel().load_onnx(path, quantize=True, device="cpu")
    leaves = {k.rsplit("['", 1)[-1]: v.q.cpu()
              for k, v in qc.model.kernels.items()}
    assert sorted(leaves) == ["c1_w']", "c2_w']", "fc_w']"]
    for k, v in qh.model.kernels.items():
        assert torch.equal(leaves[k.rsplit("['", 1)[-1]], v.q.cpu())
    assert np.abs(qc.predict(x) - qh.predict(x)).max() <= 1e-5


def test_caffe_net_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Leg B's layer set at small size (Convolution, BatchNorm + Scale,
    ceil-mode pooling, Eltwise, InnerProduct, Softmax) through
    ``load_caffe``: the card's rows within 1e-5 of the CPU's."""
    import numpy as np

    from analytics_zoo_tpu_torch.pipeline.api.caffe import proto
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    rs = np.random.default_rng(2)

    def blob(*shape, positive=False):
        a = (rs.standard_normal(shape) * 0.3).astype(np.float32)
        a = np.abs(a) + 0.5 if positive else a
        return {"shape": {"dim": list(shape)}, "data": a.ravel()}

    (tmp_path / "net.prototxt").write_text("""
name: "small"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 17 input_dim: 17
layer { bottom: "data" top: "conv1" name: "conv1" type: "Convolution"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 stride: 2 } }
layer { bottom: "conv1" top: "conv1" name: "bn1" type: "BatchNorm"
  batch_norm_param { use_global_stats: true } }
layer { bottom: "conv1" top: "conv1" name: "sc1" type: "Scale"
  scale_param { bias_term: true } }
layer { bottom: "conv1" top: "conv1" name: "relu1" type: "ReLU" }
layer { bottom: "conv1" top: "pool1" name: "pool1" type: "Pooling"
  pooling_param { kernel_size: 3 stride: 2 pool: MAX } }
layer { bottom: "pool1" bottom: "pool1" top: "sum" name: "sum"
  type: "Eltwise" }
layer { bottom: "sum" top: "fc" name: "fc" type: "InnerProduct"
  inner_product_param { num_output: 5 } }
layer { bottom: "fc" top: "prob" name: "prob" type: "Softmax" }
""")
    (tmp_path / "net.caffemodel").write_bytes(proto.encode({
        "name": "small", "layer": [
            {"name": "conv1", "blobs": [blob(8, 3, 3, 3), blob(8)]},
            {"name": "bn1", "blobs": [blob(8), blob(8, positive=True),
                                      blob(1, positive=True)]},
            {"name": "sc1", "blobs": [blob(8), blob(8)]},
            {"name": "fc", "blobs": [blob(5, 8 * 4 * 4), blob(5)]}]},
        "NetParameter"))
    args = (str(tmp_path / "net.prototxt"), str(tmp_path / "net.caffemodel"))
    x = np.random.default_rng(3).standard_normal((4, 3, 17, 17)).astype(
        np.float32)
    card = InferenceModel().load_caffe(*args, device=cuda).predict(x)
    cpu = InferenceModel().load_caffe(*args, device="cpu").predict(x)
    assert card.shape == (4, 5)
    assert np.abs(card - cpu).max() <= 1e-5


def test_torchnet_head_bf16_fit_runs_every_training_kernel(cuda):
    """Leg C at small size: a BERT classifier whose head is a
    ``TorchNet(nn.Linear)`` under a ``TorchCriterion``, one bf16 ``fit``
    step on int32 ids, dropout on: every training kernel once a block (the
    dropout+add+LN pair twice), a finite nonzero gradient on the torch
    module's weight, which moved on the card."""
    import numpy as np

    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    from analytics_zoo_tpu_torch.pipeline.api.net import (TorchCriterion,
                                                          TorchNet)

    tnn.set_nncontext(None)
    tnn.init_nncontext(device=cuda)
    try:
        l = 128
        ins = [tl.Input(shape=(l,)), tl.Input(shape=(l,)),
               tl.Input(shape=(l,)), tl.Input(shape=(1, 1, l))]
        _, pooled = tl.BERT(vocab=100, hidden_size=128, n_block=2,
                            n_head=2, seq_len=l, hidden_p_drop=0.1,
                            attn_p_drop=0.1, output_all_block=False)(ins)
        head = torch.nn.Linear(128, 2)
        model = Model(ins, TorchNet.from_pytorch(head)(pooled), seed=3)
        model.compile(optimizer="adam", loss=TorchCriterion.from_pytorch(
            lambda p, t: F.cross_entropy(p.float(), t.long().reshape(-1))))
        model.set_compute_dtype("bfloat16")
        xs, y, _ = _small_batch(l, "cpu")
        xs = [x.int().numpy() for x in xs[:3]] + [xs[3].numpy()]
        w0 = head.weight.detach().clone()
        _kernels.LAUNCHES.reset()
        model.fit(xs, y.numpy(), batch_size=3, nb_epoch=1)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES.snapshot() == {
            ta.KERNEL_NAME: 2, ta.DQ_KERNEL_NAME: 2, ta.DKV_KERNEL_NAME: 2,
            tdln.FWD_KERNEL_NAME: 4, tdln.BWD_KERNEL_NAME: 4}
        assert np.isfinite(model.trainer.step_losses).all()
        assert head.weight.device == cuda
        assert torch.isfinite(head.weight.grad).all()
        assert head.weight.grad.abs().max() > 0
        assert (head.weight.detach().cpu() - w0).abs().max() > 0
    finally:
        tnn.set_nncontext(None)


# ---------------------------------------------------------------------------
# tfpark on the card: the BERT estimators, the text taggers, the GAN
# ---------------------------------------------------------------------------

def _tfpark_context(cuda, dtype="float32"):
    from analytics_zoo_tpu_torch.common import nncontext as tnn

    tnn.set_nncontext(None)
    return tnn.init_nncontext(tnn.ZooConfig(compute_dtype=dtype,
                                            log_every_n_steps=1),
                              device=cuda)


def _tfpark_bert_data(n=8, l=128, vocab=100, seed=0):
    import numpy as np

    rs = np.random.default_rng(seed)
    mask = (np.arange(l)[None] < rs.integers(l // 4, l + 1, n)[:, None])
    feats = {"input_ids": rs.integers(0, vocab, (n, l)).astype(np.int32),
             "input_mask": mask.astype(np.float32),
             "token_type_ids": np.zeros((n, l), np.int32)}
    return feats, rs.integers(0, 2, n).astype(np.int32)


_TFPARK_BERT = dict(vocab_size=100, hidden_size=128, n_block=2, n_head=2,
                    seq_length=128, intermediate_size=256)


def test_bert_classifier_estimator_on_the_card_runs_every_kernel(cuda):
    """Leg A's gates at 2 blocks: a float32 step, dropout off, within 1e-6
    (relative) of Model.fit's on a copy of the same network and ids; bf16
    ``train`` steps with dropout launch K1-K5 2/2/2/4/4 a step on bf16
    tensors; ``evaluate`` finite; ``predict`` equal to Model.predict's."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.tfpark.text import (BERTClassifier,
                                                     bert_input_fn)

    feats, y = _tfpark_bert_data()
    try:
        _tfpark_context(cuda)
        est = BERTClassifier(num_classes=2, **_TFPARK_BERT)
        est.bert.hidden_p_drop = est.bert.attn_p_drop = 0.0
        ref = copy.deepcopy(est.model)
        ref.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        data = bert_input_fn(feats, y, batch_size=4)
        est.train(data, steps=1)
        ref.fit(list(data()[0].features)[:], y, batch_size=4, nb_epoch=1)
        a, b = est.model.trainer.step_losses[0], ref.trainer.step_losses[0]
        assert abs(a - b) <= 1e-6 * abs(b)

        _tfpark_context(cuda, "bfloat16")
        est = BERTClassifier(num_classes=2, **_TFPARK_BERT)
        _kernels.LAUNCHES.reset()
        est.train(data, steps=2)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES.snapshot() == {
            ta.KERNEL_NAME: 4, ta.DQ_KERNEL_NAME: 4, ta.DKV_KERNEL_NAME: 4,
            tdln.FWD_KERNEL_NAME: 8, tdln.BWD_KERNEL_NAME: 8}
        assert all(set(v) == {"bfloat16"}
                   for v in _kernels.LAUNCHES.by_dtype().values())
        res = est.evaluate(data, metrics=["accuracy"])
        assert set(res) == {"loss", "accuracy"}
        assert all(np.isfinite(v) for v in res.values())
        rows = est.predict(bert_input_fn(feats, batch_size=4))
        want = est.model.predict(list(data()[0].features), batch_size=4)
        assert rows.shape == (8, 2) and np.array_equal(rows, want)
    finally:
        tnn.set_nncontext(None)


@pytest.mark.parametrize("head", ["ner", "squad"])
def test_bert_ner_and_squad_estimators_on_the_card(cuda, head):
    """One bf16 step of BERTNER / BERTSQuAD at 2 blocks: K1-K5 2/2/2/4/4,
    finite outputs of the right shapes."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.tfpark.text import (BERTNER, BERTSQuAD,
                                                     bert_input_fn)

    feats, _ = _tfpark_bert_data()
    rs = np.random.default_rng(1)
    try:
        _tfpark_context(cuda, "bfloat16")
        if head == "ner":
            est = BERTNER(num_entities=9, **_TFPARK_BERT)
            labels = rs.integers(0, 9, (8, 128)).astype(np.int32)
            shapes = [(8, 128, 9)]
        else:
            est = BERTSQuAD(**_TFPARK_BERT)
            labels = [rs.integers(0, 128, 8).astype(np.int32)] * 2
            shapes = [(8, 128), (8, 128)]
        _kernels.LAUNCHES.reset()
        est.train(bert_input_fn(feats, labels, batch_size=8), steps=1)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES.snapshot() == {
            ta.KERNEL_NAME: 2, ta.DQ_KERNEL_NAME: 2, ta.DKV_KERNEL_NAME: 2,
            tdln.FWD_KERNEL_NAME: 4, tdln.BWD_KERNEL_NAME: 4}
        out = est.predict(bert_input_fn(feats, batch_size=8))
        outs = out if isinstance(out, list) else [out]
        assert [o.shape for o in outs] == shapes
        assert all(np.isfinite(o).all() for o in outs)
    finally:
        tnn.set_nncontext(None)


@pytest.mark.parametrize("model", ["ner_pad", "tagger_crf", "intent"])
def test_text_taggers_on_the_card_equal_the_cpu(cuda, model):
    """A fit step of each tfpark text model on the card, then its rows
    against a CPU copy of the same weights (1e-4; float32 LSTMs summed in
    another order) and its decoded tags equal; K1-K5 launched 0 times."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    from analytics_zoo_tpu_torch.tfpark.text import (NER, IntentEntity,
                                                     SequenceTagger)

    rs = np.random.default_rng(2)
    words = rs.integers(1, 50, (16, 12)).astype(np.int32)
    chars = rs.integers(1, 20, (16, 12, 6)).astype(np.int32)
    tags = rs.integers(0, 5, (16, 12)).astype(np.int32)
    try:
        _tfpark_context(cuda)
        if model == "ner_pad":
            obj = NER(5, 50, 20, word_length=6, word_emb_dim=16,
                      char_emb_dim=8, tagger_lstm_dim=16, crf_mode="pad")
            x, y = [words, chars, rs.integers(3, 13, 16).astype(np.int32)], \
                tags
        elif model == "tagger_crf":
            obj = SequenceTagger(5, 3, 50, char_vocab_size=20, word_length=6,
                                 feature_size=16, classifier="crf")
            x, y = [words, chars], [tags, tags % 3]
        else:
            obj = IntentEntity(3, 5, 50, 20, word_length=6, word_emb_dim=16,
                               char_emb_dim=8, char_lstm_dim=8,
                               tagger_lstm_dim=16)
            x, y = [words, chars], [tags[:, 0] % 3, tags]
        _kernels.LAUNCHES.reset()
        obj.fit(x, y, batch_size=8, epochs=1)
        card = obj.model.predict(x, batch_size=8)
        assert _kernels.LAUNCHES.snapshot() == {}
        trainer, obj.model.trainer = obj.model.trainer, None
        cpu_model = copy.deepcopy(obj.model).to("cpu")
        obj.model.trainer = trainer
        tnn.set_nncontext(None)
        tnn.init_nncontext(device="cpu")
        cpu_model.compile(optimizer="sgd", loss="mse")
        cpu = cpu_model.predict(x, batch_size=8)
        for a, b in zip(card, cpu):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        if model == "ner_pad":
            np.testing.assert_array_equal(NER._decode_outputs(card),
                                          NER._decode_outputs(cpu))
        assert isinstance(cpu_model, Model)
    finally:
        tnn.set_nncontext(None)


def test_gan_steps_on_the_card_equal_the_cpu(cuda):
    """GANEstimator on the card: both models, the noise and both
    optimizer states on the device; five alternations of ``d_step`` and
    ``g_step`` on the same real batches and noise as a CPU copy from the
    same weights: losses and parameters within 1e-5 (float32, one small
    MLP's products summed in another order, under Adam); a short
    ``train`` through ``TFDataset`` runs there, K1-K5 launched 0 times."""
    import numpy as np

    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.tfpark import GANEstimator, TFDataset

    def mlp(d):
        m = Sequential(seed=d)
        m.add(tl.Dense(16, activation="relu", input_shape=(d,)))
        m.add(tl.Dense(1))
        return m

    def gan(device):
        """A GAN built on ``device`` (the context's at its first use)."""
        tnn.set_nncontext(None)
        tnn.init_nncontext(device=device)
        est = GANEstimator(mlp(4), mlp(1), generator_optimizer=Adam(lr=5e-3),
                           discriminator_optimizer=Adam(lr=5e-3),
                           noise_dim=4)
        est._build()
        tnn.set_nncontext(None)
        return est

    rs = np.random.default_rng(0)
    card, cpu = gan(cuda), gan("cpu")
    assert card.noise(2).device == cuda
    assert card.d_opt_state[0]["mu"][next(iter(card.d_params))].device \
        == cuda
    _kernels.LAUNCHES.reset()
    for i in range(5):
        real = (rs.standard_normal((16, 1)) * 0.5 + 3.0).astype(np.float32)
        dn, gn = (torch.from_numpy(rs.standard_normal((16, 4)).astype(
            np.float32)) for _ in range(2))
        got = [card.d_step(torch.from_numpy(real).to(cuda), dn.to(cuda)),
               card.g_step(gn.to(cuda))]
        want = [cpu.d_step(torch.from_numpy(real), dn), cpu.g_step(gn)]
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-5, (i, float(a), float(b))
        for side in ("g_params", "d_params"):   # the same layers, in order
            for p, q in zip(getattr(card, side).values(),
                            getattr(cpu, side).values()):
                assert (p.detach().cpu() - q.detach()).abs().max() <= 1e-5, \
                    (i, side)
    real = (rs.standard_normal((256, 1)) * 0.5 + 3.0).astype(np.float32)
    card.train(TFDataset.from_ndarrays(real, batch_size=64), steps=8)
    assert card.steps == 8
    assert np.isfinite(list(card.last_losses.values())).all()
    assert card.generate(16).shape == (16, 1)
    assert _kernels.LAUNCHES.snapshot() == {}


def test_tf_frozen_graph_on_the_card_matches_tensorflow(cuda):
    """Interop leg E's graph: the frozen ``.pb`` TensorFlow wrote
    (``tools/tf_fixtures``) through ``InferenceModel.load_tf`` on the
    card, without TensorFlow: rows within 1e-4 of TensorFlow's committed
    rows, and of the CPU's within 1e-5."""
    import json
    from pathlib import Path

    import numpy as np

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    root = Path(__file__).resolve().parents[1] / "tools" / "tf_fixtures"
    manifest = json.loads((root / "manifest.json").read_text())
    pb = str(root / manifest["graph"])
    x, rows = np.load(root / "inputs.npy"), np.load(root / "rows.npy")
    im = InferenceModel().load_tf(pb, device=cuda)
    assert im.model.mode == "torch" and im.model.device.type == "cuda"
    card = im.predict(x)
    cpu = InferenceModel().load_tf(pb, device="cpu").predict(x)
    assert card.shape == rows.shape == tuple(manifest["rows_shape"])
    assert np.abs(card - rows).max() <= 1e-4
    assert np.abs(card - cpu).max() <= 1e-5
