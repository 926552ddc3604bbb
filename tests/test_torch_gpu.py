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
"""

import math

import pytest
import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as ta

pytestmark = pytest.mark.gpu

O_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -9, 2 ** -6)}
LSE_TOL = 1e-4


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
