#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

It runs from the root of a checkout of the repository, on a machine with
a CUDA card, PyTorch built for CUDA and the CUDA toolkit (``nvcc``). It
imports nothing of JAX or of the JAX package. Phases, one JSON line each:

1. device  -- the card, the device count, ``nvidia-smi``'s name and power
              limit, the software versions.
2. build   -- every kernel built from ``ops/csrc`` with nvcc for sm_90a
              (one nvcc per source, all started together): seconds, the
              ``-Xptxas -v`` register, shared memory and spill lines, and
              per kernel symbol the count of tensor-core instructions
              (HGMMA, HMMA) in ``cuobjdump -sass``; every instantiation of
              the three flash kernels must hold some.
3. kernels -- each kernel against its plain PyTorch version on the card,
              one line per case and dtype, each case also called twice
              and held bit for bit equal: the flash-attention forward
              (K1), its backward dq and dkv kernels (K2, K3), the fused
              dropout+add+layer-norm forward and backward (K4, K5); then
              ``torch.autograd.grad`` through ``flash_attention_blhd``
              against the plain backward.
4. serve   -- the BERT-base classifier of ``bench.py`` (full width and
              depth, weights from ``--seed``) behind ``InferenceModel``
              answers 8 requests of 8 x 512 tokens from 2 client threads;
              outputs are checked, the forward kernel's launch count is
              read, and one row is checked against the port's CPU run.
5. train   -- the same classifier with dropout 0.1 through
              ``Model.compile`` (adam, sparse categorical cross-entropy)
              and ``Model.fit`` for 8 steps at batch 32 on one seeded
              batch of 32 x 512 tokens (lengths 64-512): every loss finite
              and falling, every parameter's gradient finite after the
              first step and every block's qkv_w gradient nonzero, the
              five kernels' launch counts per step, ``evaluate``; then a
              dropout-off step on 2 rows against the port's CPU run.
6. timing  -- request latency, tokens/s and peak memory of the served
              model and the forward kernel at the serving shape (profiler
              device time, CUDA events beside it); the
              training step's time, tokens/s, peak memory and
              ``torch.profiler`` device time by kernel group; and each
              kernel at the training shape beside its plain version, its
              bound and the PyTorch library call where there is one.

Then the ``{"kernels": [...]}`` summary, ``nvidia-smi``'s line, and as the
last line ``{"ok": true, "device": {...}}``. Every check raises on
failure: the script then exits non-zero and prints no result. Without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import init_nncontext
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as attn
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as dln
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    Adam, get_optimizer)
from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

# bench.py's BERT-base classifier (bench.py:353-438)
BERT_CONFIG = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                   seq_len=512, intermediate_size=3072,
                   output_all_block=False)
N_CLASSES = 2
REQUESTS, BATCH, CLIENTS = 8, 8, 2
TIMED_REQUESTS = 32
MIN_LEN = 64
# training: bench.py's BERT_BATCH=32 at L=512, dropout 0.1 (hidden and
# attention), Adam at lr 1e-4 on one repeated batch
TRAIN_BATCH, TRAIN_STEPS, TRAIN_P_DROP, TRAIN_LR = 32, 8, 0.1, 1e-4
TIMED_STEPS = 5
PARITY_ROWS = 2
# the training shape of the kernels: (B, L, H, d) and (N, D) rows
TRAIN_SHAPE = (TRAIN_BATCH, 512, 12, 64)
DLN_SHAPE = (TRAIN_BATCH * 512, 768)

# Tolerances, kernel against plain version, element by element.
# K1 o: |o - ro| <= atol + rtol * |ro|. float32: the kernel sums in another
# order, 1e-4. bfloat16: both round o to bf16, and the kernel rounds p
# against its running max where the plain version uses the final max; so
# two bf16 steps at |ro| (a step is at most 2**-7 |ro|) plus a quarter
# step at unit scale (|v| ~ 1) for p's rounding. lse is float32
# arithmetic in both dtypes and is held at 1e-4 in both.
O_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -9, 2 ** -6)}
LSE_TOL = 1e-4
# K2-K5: |g - rg| <= a * max|rg| + r * |rg|. float32 (1e-5, 1e-5): the
# kernels sum in another order. bfloat16 (2**-8, 2**-6): both sides round
# the same f32 intermediates (ds, p, y, dx, ...) to bf16, and an ulp apart
# in f32 can flip a rounding: two bf16 steps at |rg| plus a half step at
# the tensor's scale. The key-bias gradient and the row statistics are
# f32 arithmetic in both dtypes (F32_TOL); dgamma/dbeta are sums over
# 16384 rows (1e-4 of the largest, 1e-5 relative).
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -8, 2 ** -6)}
F32_TOL = GRAD_TOL[torch.float32]
DLN_PARAM_TOL = (1e-4, 1e-5)
# the served probabilities against the port's CPU run of the same row:
# 12 blocks of f32 matmuls summed in another order (TF32 off on the card)
CPU_TOL = 1e-4
ROW_SUM_TOL = 1e-5
# the training step, dropout off, card against CPU: the loss within 1e-5;
# each parameter's gradient within 1e-3 of its norm (12 blocks forward and
# backward of f32 products and reductions summed in another order)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). The
# flash kernels' products run on the tensor cores: bf16 at 989 TFLOP/s,
# float32 as three TF32 products (3xTF32, to stay float32-accurate) at
# 495/3 TFLOP/s. The dropout+add+LN kernels compute in float32 on the CUDA
# cores (67 TFLOP/s).
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the flash kernels' symbols, each of which must hold tensor-core
# instructions (HGMMA: wgmma; HMMA: mma.sync) in its SASS, in all four
# instantiations (float32 and bf16, d = 64 and 128)
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel")

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    attn.KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu",
                       "analytics_zoo_tpu/ops/attention.py:378"),
    attn.DQ_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                          "analytics_zoo_tpu/ops/attention.py:556"),
    attn.DKV_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                           "analytics_zoo_tpu/ops/attention.py:605"),
    dln.FWD_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/dropout_ln.cu",
                          "analytics_zoo_tpu/ops/fused_dropout_ln.py:59"),
    dln.BWD_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/dropout_ln.cu",
                          "analytics_zoo_tpu/ops/fused_dropout_ln.py:80"),
}


def check_tensor_cores(sass):
    """Every instantiation of the flash kernels holds tensor-core
    instructions in its SASS."""
    for name in TENSOR_CORE_KERNELS:
        found = {sym: n for sym, n in sass.items() if name in sym}
        if len(found) != 4 or any(sum(n.values()) == 0
                                  for n in found.values()):
            raise AssertionError(f"{name}: tensor-core instructions by "
                                 f"instantiation {found}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, with CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn, iters, attempts: int = 3):
    """torch.profiler's CUDA kernel records over ``iters`` calls of ``fn``
    after 3 warm-up calls. The profiler now and then records no kernel at
    all in a window (seen once on the H100 in a run of this script); such
    a window is profiled again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def kernel_ms(fn, symbols, iters: int = 20):
    """Mean device time of one launch of each named kernel (a substring of
    its symbol) over ``iters`` calls of ``fn``."""
    total = {s: [0.0, 0] for s in symbols}
    for evt in _device_events(fn, iters):
        for s in symbols:
            if s in evt.key:
                total[s][0] += evt.self_device_time_total / 1e3
                total[s][1] += evt.count
    missing = [s for s, (_, n) in total.items() if n == 0]
    if missing:
        raise AssertionError(f"torch.profiler recorded no launch of "
                             f"{missing}")
    return {s: ms / n for s, (ms, n) in total.items()}


def device_ms(fn, iters: int = 10):
    """Mean device busy time of one call of ``fn``: the sum of every CUDA
    kernel's time over ``iters`` calls, divided by ``iters``. Unlike CUDA
    events around the calls it leaves out the gaps while the host
    enqueues, so a call of many small kernels is not timed at the host's
    speed."""
    busy = sum(evt.self_device_time_total
               for evt in _device_events(fn, iters))
    if busy == 0:
        raise AssertionError("torch.profiler recorded no device time")
    return busy / 1e3 / iters


def bound_ms(nbytes, ops, peak_flops):
    """The least time for ``nbytes`` moved and ``ops`` done at the card's
    published peaks (``peak_flops`` operations a second): (ms, what bounds
    it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / peak_flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def over_limit(got, want, tol):
    """(max |got - want|, max of |got - want| over the GRAD_TOL-style
    limit a * max|want| + r * |want|)."""
    a, r = tol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = a * want.abs().max() + r * want.abs()
    return diff.max().item(), (diff / limit.clamp_min(1e-30)).max().item()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def qkv_views(b, lq, lk, h, d, dtype, device, gen):
    """q, k, v as the strided (B, L, H, d) views of one fused projection,
    the way the transformer block hands them to the kernels."""
    lmax = max(lq, lk)
    qkv = torch.randn(b, lmax, 3 * h * d, device=device, generator=gen) \
        .to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    return (q[:, :lq].reshape(b, lq, h, d), k[:, :lk].reshape(b, lk, h, d),
            v[:, :lk].reshape(b, lk, h, d))


def key_bias(b, lk, padded: bool, device, gen):
    """BERT's padding bias: noise on the kept keys and -10000 on a ragged
    tail of padding keys per row; zeros when ``padded`` is false."""
    if not padded:
        return torch.zeros(b, lk, device=device)
    kb = 0.5 * torch.randn(b, lk, device=device, generator=gen)
    lengths = torch.randint(1, lk + 1, (b,), device=device, generator=gen)
    keys = torch.arange(lk, device=device)[None, :]
    return torch.where(keys < lengths[:, None], kb,
                       torch.full_like(kb, -10000.0))


# (name, b, lq, lk, h, d, causal, key bias)
KERNEL_CASES = [
    ("train_shape", TRAIN_BATCH, 512, 512, 12, 64, False, True),
    ("bert_base", BATCH, 512, 512, 12, 64, False, True),
    ("causal_square", 2, 512, 512, 12, 64, True, False),
    ("causal_lq_lt_lk", 2, 128, 512, 12, 64, True, False),
    ("ragged_300", 2, 300, 300, 12, 64, False, True),
    ("head_dim_128", 2, 512, 512, 6, 128, True, True),
    ("decode_row", 2, 1, 77, 12, 64, True, True),
    # a partial last key tile at every streamed tile size (64 keys in
    # bf16, 32 in float32) and a partial q tile, at d=64 and d=128
    ("ragged_77", 2, 77, 77, 12, 64, False, True),
    ("ragged_77_d128", 2, 77, 77, 6, 128, False, True),
]
# the backward's cases: the forward's, less the serving shapes, plus
# causal tile edges at d=128 and causal Lq < Lk with a wide offset
BWD_CASES = [c for c in KERNEL_CASES
             if c[0] not in ("bert_base", "decode_row")] + [
    ("causal_ragged_200_d128", 2, 200, 200, 6, 128, True, True),
    ("causal_64_lt_320", 2, 64, 320, 12, 64, True, True),
]
# (name, rows, features, keep); D = 770 is off the backward's 16-byte
# chunk (4 float32 or 8 bf16 values), so its rows start off 16-byte
# boundaries and the backward takes one value a chunk
DLN_CASES = [("train_shape",) + DLN_SHAPE + (1.0 - TRAIN_P_DROP,),
             ("ragged", 300, 1000, 0.75),
             ("off_vector_width", 301, 770, 0.8)]


def check_forward(device, seed):
    """K1, every case in f32 and bf16: the kernel against its plain
    version, and a second call on the same inputs bit for bit equal to
    the first. Returns {dtype: max |do| at the training shape}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, lq, lk, h, d, causal, padded in KERNEL_CASES:
            q, k, v = qkv_views(b, lq, lk, h, d, dtype, device, gen)
            kb = key_bias(b, lk, padded, device, gen)
            o, lse = attn.flash_forward_blhd(q, k, v, kb, causal)
            again = attn.flash_forward_blhd(q, k, v, kb, causal)
            torch.cuda.synchronize()
            deterministic = torch.equal(o, again[0]) and \
                torch.equal(lse, again[1])
            ro, rl = attn.flash_forward_reference(q, k, v, kb, causal,
                                                  1.0 / math.sqrt(d))
            atol, rtol = O_TOL[dtype]
            diff = (o.float() - ro.float()).abs()
            err_o = diff.max().item()
            o_over_limit = (diff / (atol + rtol * ro.float().abs())) \
                .max().item()
            err_lse = (lse - rl).abs().max().item()
            emit("kernels", kernel=attn.KERNEL_NAME, case=name,
                 dtype=dtype_name(dtype),
                 shape=dict(B=b, Lq=lq, Lk=lk, H=h, d=d), causal=causal,
                 key_bias=padded, max_abs_err_o=err_o,
                 o_tol=dict(atol=atol, rtol=rtol),
                 max_o_err_over_limit=o_over_limit,
                 max_abs_err_lse=err_lse, lse_tol=LSE_TOL,
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls of the "
                                     f"forward on the same inputs differ")
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"{name} {dtype}: non-finite output")
            if o_over_limit > 1.0 or err_lse > LSE_TOL:
                raise AssertionError(
                    f"{name} {dtype}: kernel disagrees with its plain "
                    f"version (o {err_o}, {o_over_limit} x its limit; "
                    f"lse {err_lse}, tol {LSE_TOL})")
            if name == "train_shape":
                errs[dtype] = err_o
    return errs


def check_backward(device, seed):
    """K2 and K3, every case in f32 and bf16, on the plain forward's o
    and lse: the kernels against the plain backward, and a second call on
    the same inputs bit for bit equal to the first. Returns {dtype:
    {"dq": max err, "dkv": max err over dk, dv, dbias}} at the training
    shape."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, lq, lk, h, d, causal, padded in BWD_CASES:
            q, k, v = qkv_views(b, lq, lk, h, d, dtype, device, gen)
            kb = key_bias(b, lk, padded, device, gen)
            scale = 1.0 / math.sqrt(d)
            o, lse = attn.flash_forward_reference(q, k, v, kb, causal, scale)
            do = torch.randn(b, lq, h, d, device=device, generator=gen) \
                .to(dtype)
            got = attn.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
            again = attn.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
            torch.cuda.synchronize()
            deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
            want = attn.flash_backward_reference(q, k, v, kb, o, lse, do,
                                                 causal, scale)
            tols = [GRAD_TOL[dtype]] * 3 + [F32_TOL]
            res = {n: over_limit(g, w, t) for n, g, w, t in
                   zip(("dq", "dk", "dv", "dbias"), got, want, tols)}
            emit("kernels", kernel=f"{attn.DQ_KERNEL_NAME}+"
                 f"{attn.DKV_KERNEL_NAME}", case=name,
                 dtype=dtype_name(dtype),
                 shape=dict(B=b, Lq=lq, Lk=lk, H=h, d=d), causal=causal,
                 key_bias=padded,
                 max_abs_err={n: e for n, (e, _) in res.items()},
                 max_err_over_limit={n: r for n, (_, r) in res.items()},
                 max_abs_ref={n: w.abs().max().item() for n, w in
                              zip(res, want)},
                 tol=dict(grads=GRAD_TOL[dtype], dbias=F32_TOL),
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls of the "
                                     f"backward on the same inputs differ")
            for n, g in zip(res, got):
                if not torch.isfinite(g.float()).all() or res[n][1] > 1.0:
                    raise AssertionError(
                        f"{name} {dtype}: {n} disagrees with the plain "
                        f"backward ({res[n][0]}, {res[n][1]} x its limit)")
            if name == "train_shape":
                errs[dtype] = {"dq": res["dq"][0],
                               "dkv": max(res[n][0] for n in
                                          ("dk", "dv", "dbias"))}
    return errs


def check_autograd(device, seed):
    """torch.autograd.grad through flash_attention_blhd at the training
    shape (it must run K1, K2 and K3) against the plain backward on the
    kernel forward's o and lse."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    b, l, h, d = TRAIN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach().requires_grad_() for t in
                   qkv_views(b, l, l, h, d, dtype, device, gen))
        kb = key_bias(b, l, True, device, gen)
        do = torch.randn(b, l, h, d, device=device, generator=gen).to(dtype)
        before = _kernels.LAUNCHES.snapshot()
        out = attn.flash_attention_blhd(q, k, v, bias=kb[:, None, None, :])
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        after = _kernels.LAUNCHES.snapshot()
        ran = {n: after.get(n, 0) - before.get(n, 0) for n in
               (attn.KERNEL_NAME, attn.DQ_KERNEL_NAME, attn.DKV_KERNEL_NAME)}
        o, lse = attn.flash_forward_blhd(q.detach(), k.detach(), v.detach(),
                                         kb)
        want = attn.flash_backward_reference(
            q.detach(), k.detach(), v.detach(), kb, o, lse, do, False,
            1.0 / math.sqrt(d))
        res = {n: over_limit(g, w, GRAD_TOL[dtype]) for n, g, w in
               zip(("dq", "dk", "dv"), grads, want)}
        emit("kernels", kernel="flash_attention_blhd autograd",
             case="train_shape", dtype=dtype_name(dtype), launches=ran,
             max_abs_err={n: e for n, (e, _) in res.items()},
             max_err_over_limit={n: r for n, (_, r) in res.items()},
             tol=GRAD_TOL[dtype])
        if any(n != 1 for n in ran.values()):
            raise AssertionError(f"autograd ran kernels {ran}")
        if any(r > 1.0 for _, r in res.values()):
            raise AssertionError(f"autograd gradients disagree: {res}")


def dln_inputs(n, d, dtype, device, gen):
    x = torch.randn(n, d, device=device, generator=gen).to(dtype)
    r = torch.randn(n, d, device=device, generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(d, device=device, generator=gen)
    beta = 0.1 * torch.randn(d, device=device, generator=gen)
    bits = dln.draw_bits((n, d), gen, device)
    dy = torch.randn(n, d, device=device, generator=gen).to(dtype)
    return x, r, gamma, beta, bits, dy


def check_dln(device, seed):
    """K4 and K5, every case in f32 and bf16, on the same bits: the
    kernels against their plain versions, and second calls on the same
    inputs bit for bit equal to the first. Returns {dtype: {"fwd": max
    err, "bwd": max err}} at the training shape."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, d, keep in DLN_CASES:
            x, r, gamma, beta, bits, dy = dln_inputs(n, d, dtype, device,
                                                     gen)
            got_f = dln.dln_forward(x, r, bits, gamma, beta, keep)
            again_f = dln.dln_forward(x, r, bits, gamma, beta, keep)
            torch.cuda.synchronize()
            want_f = dln.dln_forward_reference(x, r, bits, gamma, beta, keep,
                                               1e-5)
            _, z, mean, inv = want_f
            got_b = dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
            again_b = dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
            torch.cuda.synchronize()
            deterministic = all(torch.equal(a, b_) for a, b_ in
                                zip(got_f + got_b, again_f + again_b))
            want_b = dln.dln_backward_reference(dy, z, bits, gamma, mean,
                                                inv, keep)
            tols = [GRAD_TOL[dtype]] * 2 + [F32_TOL] * 2 + \
                [GRAD_TOL[dtype]] * 2 + [DLN_PARAM_TOL] * 2
            names = ("y", "z", "mean", "inv", "dx", "dres", "dgamma",
                     "dbeta")
            res = {nm: over_limit(g, w, t) for nm, g, w, t in
                   zip(names, got_f + got_b, want_f + want_b, tols)}
            emit("kernels", kernel=f"{dln.FWD_KERNEL_NAME}+"
                 f"{dln.BWD_KERNEL_NAME}", case=name,
                 dtype=dtype_name(dtype), shape=dict(N=n, D=d), keep=keep,
                 max_abs_err={nm: e for nm, (e, _) in res.items()},
                 max_err_over_limit={nm: q for nm, (_, q) in res.items()},
                 tol=dict(values=GRAD_TOL[dtype], stats=F32_TOL,
                          dgamma_dbeta=DLN_PARAM_TOL),
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls on the "
                                     f"same inputs differ")
            for nm, g in zip(names, got_f + got_b):
                if not torch.isfinite(g.float()).all() or res[nm][1] > 1.0:
                    raise AssertionError(
                        f"{name} {dtype}: {nm} disagrees with the plain "
                        f"version ({res[nm][0]}, {res[nm][1]} x its limit)")
            if name == "train_shape":
                errs[dtype] = {
                    "fwd": max(res[nm][0] for nm in names[:4]),
                    "bwd": max(res[nm][0] for nm in names[4:])}
    return errs


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def build_classifier(seed, config=BERT_CONFIG):
    """bench.py's classifier: BERT -> pooled -> Dense(2, softmax)."""
    l = config["seq_len"]
    ins = [L.Input(shape=(l,), name="tokens"),
           L.Input(shape=(l,), name="positions"),
           L.Input(shape=(l,), name="segments"),
           L.Input(shape=(1, 1, l), name="mask")]
    _, pooled = L.BERT(**config)(ins)
    return Model(ins, L.Dense(N_CLASSES, activation="softmax")(pooled),
                 seed=seed)


def make_requests(seed, n, batch, config=BERT_CONFIG, min_len=MIN_LEN):
    """n request batches of [tokens, positions, segments, mask] as float32
    numpy, with seeded lengths in [min_len, L]; segment 1 covers the
    second half of each sequence, and padding is masked out."""
    rs = np.random.default_rng(seed)
    l = config["seq_len"]
    requests, real_tokens = [], 0
    for _ in range(n):
        lengths = rs.integers(min_len, l + 1, size=batch)
        real_tokens += int(lengths.sum())
        pos = np.arange(l)[None, :]
        requests.append([
            rs.integers(0, config["vocab"], size=(batch, l))
            .astype(np.float32),
            np.repeat(pos.astype(np.float32), batch, axis=0),
            (pos >= lengths[:, None] // 2).astype(np.float32),
            (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]])
    return requests, real_tokens


def serve(im, requests, clients):
    """Answer ``requests`` from ``clients`` threads; returns the outputs
    and each request's latency (host clock around predict and a device
    synchronize) and the wall time of the whole run."""
    outputs = [None] * len(requests)
    latency = [None] * len(requests)

    def client(c):
        for i in range(c, len(requests), clients):
            t0 = time.perf_counter()
            out = im.predict(requests[i])
            torch.cuda.synchronize()
            latency[i] = time.perf_counter() - t0
            outputs[i] = out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        for fut in [pool.submit(client, c) for c in range(clients)]:
            fut.result()
    return outputs, latency, time.perf_counter() - t0


def check_outputs(outputs, batch):
    worst = 0.0
    for i, out in enumerate(outputs):
        if out.shape != (batch, N_CLASSES) or not np.isfinite(out).all():
            raise AssertionError(f"request {i}: bad output {out.shape}")
        worst = max(worst, float(np.abs(out.sum(-1) - 1.0).max()))
    if worst > ROW_SUM_TOL:
        raise AssertionError(f"rows do not sum to 1 (off by {worst})")
    return worst


def check_cpu_row(cpu_model, request, served_row):
    """The first row of a request through the port's CPU run (plain
    versions) against the probabilities the card served."""
    launches = _kernels.LAUNCHES.snapshot()
    with torch.inference_mode():
        cpu = cpu_model([torch.from_numpy(x[:1].copy()) for x in request])
    if _kernels.LAUNCHES.snapshot() != launches:
        raise AssertionError("the CPU run launched a kernel")
    err = float(np.abs(cpu.numpy()[0] - served_row).max())
    if err > CPU_TOL:
        raise AssertionError(f"served row differs from the CPU run by "
                             f"{err} (tol {CPU_TOL})")
    return err


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p))


PORT_KERNEL_SYMBOLS = {   # symbol substring -> profile group
    "flash_fwd_kernel": "flash_fwd (port kernel)",
    "flash_bwd_dq_kernel": "flash_bwd_dq (port kernel)",
    "flash_bwd_dkv_kernel": "flash_bwd_dkv (port kernel)",
    "dln_fwd_kernel": "dln_fwd (port kernel)",
    "dln_bwd_kernel": "dln_bwd (port kernel)",
    "dln_bwd_sum_kernel": "dln_bwd (port kernel)",
}


def kernel_group(name: str) -> str:
    for symbol, group in PORT_KERNEL_SYMBOLS.items():
        if symbol in name:
            return group
    if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def profile_device(fn):
    """Device time by kernel group over one call of ``fn``, from
    ``torch.profiler``: the groups' sums, their shares of the call's wall
    time, and the device's idle share. None where the profiler recorded
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = groups.setdefault(kernel_group(evt.key),
                              {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += evt.self_device_time_total / 1e3
        g["launches"] += evt.count
    busy_ms = sum(g["device_ms"] for g in groups.values())
    if busy_ms == 0.0:
        return dict(wall_ms=wall_us / 1e3, groups=None, idle_share=None)
    for g in groups.values():
        g["share_of_wall"] = 1e3 * g["device_ms"] / wall_us
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - 1e3 * busy_ms / wall_us,
                groups=dict(sorted(groups.items(),
                                   key=lambda kv: -kv[1]["device_ms"])))


def flash_bound_ms(b, lq, lk, h, d, dtype):
    """The least time the card could take for one non-causal flash
    forward: q, k, v, the key bias read once, o and lse written once,
    over the memory rate; 4*B*H*Lq*Lk*d operations over the dtype's peak.
    Returns (ms, what bounds it)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * esize + \
        4 * b * lk + 4 * b * h * lq
    return bound_ms(nbytes, 4 * b * h * lq * lk * d, PEAK_FLOPS[dtype])


def time_kernel(device, seed, dtype):
    """The forward kernel, its plain version and SDPA at the serving
    shape: the kernel's device time per launch (``kernel_ms``), the plain
    version's and SDPA's device time per call (``device_ms``), and the
    same calls timed with CUDA events (``*_events_ms``) beside them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, l, h, d = BATCH, BERT_CONFIG["seq_len"], BERT_CONFIG["n_head"], \
        BERT_CONFIG["hidden_size"] // BERT_CONFIG["n_head"]
    q, k, v = qkv_views(b, l, l, h, d, dtype, device, gen)
    kb = key_bias(b, l, True, device, gen)
    scale = 1.0 / math.sqrt(d)
    mask = kb[:, None, None, :].to(dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, bound_by = flash_bound_ms(b, l, l, h, d, dtype)
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb, False)
    plain = lambda: attn.flash_forward_reference(q, k, v, kb, False, scale)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=scale)
    return dict(
        dtype=dtype_name(dtype), shape=dict(B=b, L=l, H=h, d=d),
        ms=kernel_ms(fwd, ["flash_fwd_kernel"])["flash_fwd_kernel"],
        plain_ms=device_ms(plain), library_ms=device_ms(sdpa),
        events_ms=cuda_ms(fwd), plain_events_ms=cuda_ms(plain, iters=10),
        library_events_ms=cuda_ms(sdpa), bound_ms=bound, bound_by=bound_by)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_data(seed, n, config=BERT_CONFIG, min_len=MIN_LEN):
    """n rows of [tokens, positions, segments, mask] and 0/1 labels as
    float32 numpy, lengths in [min_len, L]; the first token (a [CLS]-like
    id) carries the label, so the classifier has something to learn."""
    rs = np.random.default_rng(seed)
    l = config["seq_len"]
    lengths = rs.integers(min_len, l + 1, size=n)
    labels = rs.integers(0, N_CLASSES, size=n)
    tokens = rs.integers(1000, config["vocab"], size=(n, l))
    tokens[:, 0] = 101 + labels
    pos = np.arange(l)[None, :]
    x = [tokens.astype(np.float32),
         np.repeat(pos.astype(np.float32), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(np.float32),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, labels.astype(np.float32), int(lengths.sum())


def check_grads(model):
    """Every parameter has a finite gradient and every block's qkv_w a
    nonzero one (the fault of slice 1 left qkv_w without any)."""
    worst = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name}: no gradient")
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: non-finite gradient")
        if name.endswith("qkv_w"):
            worst[name] = p.grad.abs().max().item()
    n_block = BERT_CONFIG["n_block"]
    if len(worst) != n_block or min(worst.values()) <= 0.0:
        raise AssertionError(f"qkv_w gradients {worst}")
    return min(worst.values())


def train(seed):
    """Model.compile + Model.fit, TRAIN_STEPS steps on one batch, with the
    launch counts read around the fit calls; then evaluate."""
    config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    model = build_classifier(seed + 1, config)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    x, y, real_tokens = train_data(seed, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    losses = list(model.trainer.step_losses)
    min_qkv_grad = check_grads(model)
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses += model.trainer.step_losses
    n_block = BERT_CONFIG["n_block"]
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the loss did not fall: {losses}")
    results = model.evaluate(x, y, batch_size=TRAIN_BATCH)
    if not all(np.isfinite(v) for v in results.values()) or \
            set(results) != {"loss", "accuracy"}:
        raise AssertionError(f"evaluate gave {results}")
    return model, dict(
        model="BERT-base classifier (bench.py:353-438)", config=config,
        seed=seed, optimizer=f"adam lr {TRAIN_LR}",
        loss="sparse_categorical_crossentropy", batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, real_tokens_per_batch=real_tokens,
        losses=losses, min_qkv_w_grad_after_step_1=min_qkv_grad,
        launches=launches, launches_per_step=per_step, fit_wall_s=wall,
        peak_memory_bytes=peak, evaluate=results,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32)


def check_train_parity(seed, device):
    """One training step, dropout off, on PARITY_ROWS rows: the card (the
    flash kernels run, the dropout+add+LN kernels do not) against the
    port's CPU run (plain versions) from the same weights."""
    config = dict(BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0)
    model = build_classifier(seed + 2, config)
    cpu_model = copy.deepcopy(model)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    card = SPMDTrainer(model, loss_fn, get_optimizer("adam"), device=device)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("adam"),
                      device="cpu")
    x, y, _ = train_data(seed + 2, PARITY_ROWS)
    batch = (x, y, np.ones(PARITY_ROWS, np.float32))
    card.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    card_loss = card.loss_and_grads(card.put_batch(batch)).item()
    launches = _kernels.LAUNCHES.snapshot()
    n_block = BERT_CONFIG["n_block"]
    expected = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block}
    if launches != expected:
        raise AssertionError(f"parity step launches {launches}, expected "
                             f"{expected}")
    cpu_loss = cpu.loss_and_grads(cpu.put_batch(batch)).item()
    cpu_params = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        g, w = p.grad.cpu(), cpu_params[name].grad
        rel = ((g - w).norm() / max(w.norm().item(), 1e-12)).item()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient on the card")
        if rel > worst:
            worst, worst_name = rel, name
    loss_err = abs(card_loss - cpu_loss)
    emit("train_parity", rows=PARITY_ROWS, dropout=0.0, launches=launches,
         card_loss=card_loss, cpu_loss=cpu_loss, loss_err=loss_err,
         loss_tol=TRAIN_LOSS_TOL, max_grad_rel_err=worst,
         max_grad_rel_err_param=worst_name, grad_tol=TRAIN_GRAD_TOL)
    if loss_err > TRAIN_LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"card step differs from the CPU run: loss "
                             f"{loss_err}, gradient {worst} ({worst_name})")


def flash_bwd_bounds(b, lq, lk, h, d, dtype):
    """The least time for dq and for dk/dv/dbias at a non-causal shape:
    each operand read once and each output written once (q, k, v, dO,
    lse, delta and the key bias in; dq, or dk, dv and the per-head bias
    gradient out) over the memory rate; 3 and 4 products of
    2*B*H*Lq*Lk*d operations over the dtype's peak."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows_q, rows_k = b * lq * h * d * esize, b * lk * h * d * esize
    stats = 4 * 2 * b * h * lq + 4 * b * lk
    product = 2 * b * h * lq * lk * d
    return (bound_ms(2 * rows_q + 2 * rows_k + rows_q + stats, 3 * product,
                     PEAK_FLOPS[dtype]),
            bound_ms(2 * rows_q + 4 * rows_k + stats + 4 * b * h * lk,
                     4 * product, PEAK_FLOPS[dtype]))


def dln_bounds(n, d, dtype):
    """The least time for the dropout+add+LN forward and backward: x,
    resid and the 32-bit words (or dy, z and the words) read once, y and
    z (or dx and dresid) written once, plus the row statistics, gamma and
    beta read once and the backward's dgamma and dbeta written once (the
    function's own work: no partials of any design); operations counted
    from the function's arithmetic, 9 per element forward and 14
    backward, at the float32 peak of the CUDA cores (they compute in
    f32)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows = n * d * (4 * esize + 4) + 2 * n * 4
    fwd = bound_ms(rows + 2 * d * 4, 9 * n * d, CUDA_CORE_F32_FLOPS)
    bwd = bound_ms(rows + d * 4 + 2 * d * 4, 14 * n * d,
                   CUDA_CORE_F32_FLOPS)
    return fwd, bwd


def time_training_kernels(device, seed, dtype):
    """Each kernel at the training shape: its device time per launch (from
    torch.profiler's kernel records), its bound, and the device time per
    call (``device_ms``) of its plain version and of the library call
    where there is one: SDPA forward for K1, SDPA's backward (dq, dk and
    dv together) for K2 and K3; none for K4 and K5, whose composed
    dropout + add + F.layer_norm forward and backward are timed beside
    them. The ``*_events_ms`` keys time the same calls with CUDA events
    (host enqueue gaps included)."""
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    b, l, h, d = TRAIN_SHAPE
    q, k, v = qkv_views(b, l, l, h, d, dtype, device, gen)
    kb = key_bias(b, l, True, device, gen)
    do = torch.randn(b, l, h, d, device=device, generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = attn.flash_forward_blhd(q, k, v, kb)
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb)
    bwd = lambda: attn.flash_backward_blhd(q, k, v, kb, o, lse, do)
    dev = kernel_ms(fwd, ["flash_fwd_kernel"])
    dev.update(kernel_ms(bwd, ["flash_bwd_dq_kernel",
                               "flash_bwd_dkv_kernel"]))
    mask = kb[:, None, None, :].to(dtype)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale)
    sdpa_do = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), sdpa_do, retain_graph=True)
    with torch.no_grad():
        sdpa_fwd = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale)
        sdpa_fwd_ms = device_ms(sdpa_fwd)
        sdpa_fwd_events_ms = cuda_ms(sdpa_fwd)
    plain_bwd = lambda: attn.flash_backward_reference(
        q, k, v, kb, o, lse, do, False, scale)
    bwd_plain_ms = device_ms(plain_bwd, iters=5)
    sdpa_bwd_ms = device_ms(sdpa_bwd)
    sdpa_bwd_events_ms = cuda_ms(sdpa_bwd, iters=20)
    fb = flash_bound_ms(b, l, l, h, d, dtype)
    dqb, dkvb = flash_bwd_bounds(b, l, l, h, d, dtype)
    out = {
        attn.KERNEL_NAME: dict(
            ms=dev["flash_fwd_kernel"], wrapper_events_ms=cuda_ms(fwd),
            plain_ms=device_ms(lambda: attn.flash_forward_reference(
                q, k, v, kb, False, scale)),
            library_ms=sdpa_fwd_ms, library_events_ms=sdpa_fwd_events_ms,
            library="SDPA forward", bound_ms=fb[0], bound_by=fb[1]),
        attn.DQ_KERNEL_NAME: dict(
            ms=dev["flash_bwd_dq_kernel"], plain_ms=bwd_plain_ms,
            library_ms=sdpa_bwd_ms, bound_ms=dqb[0], bound_by=dqb[1]),
        attn.DKV_KERNEL_NAME: dict(
            ms=dev["flash_bwd_dkv_kernel"], plain_ms=bwd_plain_ms,
            library_ms=sdpa_bwd_ms, bound_ms=dkvb[0], bound_by=dkvb[1]),
    }
    bwd_wrapper_ms = cuda_ms(bwd, iters=20)
    for name in (attn.DQ_KERNEL_NAME, attn.DKV_KERNEL_NAME):
        out[name].update(
            wrapper_events_ms=bwd_wrapper_ms,
            library_events_ms=sdpa_bwd_events_ms,
            note="plain_ms is the plain backward (dq, dk, dv and dbias "
                 "together); library_ms SDPA's backward (dq, dk, dv "
                 "together); wrapper_events_ms flash_backward_blhd "
                 "(delta, both kernels, the head sum)")

    n, dd = DLN_SHAPE
    keep = 1.0 - TRAIN_P_DROP
    x, r, gamma, beta, bits, dy = dln_inputs(n, dd, dtype, device, gen)
    y, z, mean, inv = dln.dln_forward(x, r, bits, gamma, beta, keep)
    dfwd = lambda: dln.dln_forward(x, r, bits, gamma, beta, keep)
    dbwd = lambda: dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
    dev = kernel_ms(dfwd, ["dln_fwd_kernel"])
    # K5 is two launches a call: the rows, then the partials' sum
    dev.update(kernel_ms(dbwd, ["dln_bwd_kernel", "dln_bwd_sum_kernel"]))
    xg, rg, gg, bg = (t.detach().clone().requires_grad_()
                      for t in (x, r, gamma.to(dtype), beta.to(dtype)))
    composed = lambda: F.layer_norm(
        F.dropout(xg, TRAIN_P_DROP, training=True) + rg, (dd,), gg, bg, 1e-5)
    yc = composed()
    composed_bwd = lambda: torch.autograd.grad(
        yc, (xg, rg, gg, bg), dy, retain_graph=True)
    with torch.no_grad():
        composed_fwd_ms = device_ms(composed)
        composed_fwd_events_ms = cuda_ms(composed, iters=20)
    fwdb, bwdb = dln_bounds(n, dd, dtype)
    out[dln.FWD_KERNEL_NAME] = dict(
        ms=dev["dln_fwd_kernel"], wrapper_events_ms=cuda_ms(dfwd, iters=20),
        plain_ms=device_ms(lambda: dln.dln_forward_reference(
            x, r, bits, gamma, beta, keep, 1e-5)),
        library_ms=None, composed_ms=composed_fwd_ms,
        composed_events_ms=composed_fwd_events_ms,
        composed="F.dropout + add + F.layer_norm forward",
        bound_ms=fwdb[0], bound_by=fwdb[1])
    out[dln.BWD_KERNEL_NAME] = dict(
        ms=dev["dln_bwd_kernel"] + dev["dln_bwd_sum_kernel"],
        rows_kernel_ms=dev["dln_bwd_kernel"],
        partial_sum_ms=dev["dln_bwd_sum_kernel"],
        wrapper_events_ms=cuda_ms(dbwd, iters=20),
        plain_ms=device_ms(lambda: dln.dln_backward_reference(
            dy, z, bits, gamma, mean, inv, keep)),
        library_ms=None, composed_ms=device_ms(composed_bwd),
        composed_events_ms=cuda_ms(composed_bwd, iters=20),
        composed="F.dropout + add + F.layer_norm backward",
        bound_ms=bwdb[0], bound_by=bwdb[1])
    return out


def time_training(model, seed):
    """Step time, padded tokens/s and peak memory of TIMED_STEPS more
    training steps on the trained model, and the device profile of one
    step."""
    trainer = model.trainer
    x, y, real_tokens = train_data(seed, TRAIN_BATCH)
    batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p50 = percentile(step_s, 50)
    l = BERT_CONFIG["seq_len"]
    return dict(
        steps=TIMED_STEPS, batch=TRAIN_BATCH, step_ms=[1e3 * s for s in
                                                      step_s],
        step_p50_ms=1e3 * p50, padded_tokens_per_s=TRAIN_BATCH * l / p50,
        real_tokens_per_s=real_tokens / p50, peak_memory_bytes=peak,
        clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                          "temperature.gpu"),
        profile=profile_device(lambda: trainer.train_step(batch)))


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, requests, training data "
                         "and kernel inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is visible; it runs on the "
                 "GPU only")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _kernels.library()
    wall = time.perf_counter() - t0
    sass = _kernels.sass_opcode_counts(_kernels.BUILD_INFO["library"])
    emit("build", wall_s=wall, tensor_core_instructions=sass,
         **_kernels.BUILD_INFO)
    check_tensor_cores(sass)

    # 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fwd_err = check_forward(dev, args.seed)
    bwd_err = check_backward(dev, args.seed)
    check_autograd(dev, args.seed)
    dln_err = check_dln(dev, args.seed)

    # 4. serve
    ctx = init_nncontext()
    if ctx.device != dev:
        raise AssertionError(f"init_nncontext() chose {ctx.device}")
    t0 = time.perf_counter()
    model = build_classifier(args.seed)
    cpu_model = copy.deepcopy(model)
    build_s = time.perf_counter() - t0
    im = InferenceModel(supported_concurrent_num=CLIENTS).load_keras_net(
        model)
    l = BERT_CONFIG["seq_len"]
    warm = im.warm([(l,), (l,), (l,), (1, 1, l)], [BATCH])
    requests, real_tokens = make_requests(args.seed, REQUESTS, BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    outputs, latency, wall = serve(im, requests, CLIENTS)
    serve_launches = _kernels.LAUNCHES.snapshot()
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = BERT_CONFIG["n_block"] * REQUESTS
    if serve_launches != {attn.KERNEL_NAME: expected}:
        raise AssertionError(f"launches {serve_launches}, expected "
                             f"{{{attn.KERNEL_NAME!r}: {expected}}}")
    row_sum_err = check_outputs(outputs, BATCH)
    cpu_err = check_cpu_row(cpu_model, requests[0], outputs[0][0])
    del cpu_model
    emit("serve", model="BERT-base classifier (bench.py:353-438)",
         config=BERT_CONFIG, seed=args.seed, requests=REQUESTS,
         batch=BATCH, clients=CLIENTS, real_tokens=real_tokens,
         padded_tokens=REQUESTS * BATCH * l, build_s=build_s,
         warm_s=warm[BATCH], launches=serve_launches,
         launches_expected=expected, max_row_sum_err=row_sum_err,
         row_sum_tol=ROW_SUM_TOL, cpu_row_max_abs_err=cpu_err,
         cpu_tol=CPU_TOL,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         wall_s=wall, latency_s=latency, peak_memory_bytes=peak_bytes)

    # 5. train
    trained, train_report = train(args.seed)
    train_launches = train_report["launches"]
    emit("train", **train_report)
    check_train_parity(args.seed, dev)

    # 6. timing
    timed = [requests[i % REQUESTS] for i in range(TIMED_REQUESTS)]
    _, t_latency, t_wall = serve(im, timed, CLIENTS)
    kern = {dt: time_kernel(dev, args.seed, dt)
            for dt in (torch.float32, torch.bfloat16)}
    emit("timing", path="serve", card=smi, requests=TIMED_REQUESTS,
         batch=BATCH, clients=CLIENTS,
         latency_p50_ms=1e3 * percentile(t_latency, 50),
         latency_p95_ms=1e3 * percentile(t_latency, 95),
         padded_tokens_per_s=TIMED_REQUESTS * BATCH * l / t_wall,
         real_tokens_per_s=real_tokens * TIMED_REQUESTS / REQUESTS / t_wall,
         wall_s=t_wall, peak_memory_bytes=peak_bytes,
         flash_fwd=list(kern.values()),
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"),
         profile=profile_device(lambda: im.predict(requests[0])))
    emit("timing", path="train", card=smi, **time_training(trained,
                                                           args.seed))
    train_kern = {dt: time_training_kernels(dev, args.seed, dt)
                  for dt in (torch.float32, torch.bfloat16)}
    for dt, rows in train_kern.items():
        emit("timing", path="kernels at the training shape", card=smi,
             dtype=dtype_name(dt), shape=dict(B=TRAIN_SHAPE[0],
                                              L=TRAIN_SHAPE[1],
                                              H=TRAIN_SHAPE[2],
                                              d=TRAIN_SHAPE[3],
                                              N=DLN_SHAPE[0],
                                              D=DLN_SHAPE[1]),
             kernels=rows)

    f32 = train_kern[torch.float32]
    errs = {attn.KERNEL_NAME: fwd_err[torch.float32],
            attn.DQ_KERNEL_NAME: bwd_err[torch.float32]["dq"],
            attn.DKV_KERNEL_NAME: bwd_err[torch.float32]["dkv"],
            dln.FWD_KERNEL_NAME: dln_err[torch.float32]["fwd"],
            dln.BWD_KERNEL_NAME: dln_err[torch.float32]["bwd"]}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        row = f32[name]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=train_launches[name],
                     max_abs_err=errs[name], ms=row["ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"],
                     library_ms=row["library_ms"])
        if name == attn.KERNEL_NAME:
            serve_row = kern[torch.float32]
            entry.update(launches_serve=serve_launches[name],
                         ms_serve=serve_row["ms"],
                         bound_ms_serve=serve_row["bound_ms"],
                         library_ms_serve=serve_row["library_ms"])
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
