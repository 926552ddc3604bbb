#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

It runs from the root of a checkout of the repository, on a machine with
a CUDA card, PyTorch built for CUDA and the CUDA toolkit (``nvcc``). It
imports nothing of JAX or of the JAX package. Phases, one JSON line each:

1. device  -- the card, the device count, ``nvidia-smi``'s name and power
              limit, the software versions.
2. build   -- every kernel of the path built from ``ops/csrc`` with nvcc
              for sm_90a: seconds, and the ``-Xptxas -v`` register, shared
              memory and spill lines.
3. kernels -- the flash-attention forward kernel against its plain
              PyTorch version on the card, one line per case and dtype.
4. serve   -- the BERT-base classifier of ``bench.py`` (full width and
              depth, weights from ``--seed``) behind ``InferenceModel``
              answers 8 requests of 8 x 512 tokens from 2 client threads;
              outputs are checked, the kernel's launch count is read, and
              one row is checked against the port's own CPU run.
5. timing  -- request latency, tokens/s and peak memory of the served
              model; the kernel's time at the serving shape beside its
              plain version, ``scaled_dot_product_attention`` and its
              bound; and ``torch.profiler``'s device time by kernel group
              over one request.

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
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

# bench.py's BERT-base classifier (bench.py:353-438)
BERT_CONFIG = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                   seq_len=512, intermediate_size=3072,
                   output_all_block=False)
N_CLASSES = 2
REQUESTS, BATCH, CLIENTS = 8, 8, 2
TIMED_REQUESTS = 32
MIN_LEN = 64

# kernel against plain version, element by element,
# |o - ro| <= atol + rtol * |ro|. float32: the kernel sums in another
# order, 1e-4. bfloat16: both round o to bf16, and the kernel rounds p
# against its running max where the plain version uses the final max; so
# two bf16 steps at |ro| (a step is at most 2**-7 |ro|) plus a quarter
# step at unit scale (|v| ~ 1) for p's rounding. lse is float32
# arithmetic in both dtypes and is held at 1e-4 in both.
O_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -9, 2 ** -6)}
LSE_TOL = 1e-4
# the served probabilities against the port's CPU run of the same row:
# 12 blocks of f32 matmuls summed in another order (TF32 off on the card)
CPU_TOL = 1e-4
ROW_SUM_TOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu"
KERNEL_REPLACES = "analytics_zoo_tpu/ops/attention.py:378"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


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


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def qkv_views(b, lq, lk, h, d, dtype, device, gen):
    """q, k, v as the strided (B, L, H, d) views of one fused projection,
    the way the transformer block hands them to the kernel."""
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
    ("bert_base", BATCH, 512, 512, 12, 64, False, True),
    ("causal_square", 2, 512, 512, 12, 64, True, False),
    ("causal_lq_lt_lk", 2, 128, 512, 12, 64, True, False),
    ("ragged_300", 2, 300, 300, 12, 64, False, True),
    ("head_dim_128", 2, 512, 512, 6, 128, True, True),
    ("decode_row", 2, 1, 77, 12, 64, True, True),
]


def check_kernels(device, seed):
    """Every case in f32 and bf16: the kernel against its plain version
    on the same inputs. Returns {dtype: max |do| of the serving shape}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    serving_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, lq, lk, h, d, causal, padded in KERNEL_CASES:
            q, k, v = qkv_views(b, lq, lk, h, d, dtype, device, gen)
            kb = key_bias(b, lk, padded, device, gen)
            o, lse = attn.flash_forward_blhd(q, k, v, kb, causal)
            torch.cuda.synchronize()
            ro, rl = attn.flash_forward_reference(q, k, v, kb, causal,
                                                  1.0 / math.sqrt(d))
            atol, rtol = O_TOL[dtype]
            diff = (o.float() - ro.float()).abs()
            err_o = diff.max().item()
            o_over_limit = (diff / (atol + rtol * ro.float().abs())) \
                .max().item()
            err_lse = (lse - rl).abs().max().item()
            emit("kernels", kernel=attn.KERNEL_NAME, case=name,
                 dtype=str(dtype).replace("torch.", ""),
                 shape=dict(B=b, Lq=lq, Lk=lk, H=h, d=d), causal=causal,
                 key_bias=padded, max_abs_err_o=err_o,
                 o_tol=dict(atol=atol, rtol=rtol),
                 max_o_err_over_limit=o_over_limit,
                 max_abs_err_lse=err_lse, lse_tol=LSE_TOL)
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"{name} {dtype}: non-finite output")
            if o_over_limit > 1.0 or err_lse > LSE_TOL:
                raise AssertionError(
                    f"{name} {dtype}: kernel disagrees with its plain "
                    f"version (o {err_o}, {o_over_limit} x its limit; "
                    f"lse {err_lse}, tol {LSE_TOL})")
            if name == "bert_base":
                serving_err[dtype] = err_o
    return serving_err


def flash_bound_ms(b, lq, lk, h, d, dtype):
    """The least time the card could take for one non-causal flash
    forward: q, k, v, the key bias read once, o and lse written once,
    over the memory rate; 4*B*H*Lq*Lk*d operations over the dtype's peak.
    Returns (ms, what bounds it)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * esize + \
        4 * b * lk + 4 * b * h * lq
    ops = 4 * b * h * lq * lk * d
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernel(device, seed, dtype):
    """Kernel, plain version and SDPA at the serving shape."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, l, h, d = BATCH, BERT_CONFIG["seq_len"], BERT_CONFIG["n_head"], \
        BERT_CONFIG["hidden_size"] // BERT_CONFIG["n_head"]
    q, k, v = qkv_views(b, l, l, h, d, dtype, device, gen)
    kb = key_bias(b, l, True, device, gen)
    scale = 1.0 / math.sqrt(d)
    mask = kb[:, None, None, :].to(dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, bound_by = flash_bound_ms(b, l, l, h, d, dtype)
    return dict(
        dtype=str(dtype).replace("torch.", ""),
        shape=dict(B=b, L=l, H=h, d=d),
        ms=cuda_ms(lambda: attn.flash_forward_blhd(q, k, v, kb, False)),
        plain_ms=cuda_ms(lambda: attn.flash_forward_reference(
            q, k, v, kb, False, scale), iters=10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale)),
        bound_ms=bound, bound_by=bound_by)


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


def kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (port kernel)"
    if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def profile_request(im, request):
    """Device time by kernel group over one request served alone, from
    ``torch.profiler``: the groups' sums, their shares of the request's
    wall time, and the device's idle share. None where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.predict(request)
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


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, requests and kernel inputs")
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
    emit("build", wall_s=time.perf_counter() - t0, **_kernels.BUILD_INFO)

    # 3. kernels against their plain versions
    dev = torch.device("cuda", 0)
    serving_err = check_kernels(dev, args.seed)

    # 4. serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    launches = _kernels.LAUNCHES.snapshot()
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = BERT_CONFIG["n_block"] * REQUESTS
    if launches != {attn.KERNEL_NAME: expected}:
        raise AssertionError(f"launches {launches}, expected "
                             f"{{{attn.KERNEL_NAME!r}: {expected}}}")
    row_sum_err = check_outputs(outputs, BATCH)
    cpu_err = check_cpu_row(cpu_model, requests[0], outputs[0][0])
    emit("serve", model="BERT-base classifier (bench.py:353-438)",
         config=BERT_CONFIG, seed=args.seed, requests=REQUESTS,
         batch=BATCH, clients=CLIENTS, real_tokens=real_tokens,
         padded_tokens=REQUESTS * BATCH * l, build_s=build_s,
         warm_s=warm[BATCH], launches=launches, launches_expected=expected,
         max_row_sum_err=row_sum_err, row_sum_tol=ROW_SUM_TOL,
         cpu_row_max_abs_err=cpu_err, cpu_tol=CPU_TOL,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         wall_s=wall, latency_s=latency, peak_memory_bytes=peak_bytes)

    # 5. timing
    timed = [requests[i % REQUESTS] for i in range(TIMED_REQUESTS)]
    _, t_latency, t_wall = serve(im, timed, CLIENTS)
    kern = {dt: time_kernel(dev, args.seed, dt)
            for dt in (torch.float32, torch.bfloat16)}
    emit("timing", card=smi, requests=TIMED_REQUESTS, batch=BATCH,
         clients=CLIENTS, latency_p50_ms=1e3 * percentile(t_latency, 50),
         latency_p95_ms=1e3 * percentile(t_latency, 95),
         padded_tokens_per_s=TIMED_REQUESTS * BATCH * l / t_wall,
         real_tokens_per_s=real_tokens * TIMED_REQUESTS / REQUESTS / t_wall,
         wall_s=t_wall, peak_memory_bytes=peak_bytes,
         flash_fwd=list(kern.values()),
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"),
         profile=profile_request(im, requests[0]))

    f32 = kern[torch.float32]
    print(json.dumps({"kernels": [dict(
        name=attn.KERNEL_NAME, route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches[attn.KERNEL_NAME],
        max_abs_err=serving_err[torch.float32], ms=f32["ms"],
        plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"])]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
