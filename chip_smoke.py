#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training (float32 and bf16),
generation, NeuralCF, checkpoint, sequence-model, ResNet-50, Cluster
Serving and int8 inference paths once on one NVIDIA GPU.

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
              ``train_bf16``: the same in bfloat16 (``set_compute_dtype``)
              on int32 ids: every kernel launch given bf16 tensors, the
              parameters, gradients and Adam moments float32, the
              dropout-off step against the port's CPU bf16 step, and the
              float32 and bf16 steps timed in alternating windows (the
              bf16 step's device time by kernel group beside them).
6. timing  -- request latency, tokens/s and peak memory of the served
              model and the forward kernel at the serving shape (profiler
              device time, CUDA events beside it); the
              training step's time, tokens/s, peak memory and
              ``torch.profiler`` device time by kernel group; and each
              kernel at the training shape beside its plain version, its
              bound and the PyTorch library call where there is one.
7. generate -- a GPT-width ``TransformerLayer`` (GPT-1's 12 blocks, 768
              wide, 12 heads, 512 positions, vocab 40990; weights from
              ``--seed``) generates through ``ContinuousBatchScheduler``
              over ``TransformerDecodeEngine``: 16 greedy requests of 48
              tokens on 8 slots (every request committed once with 48
              tokens; the flash forward launched 12 times a prefill and
              nothing else; one request's prefill logits and first 16
              tokens against the port's CPU run; tokens/s, TTFT, the
              decode step at a full gang, peak memory); then 8 requests
              of 24 tokens through chunked joins, prefix-cache hits, int8
              slabs and speculative decoding with a 2-block draft, each
              stream equal to the plain one (int8: agreement reported);
              ``decode_chunk`` against repeated ``decode_step`` and the
              cached-decode probe on the card; and the timing of prefill
              (B=1 x 512, B=4 x 384; the flash forward there beside its
              bound and SDPA) and of one decode step at a gang of 8 and
              capacity 512 (wall, host enqueue, device busy and idle).
8. ncf     -- ``bench.py``'s NeuralCF (MovieLens-1M's 6040 users and
              3706 items, 5 classes, embeddings of 20, hidden 40-20-10,
              MF branch; weights from ``--seed``) through ``fit`` on
              bench.py's 262,144 synthetic ratings at batch 8192, float32:
              steps/s as bench_ncf reckons it (a warm-up epoch, then 3
              windows of 2 epochs), the loss finite and falling,
              ``evaluate``, one step's launches and device idle share;
              ``predict`` on the card against the CPU, ``predict_classes``,
              ``predict`` on a feature set and ``recommend_for_user``.
9. checkpoint -- the engine's checkpoint store, failure policy,
              accumulation and persistence on the ``train_bf16``
              classifier (bf16, int32 ids, dropout 0.1, Adam) over 8
              distinct batches of 32 x 512 (random labels) for 2 epochs,
              a checkpoint every 4 steps, keeping 2: a reference run with
              TensorBoard summaries (one Loss a 2-step window, each the
              step loss it names) and validation; a run whose step 10
              fails (``ZOO_TPU_FAULT=step:raise@10``) and is retried from
              ``ckpt-8`` in the same ``fit``; a run preempted at step 6
              (the drain writes ``ckpt-6``) and a new model from another
              seed resuming it (``auto_resume``); a run with async
              writes. Each equals the reference bit for bit (parameters,
              Adam moments, step, losses), and the async run's files
              carry the reference's crc32c. A byte flipped in the newest
              ``optim.npz`` falls back to ``ckpt-12``, equal to the
              reference's state there. Accumulation 4 launches K1-K5
              48/48/48/96/96 a step; its step time and peak memory beside
              accumulation 1's; a dropout-off step against accumulation 1
              in float32 and bf16. ``save_model`` then
              ``InferenceModel.load`` serves the trained classifier and a
              ResNet-50 ``ZooModel`` (seeded moving statistics) bit for
              bit against ``predict``. Reported: checkpoint bytes, each
              save's seconds (snapshot, serialisation, crc32c, write), the
              async stall, load seconds, crc32c GB/s, the step with an
              async checkpoint every 4 steps against none in alternating
              windows, free disk. Its directories, under
              ``build/chip_smoke_checkpoint``, are deleted at the end.
10. sequence -- the recurrent layers through the zoo's sequence models,
              float32, TF32 off, weights from ``--seed``. The
              TextClassifier of the reference's news20 example (20
              classes, 500 tokens, a seeded (5001, 200) table through a
              frozen ``WordEmbedding``, encoder 256, batch 128, Adagrad
              0.01) with each encoder (cnn, lstm, gru): ``predict`` on 32
              rows against the port's CPU run; 8 ``fit`` steps on one batch
              (the loss finite and falling, a gradient on every trainable
              parameter, the table unmoved); ``evaluate``; the three steps
              timed in alternating windows (p50, launches a step, device
              busy and idle share, peak memory). Then AnomalyDetector
              (unroll 24, hidden 8-32-15, dropouts 0.2, batch 1024), KNRM
              (10 + 40 tokens, vocab 20,000, 300-d, 21 kernels; ranking
              by the reference's route: 32 queries and 512 documents as
              TextSets through tokenize, normalize, word2idx and
              shape_sequence, ``TimeDistributed(knrm.model)`` fitted with
              ``rank_hinge`` on the 256 pairs of ``from_relation_pairs``,
              NDCG@3 and MAP on ``from_relation_lists``; classification
              on arrays; NDCG@3 and MAP against the CPU),
              SessionRecommender (10,000 items, widths 40-20, with
              history; ``recommend_for_session`` against the CPU) and
              Seq2seq (LSTM, 2 layers of 256, a dense
              bridge, a TimeDistributed generator; ``infer`` against the
              CPU's and against ``infer_reference`` with a stop sign):
              ``predict`` against the CPU and 4 falling ``fit`` steps each.
              The launch counts are set to 0 as the phase starts and read
              as it ends (and after each fit and infer): K1-K5 are
              launched 0 times in the whole phase, timed and profiled
              steps included, and the summary line's
              ``launches_sequence`` is that count.
11. resnet -- ``bench.py``'s ResNet-50 leg: ``ImageClassifier(1000,
              "resnet-50")`` on 3 x 224 x 224 (weights from ``--seed``):
              ``predict`` and one SGD step (float32 and bf16, on 3
              starts with the residual branches' last gammas drawn from
              U(0.1, 0.25)) against the port's CPU run: the loss, the
              moving statistics and every layer's forward and backward
              from the card's own inputs;
              ``fit`` for 8 steps in bf16 at batch 256 on one seeded batch
              (the loss finite and falling, every BatchNorm's float32
              moving statistics moved, float32 weights, gradients and SGD
              state, a gradient on every convolution, the five kernels
              launched 0 times, ``evaluate``, ``predict`` rows summing to
              1); the bf16 and float32 steps in alternating windows (p50,
              images/s, MFU by bench.py's count, peak memory, device time
              by kernel group, the SGD update's share).
12. cluster_serving -- Cluster Serving: the ``resnet`` phase's ResNet-50
              (weights from ``--seed``, saved with ``save_model`` and
              deployed by ``InferenceModel.load``) and the ``generate``
              phase's GPT-width decoder (``build_transformer_engine``)
              behind one ``ClusterServing`` (config as a dict: batch 16,
              buckets 1-16, top 5, 2 decode workers, 8 generate slots,
              ``max_len`` 512, 32 new tokens) on a ``FileStreamQueue``.
              A client process writes 256 predict records of (3, 224,
              224) float32 and 32 generate records (prompts of 32-448
              tokens, every 9th record) as fast as it can and waits for
              all 288 with ``OutputQueue.wait_all``. Gated: every uri
              answered once, no duplicate or gap in the queue's ledger,
              nothing dropped, dead-lettered or shed; ``warmup`` ran all
              5 buckets; the top-5 rows against the port's CPU predict
              (16 images, 1e-4) and the card's direct predict (all, 1e-5;
              two classes within the tolerance may trade places); every
              stream equal to the scheduler's alone on the same engine,
              8 also to ``greedy_reference``; K1 launched 12 times a
              prefill and K2-K5 never, in the main run and over the phase.
              Then a ``ModelRegistry`` with v1 and v2 (seed + 1; a canary
              of weight 0.5) behind ``RoutedClusterServing`` on the
              in-process queue: 64 records, each against its version's
              direct predict, the canary's share against crc32 of the
              uris; v2 promoted, v1 undeployed, the manifest listing v2
              alone. Timed: the pipelined and synchronous loops in
              alternating windows of 128 records (records/s, per-row
              queue, device and server ms p50/p95, buckets), a window's
              device busy and idle share, warm-up a bucket, TTFT,
              end-to-end and tokens/s of the generate records, peak
              memory. Its files, under ``build/chip_smoke_serving``, are
              deleted at the end.
13. int8   -- int8 inference (``QuantizedModel``), float32 with TF32 off,
              weights from ``--seed``: ``bench.py``'s bench_quant MLP
              (512-1024-1024-128, batch 64) and CNN (3 x 64 x 64, batch
              8), calibrated on 3 seeded batches: the JAX package's chain
              plan, and under a ``TorchDispatchMode`` census one int32
              product a kernel (``torch._int_mm``), no float product, a
              rounding a chain edge plus the entry quantize and one
              division; ``ImageClassifier(1000, "vgg-16")`` on 3 x 224 x
              224 calibrated on 4 seeded batches of 8: 15 chain edges, 16
              int32 products, one division, one softmax; 2 images against
              the port's CPU int8 run from the same scales (every int32
              accumulator and int8 activation equal, the softmax within
              1e-6); ``save_calibration`` then ``load_quantized`` (the
              same chains, the rows bit for bit); ResNet-50 (54 kernels,
              no chain) deployed as v1 float32 and v2 int8
              (``deploy(quantize=True)`` of the same directory, canary
              0.5) behind ``RoutedClusterServing``: 64 records each
              against its version's direct predict, distinct dispatch
              keys, ``recover`` reloading v2 as int8, 2 rows against the
              CPU's int8 run (the top class equal, within 2e-2 of the
              row's largest probability: the float batch norm between int8
              convolutions rounds differently on the card); int8 against
              float32 reported. Timed: both models in float32 and int8 at
              batch 16 and 64 in alternating windows (records/s, device
              time by group, launches, idle share, peak memory), the
              parameter bytes and the phase's peak memory. K1-K5 are
              launched 0 times in the phase. Its files, under
              ``build/chip_smoke_int8``, are deleted at the end.

Then the ``{"kernels": [...]}`` summary, ``nvidia-smi``'s line, and as the
last line ``{"ok": true, "device": {...}}``. Every check raises on
failure: the script then exits non-zero and prints no result. Without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import gc
import json
import logging
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import init_nncontext
from analytics_zoo_tpu_torch.common.zoo_trigger import (SeveralIteration,
                                                        ZooTrigger)
from analytics_zoo_tpu_torch.feature.common import Relation
from analytics_zoo_tpu_torch.feature.feature_set import (ArrayFeatureSet,
                                                         Sample)
from analytics_zoo_tpu_torch.feature.text import TextFeature, TextSet
from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier
from analytics_zoo_tpu_torch.models.recommendation import (
    NeuralCF, SessionRecommender, UserItemFeature)
from analytics_zoo_tpu_torch.models.seq2seq import (Bridge, RNNDecoder,
                                                    RNNEncoder, Seq2seq)
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as attn
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as dln
from analytics_zoo_tpu_torch.ops import kv_cache
from analytics_zoo_tpu_torch.ops import quant
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (Model,
                                                            Sequential)
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    Adagrad, Adam, get_optimizer)
from analytics_zoo_tpu_torch.pipeline.engine import (SPMDTrainer,
                                                     TrainingPreempted,
                                                     clear_preemption,
                                                     request_preemption)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             ClusterServingHelper,
                                             FileStreamQueue,
                                             InProcessStreamQueue,
                                             InputQueue, ModelRegistry,
                                             OutputQueue,
                                             RoutedClusterServing)
from analytics_zoo_tpu_torch.serving.generation import (
    ContinuousBatchScheduler, GenRequest, PrefixCache,
    SpeculativeDecodeEngine, TransformerDecodeEngine)
from analytics_zoo_tpu_torch.utils import faults
from analytics_zoo_tpu_torch.utils.crc32c import crc32c
from analytics_zoo_tpu_torch.utils.layer_parity import (LayerRecorder,
                                                        compare_layers)
from analytics_zoo_tpu_torch.utils.op_census import OpCensus

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

# the bf16 step, dropout off, card against the port's CPU bf16 step:
# first estimates (both sides round the same products to bf16 at other
# places: a few 2**-8 relative on the loss and on each gradient)
BF16_LOSS_TOL = 2e-2
BF16_GRAD_TOL = 5e-2
# the f32 and bf16 training steps timed in alternating windows
DTYPE_WINDOWS = 2

# bench.py's NeuralCF (bench.py:155-162, bench_ncf :262-300): MovieLens-1M's
# users and items, 5 rating classes, embeddings of 20, hidden 40/20/10,
# batch 8192, 262,144 synthetic ratings (make_data :253-259), Adam at 1e-3,
# float32 (the NCF ids are float32, and bf16 would round them: ROADMAP C4)
NCF_USERS, NCF_ITEMS, NCF_CLASSES = 6040, 3706, 5
NCF_KW = dict(user_embed=20, item_embed=20, hidden_layers=[40, 20, 10],
              include_mf=True, mf_embed=20)
NCF_BATCH, NCF_SAMPLES, NCF_TIMED_EPOCHS, NCF_WINDOWS = 8192, 262144, 2, 3
NCF_PREDICT_ROWS, NCF_RECOMMEND_FEATURES, NCF_MAX_ITEMS = 8192, 2000, 5
# the card's predictions against the port's CPU run: float32 products of
# at most 60 terms summed in another order
NCF_CPU_TOL = 1e-5

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


#: the key bias of a generation prefill (``TransformerLayer.prefill``)
PREFILL_BIAS = "prefill -1e9"


def key_bias(b, lk, padded, device, gen):
    """BERT's padding bias: noise on the kept keys and -10000 on a ragged
    tail of padding keys per row; zeros when ``padded`` is false. With
    ``padded == PREFILL_BIAS``, a generation prefill's: 0 on each
    prompt's keys and -1e9 past its seeded length, the longest row
    unpadded."""
    if not padded:
        return torch.zeros(b, lk, device=device)
    kb = 0.5 * torch.randn(b, lk, device=device, generator=gen)
    lengths = torch.randint(1, lk + 1, (b,), device=device, generator=gen)
    keys = torch.arange(lk, device=device)[None, :]
    if padded == PREFILL_BIAS:
        lengths[0] = lk
        kb = torch.zeros_like(kb)
        return torch.where(keys < lengths[:, None], kb,
                           torch.full_like(kb, -1e9))
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
    # a batched join's prefill: causal at a ragged length with the
    # generation path's -1e9 padding bias
    ("join_prefill_300", 4, 300, 300, 12, 64, True, PREFILL_BIAS),
]
# the backward's cases: the forward's, less the serving and generation
# shapes, plus causal tile edges at d=128 and causal Lq < Lk with a wide
# offset
BWD_CASES = [c for c in KERNEL_CASES
             if c[0] not in ("bert_base", "decode_row",
                             "join_prefill_300")] + [
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
    if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas",
                               "nvjet")):
        return "matmul (cuBLAS)"
    if "indexing_backward" in name:
        return "embedding gradient (index_put accumulate)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def profile_device(fn, group_of=None):
    """Device time by kernel group (``group_of``, ``kernel_group`` by
    default) over one call of ``fn``, from ``torch.profiler``: the
    groups' sums, their shares of the call's wall time, and the device's
    idle share. None where the profiler recorded no device time."""
    group_of = group_of or kernel_group
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups, other = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = group_of(evt.key)
        g = groups.setdefault(group, {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += evt.self_device_time_total / 1e3
        g["launches"] += evt.count
        if group == "other":
            other.append((evt.self_device_time_total / 1e3, evt.key[:80]))
    busy_ms = sum(g["device_ms"] for g in groups.values())
    if busy_ms == 0.0:
        return dict(wall_ms=wall_us / 1e3, groups=None, idle_share=None)
    for g in groups.values():
        g["share_of_wall"] = 1e3 * g["device_ms"] / wall_us
    if other:   # the largest kernels no group claimed, by name
        groups["other"]["top"] = sorted(other, reverse=True)[:3]
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

def train_data(seed, n, config=BERT_CONFIG, min_len=MIN_LEN,
               ids=np.float32):
    """n rows of [tokens, positions, segments, mask] and 0/1 labels,
    lengths in [min_len, L]; the ids as ``ids`` (float32, or int32 as
    bench.py feeds BERT: bf16 would round float ids above 256), the mask
    and labels float32. The first token (a [CLS]-like id) carries the
    label, so the classifier has something to learn."""
    rs = np.random.default_rng(seed)
    l = config["seq_len"]
    lengths = rs.integers(min_len, l + 1, size=n)
    labels = rs.integers(0, N_CLASSES, size=n)
    tokens = rs.integers(1000, config["vocab"], size=(n, l))
    tokens[:, 0] = 101 + labels
    pos = np.arange(l)[None, :]
    x = [tokens.astype(ids),
         np.repeat(pos.astype(ids), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(ids),
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


def check_float32_state(model):
    """Every parameter, gradient and Adam moment of a trained model is
    float32 (bf16 compute keeps float32 master weights)."""
    for name, p in model.named_parameters():
        if p.dtype != torch.float32 or (p.grad is not None and
                                        p.grad.dtype != torch.float32):
            raise AssertionError(f"{name}: {p.dtype}, gradient "
                                 f"{None if p.grad is None else p.grad.dtype}")
    moments = model.trainer.opt_state[0]
    bad = [k for part in ("mu", "nu") for k, t in moments[part].items()
           if t.dtype != torch.float32]
    if bad:
        raise AssertionError(f"Adam moments not float32: {bad}")


def train(seed, compute_dtype="float32"):
    """Model.compile + Model.fit in ``compute_dtype``, TRAIN_STEPS steps on
    one batch (float32 ids in float32, int32 ids in bfloat16), with the
    launch counts and the dtypes the kernels were given read around the
    fit calls; then evaluate."""
    bf16 = compute_dtype == "bfloat16"
    config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    model = build_classifier(seed + 1, config)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.set_compute_dtype(compute_dtype)
    x, y, real_tokens = train_data(seed, TRAIN_BATCH,
                                   ids=np.int32 if bf16 else np.float32)
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
    launch_dtypes = _kernels.LAUNCHES.by_dtype()
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
    if launch_dtypes != {k: {compute_dtype: n} for k, n in expected.items()}:
        raise AssertionError(f"the kernels were given {launch_dtypes}, "
                             f"expected {compute_dtype} only")
    check_float32_state(model)
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
        seed=seed, compute_dtype=compute_dtype,
        ids=dtype_name(torch.int32 if bf16 else torch.float32),
        optimizer=f"adam lr {TRAIN_LR}",
        loss="sparse_categorical_crossentropy", batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, real_tokens_per_batch=real_tokens,
        losses=losses, min_qkv_w_grad_after_step_1=min_qkv_grad,
        launches=launches, launches_per_step=per_step,
        launch_dtypes=launch_dtypes, float32_params_and_moments=True,
        fit_wall_s=wall, peak_memory_bytes=peak, evaluate=results,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32)


def check_train_parity(seed, device, compute_dtype="float32"):
    """One training step in ``compute_dtype``, dropout off, on PARITY_ROWS
    rows: the card (the flash kernels run, the dropout+add+LN kernels do
    not) against the port's CPU run (plain versions) from the same
    weights. Returns the gaps, which must lie within the dtype's limits."""
    bf16 = compute_dtype == "bfloat16"
    loss_tol, grad_tol = (BF16_LOSS_TOL, BF16_GRAD_TOL) if bf16 else \
        (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)
    config = dict(BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0)
    model = build_classifier(seed + 2, config)
    cpu_model = copy.deepcopy(model)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    card = SPMDTrainer(model, loss_fn, get_optimizer("adam"), device=device,
                       compute_dtype=compute_dtype)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("adam"),
                      device="cpu", compute_dtype=compute_dtype)
    x, y, _ = train_data(seed + 2, PARITY_ROWS,
                         ids=np.int32 if bf16 else np.float32)
    batch = (x, y, np.ones(PARITY_ROWS, np.float32))
    card.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    card_loss = card.loss_and_grads(card.put_batch(batch)).item()
    launches = _kernels.LAUNCHES.snapshot()
    launch_dtypes = _kernels.LAUNCHES.by_dtype()
    n_block = BERT_CONFIG["n_block"]
    expected = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block}
    if launches != expected or any(set(v) != {compute_dtype}
                                   for v in launch_dtypes.values()):
        raise AssertionError(f"parity step launches {launch_dtypes}, "
                             f"expected {expected} in {compute_dtype}")
    t0 = time.perf_counter()
    cpu_loss = cpu.loss_and_grads(cpu.put_batch(batch)).item()
    cpu_s = time.perf_counter() - t0
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
    res = dict(rows=PARITY_ROWS, dropout=0.0, compute_dtype=compute_dtype,
               launches=launches, card_loss=card_loss, cpu_loss=cpu_loss,
               loss_err=loss_err, loss_tol=loss_tol,
               max_grad_rel_err=worst, max_grad_rel_err_param=worst_name,
               grad_tol=grad_tol, cpu_step_s=cpu_s)
    if loss_err > loss_tol or worst > grad_tol:
        emit("train_parity", ok=False, **res)
        raise AssertionError(f"card step differs from the CPU run: loss "
                             f"{loss_err}, gradient {worst} ({worst_name})")
    return res


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


def time_train_dtypes(models, seed):
    """The float32 and the bf16 training step on one int32-id batch, timed
    in alternating windows of TIMED_STEPS steps (f32, bf16, bf16, f32,
    ...): each step's wall (host clock around a synchronised step), the
    p50, tokens/s and the peak memory of each window; then the bf16
    step's device time by kernel group. Both models stay on the card, so
    each peak includes the other model's weights and optimizer state."""
    x, y, real_tokens = train_data(seed, TRAIN_BATCH, ids=np.int32)
    host = (x, y, np.ones(TRAIN_BATCH, np.float32))
    batches = {dt: m.trainer.put_batch(host) for dt, m in models.items()}
    step_s = {dt: [] for dt in models}
    peaks = {dt: [] for dt in models}
    order = list(models)
    for w in range(DTYPE_WINDOWS):
        for dt in (order if w % 2 == 0 else order[::-1]):
            trainer = models[dt].trainer
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batches[dt])
                torch.cuda.synchronize()
                step_s[dt].append(time.perf_counter() - t0)
            peaks[dt].append(torch.cuda.max_memory_allocated())
    l = BERT_CONFIG["seq_len"]
    out = {}
    for dt in models:
        p50 = percentile(step_s[dt], 50)
        out[dt] = dict(step_ms=[1e3 * t for t in step_s[dt]],
                       step_p50_ms=1e3 * p50,
                       padded_tokens_per_s=TRAIN_BATCH * l / p50,
                       real_tokens_per_s=real_tokens / p50,
                       peak_memory_bytes=max(peaks[dt]))
    bf16 = models["bfloat16"].trainer
    out["bfloat16"]["profile"] = profile_device(
        lambda: bf16.train_step(batches["bfloat16"]))
    out["bf16_speedup"] = out["float32"]["step_p50_ms"] / \
        out["bfloat16"]["step_p50_ms"]
    return dict(windows=DTYPE_WINDOWS, steps_per_window=TIMED_STEPS,
                batch=TRAIN_BATCH, ids="int32", **out)


# ---------------------------------------------------------------------------
# NeuralCF
# ---------------------------------------------------------------------------

def ncf_data(seed):
    """bench.py's make_data: float32 (user, item) ids from 1 and int32
    rating classes 0-4."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, NCF_USERS + 1, NCF_SAMPLES),
                  rng.integers(1, NCF_ITEMS + 1, NCF_SAMPLES)],
                 axis=1).astype(np.float32)
    y = rng.integers(0, NCF_CLASSES, NCF_SAMPLES).astype(np.int32)
    return x, y


def windows_stats(fn, n):
    """bench.py's ``_windows_stats``: ``fn`` (one timed window -> value)
    run n times; (median, {min, median, max, n})."""
    vals = sorted(fn() for _ in range(n))
    med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
    return med, {"min": vals[0], "median": med, "max": vals[-1], "n": n}


def check_ncf_inference(ncf, seed, device):
    """``predict`` of NCF_PREDICT_ROWS rows on the card against the port's
    CPU run from the same weights, ``predict_classes`` against the CPU's
    classes, ``predict`` on an ArrayFeatureSet against the array, and
    ``recommend_for_user`` on NCF_RECOMMEND_FEATURES pairs."""
    rs = np.random.default_rng(seed + 13)
    x = np.stack([rs.integers(1, NCF_USERS + 1, NCF_PREDICT_ROWS),
                  rs.integers(1, NCF_ITEMS + 1, NCF_PREDICT_ROWS)],
                 axis=1).astype(np.float32)
    probs = ncf.predict(x, batch_size=NCF_BATCH)
    classes = ncf.predict_classes(x, batch_size=NCF_BATCH)
    on_set = ncf.predict(ArrayFeatureSet(x), batch_size=NCF_BATCH)
    cpu_model = copy.deepcopy(ncf.model)
    cpu_model.trainer = None
    cpu = SPMDTrainer(cpu_model, get_loss("sparse_categorical_crossentropy"),
                      get_optimizer("sgd"), device="cpu")
    want = cpu.predict(x, batch_size=NCF_BATCH)
    err = float(np.abs(probs - want).max())
    same_classes = bool(np.array_equal(classes, want.argmax(-1)))
    same_set = bool(np.array_equal(on_set, probs))
    # recommendations: a few hundred users, several items each
    users = rs.integers(1, 201, NCF_RECOMMEND_FEATURES)
    items = rs.integers(1, NCF_ITEMS + 1, NCF_RECOMMEND_FEATURES)
    feats = [UserItemFeature(u, i, Sample(np.array([u, i], np.float32)))
             for u, i in zip(users, items)]
    recs = ncf.recommend_for_user(feats, NCF_MAX_ITEMS)
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append(r.probability)
    ranked = all(len(p) <= NCF_MAX_ITEMS and p == sorted(p, reverse=True)
                 for p in by_user.values())
    res = dict(rows=NCF_PREDICT_ROWS, cpu_max_abs_err=err,
               cpu_tol=NCF_CPU_TOL, classes_equal_cpu=same_classes,
               feature_set_equal_array=same_set,
               recommend_features=NCF_RECOMMEND_FEATURES,
               recommend_users=len(by_user), recommendations=len(recs),
               max_items=NCF_MAX_ITEMS, recommendations_ranked=ranked)
    if probs.shape != (NCF_PREDICT_ROWS, NCF_CLASSES) or \
            not np.isfinite(probs).all() or err > NCF_CPU_TOL or \
            not same_classes or not same_set or not ranked or \
            len(by_user) != len(set(users.tolist())):
        emit("ncf", ok=False, **res)
        raise AssertionError(f"NCF inference on the card: {res}")
    return res


def ncf(seed, device):
    """bench_ncf's configuration through ``fit``, ``evaluate``,
    ``predict`` and ``recommend_for_user``, timed as bench_ncf reckons
    it: one warm-up epoch, then windows of ``fit(nb_epoch=2)`` ending in a
    host sync, each as steps over the window's wall."""
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed + 11
    model = NeuralCF(NCF_USERS, NCF_ITEMS, NCF_CLASSES, **NCF_KW)
    config.seed = seed0     # the model drew its weights from seed + 11
    model.compile(optimizer=Adam(lr=1e-3),
                  loss="sparse_categorical_crossentropy")
    x, y = ncf_data(seed + 12)
    steps_per_epoch = NCF_SAMPLES // NCF_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=1)
    warmup_s = time.perf_counter() - t0
    losses = [list(model.model.trainer.step_losses)]

    def window():
        t1 = time.perf_counter()
        model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=NCF_TIMED_EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        losses.append(list(model.model.trainer.step_losses))
        return steps_per_epoch * NCF_TIMED_EPOCHS / wall

    med, stats = windows_stats(window, NCF_WINDOWS)
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    if launches:
        raise AssertionError(f"NCF launched hand-written kernels {launches}")
    flat = [v for run in losses for v in run]
    first, last = np.mean(flat[:steps_per_epoch]), \
        np.mean(flat[-steps_per_epoch:])
    if len(flat) != steps_per_epoch * (1 + NCF_TIMED_EPOCHS * NCF_WINDOWS) \
            or not np.isfinite(flat).all() or not last < first:
        raise AssertionError(f"NCF losses: first epoch {first}, last "
                             f"{last}, {len(flat)} steps")
    results = model.evaluate(x[:NCF_PREDICT_ROWS], y[:NCF_PREDICT_ROWS],
                             batch_size=NCF_BATCH)
    if not np.isfinite(results["loss"]):
        raise AssertionError(f"NCF evaluate gave {results}")
    trainer = model.model.trainer
    batch = trainer.put_batch(next(ArrayFeatureSet(x, y).batches(
        NCF_BATCH)))
    step = lambda: trainer.train_step(batch)
    profile = profile_device(step)
    # the step alone on a batch already on the card, no sync between
    # steps as in fit: what the fit window adds is the host's batching
    # and copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_per_epoch):
        step()
    torch.cuda.synchronize()
    step_only_ms = 1e3 * (time.perf_counter() - t0) / steps_per_epoch
    step_launches = sum(g["launches"] for g in
                        (profile["groups"] or {}).values())
    inference = check_ncf_inference(model, seed, device)
    return dict(
        model="NeuralCF (bench.py bench_ncf, MovieLens-1M shape)",
        users=NCF_USERS, items=NCF_ITEMS, classes=NCF_CLASSES, **NCF_KW,
        optimizer="adam lr 0.001", loss="sparse_categorical_crossentropy",
        compute_dtype="float32", batch=NCF_BATCH, samples=NCF_SAMPLES,
        steps_per_epoch=steps_per_epoch, seed=seed,
        params=sum(p.numel() for p in model.model.parameters()),
        warmup_epoch_s=warmup_s, steps_per_s=med, steps_per_s_windows=stats,
        first_epoch_mean_loss=first, last_epoch_mean_loss=last,
        evaluate=results, hand_written_kernel_launches=launches,
        launches_per_step=step_launches, step_profile=profile,
        step_on_device_batch_ms=step_only_ms, fit_step_ms=1e3 / med,
        peak_memory_bytes=peak, inference=inference)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

# TransformerLayer's own defaults at the depth and context of GPT-1
# ("openai-gpt"): 12 blocks, 768 wide, 12 heads of 64, 512 positions;
# about 117 M parameters (469 MB in float32)
GPT_CONFIG = dict(n_block=12, hidden_size=768, n_head=12, vocab=40990,
                  seq_len=512, intermediate_size=3072)
GEN_REQUESTS, GEN_SLOTS, GEN_NEW_TOKENS = 16, 8, 48
GEN_MIN_PROMPT, GEN_MAX_PROMPT = 32, 384
FAST_REQUESTS, FAST_NEW_TOKENS, FAST_CHUNK, SPEC_K = 8, 24, 64, 3
DRAFT_BLOCKS = 2
CPU_TOKENS = 16
GEN_TIMEOUT_S = 300.0
# the card's prefill logits against the port's CPU run: 12 blocks of f32
# matmuls summed in another order (logits of scale ~1)
GEN_CPU_TOL = 1e-3
# decode_chunk against repeated decode_step on the card: the same f32
# products at other row counts
CHUNK_STEP_TOL = 1e-4
TIMED_DECODE_STEPS = 20
# (B, Lp) of the timed prefills: one long prompt alone, a batched join
PREFILL_SHAPES = ((1, 512), (4, 384))


class TimedSteps:
    """An engine whose ``step`` calls are timed on the host clock (each
    ends in the host transfer of its picks) with their gang width; every
    other attribute is the engine's."""

    def __init__(self, engine):
        self.engine = engine
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, state, feeds, temps):
        t0 = time.perf_counter()
        out = self.engine.step(state, feeds, temps)
        self.steps.append((len(feeds), time.perf_counter() - t0))
        return out


def gen_prompts(seed, n):
    rs = np.random.default_rng(seed)
    return [rs.integers(1, GPT_CONFIG["vocab"], size=int(m))
            for m in rs.integers(GEN_MIN_PROMPT, GEN_MAX_PROMPT + 1, size=n)]


def run_scheduler(engine, prompts, max_new_tokens, **kw):
    """Start a ContinuousBatchScheduler over ``engine``, submit one greedy
    request per prompt (made as it is submitted, so its TTFT starts
    there), wait for every commit and stop. Checks that each request was
    committed exactly once with ``max_new_tokens`` tokens. Returns
    (payloads by uri, the scheduler, wall seconds)."""
    out, commits, lock = {}, {}, threading.Lock()
    done = threading.Event()

    def commit(uri, payload):
        with lock:
            commits[uri] = commits.get(uri, 0) + 1
            out[uri] = payload
            if len(out) == len(prompts):
                done.set()

    sched = ContinuousBatchScheduler(engine, commit, **kw).start()
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        sched.submit(GenRequest(uri=f"g{i}", prompt=prompt,
                                max_new_tokens=max_new_tokens))
    # wait without polling: a waking thread would take the interpreter
    # lock from the scheduler thread's eager enqueue
    while not done.wait(1.0):
        if not sched._thread.is_alive():
            raise AssertionError("the scheduler thread stopped early")
        if time.perf_counter() - t0 > GEN_TIMEOUT_S:
            raise AssertionError(f"{len(out)} of {len(prompts)} requests "
                                 f"committed in {GEN_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    sched.stop(drain=True, timeout=60)
    bad = {u: (p.get("finish"), len(p.get("tokens", ())))
           for u, p in out.items()
           if p.get("finish") != "max_new_tokens" or
           len(p["tokens"]) != max_new_tokens}
    if bad or any(n != 1 for n in commits.values()) or \
            sched.counts["duplicate_commits"] or \
            sched.counts["committed"] != len(prompts):
        raise AssertionError(f"commits {commits}, bad payloads {bad}, "
                             f"counts {sched.counts}")
    return out, sched, wall


def greedy_reference(layer, prompt, n_tokens):
    """The greedy stream of one prompt through batch-1 prefill and
    decode_step, with each step's logits: (tokens, [logits rows])."""
    dev = layer.tok_emb.device
    state = layer.init_decode_state(1, GPT_CONFIG["seq_len"])
    logits, state = layer.prefill(torch.as_tensor(prompt[None], device=dev),
                                  torch.tensor([prompt.size], device=dev),
                                  state)
    tokens, rows = [], []
    for _ in range(n_tokens):
        rows.append(logits[0].float().cpu())
        tokens.append(int(torch.argmax(logits[0])))
        logits, state = layer.decode_step(
            state, torch.tensor([tokens[-1]], device=dev))
    return tokens, rows


def check_streams(name, layer, prompts, got, want):
    """Greedy streams ``got`` equal ``want`` (dicts by uri). At the first
    difference it emits the position and the plain step's top-2 logit gap
    there (from ``layer`` on the card), then fails."""
    for i, prompt in enumerate(prompts):
        uri = f"g{i}"
        a, b = got[uri], want[uri]
        if a == b:
            continue
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        _, rows = greedy_reference(layer, prompt, pos + 1)
        top2 = torch.topk(rows[pos], 2).values
        emit("generate", check=name, request=uri, ok=False,
             first_difference=pos, got=a[pos:pos + 1], want=b[pos:pos + 1],
             plain_top2_logit_gap=(top2[0] - top2[1]).item())
        raise AssertionError(f"{name}: {uri} differs at token {pos}")


def build_decoder(seed, config=None):
    config = config or GPT_CONFIG
    layer = L.TransformerLayer(**config)
    layer.build_params(torch.Generator().manual_seed(seed),
                       (None, config["seq_len"]))
    return layer.eval()


def draft_of(target):
    """A DRAFT_BLOCKS-block TransformerLayer of the target's width that
    carries its embeddings and first blocks."""
    draft = build_decoder(0, dict(GPT_CONFIG, n_block=DRAFT_BLOCKS))
    weights = target.state_dict()
    draft.load_state_dict({k: weights[k] for k in draft.state_dict()})
    return draft


def flash_causal_bound_ms(b, l, h, d, dtype):
    """The least time for one causal flash forward at Lq = Lk = l: the
    operands read and o and lse written once over the memory rate; the
    two products over the l(l+1)/2 visible (query, key) pairs over the
    dtype's peak."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * l * h * d * esize + 4 * b * l + 4 * b * h * l
    return bound_ms(nbytes, 4 * b * h * d * l * (l + 1) // 2,
                    PEAK_FLOPS[dtype])


def time_prefill_kernel(device, seed, b, l):
    """K1 at a prefill shape, causal with the -1e9 padding bias, float32:
    its device time per launch, the plain version's and SDPA's (the bias
    and the causal mask folded into one float mask) device time per call,
    and its bound."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = GPT_CONFIG["n_head"]
    d = GPT_CONFIG["hidden_size"] // h
    q, k, v = qkv_views(b, l, l, h, d, torch.float32, device, gen)
    kb = key_bias(b, l, PREFILL_BIAS, device, gen)
    scale = 1.0 / math.sqrt(d)
    causal = torch.ones(l, l, dtype=torch.bool, device=device).tril()
    mask = torch.where(causal, kb[:, None, None, :],
                       torch.full((), -math.inf, device=device))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb, True)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=scale)
    bound, bound_by = flash_causal_bound_ms(b, l, h, d, torch.float32)
    return dict(shape=dict(B=b, L=l, H=h, d=d), causal=True,
                key_bias=PREFILL_BIAS,
                ms=kernel_ms(fwd, ["flash_fwd_kernel"])["flash_fwd_kernel"],
                plain_ms=device_ms(lambda: attn.flash_forward_reference(
                    q, k, v, kb, True, scale)),
                library_ms=device_ms(sdpa), library="SDPA, float mask",
                bound_ms=bound, bound_by=bound_by)


def generate_main_run(layer, seed, device, smi):
    """The main run: GEN_REQUESTS greedy requests through the scheduler
    on GEN_SLOTS slots, with the launches read around it; then the first
    request against the port's CPU run. Returns K1's launches."""
    t0 = time.perf_counter()
    cpu_layer = copy.deepcopy(layer)
    engine = TimedSteps(TransformerDecodeEngine(layer))
    if engine.device != device:
        raise AssertionError(f"the engine chose {engine.device}")
    setup_s = time.perf_counter() - t0
    # warm-up: one short request, so the main run's first join does not
    # pay for first-call set-up
    run_scheduler(engine, gen_prompts(seed + 6, 1), 4, max_slots=GEN_SLOTS)
    engine.steps.clear()

    prompts = gen_prompts(seed + 7, GEN_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0 = engine.prefill_calls
    _kernels.LAUNCHES.reset()
    out, sched, wall = run_scheduler(engine, prompts, GEN_NEW_TOKENS,
                                     max_slots=GEN_SLOTS, prefill_chunk=0)
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    prefill_calls = engine.prefill_calls - calls0
    expected = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * prefill_calls}
    if launches != expected:
        raise AssertionError(f"generate launches {launches}, expected "
                             f"{expected} ({prefill_calls} prefills)")
    ttft = [p["timing"]["ttft_ms"] for p in out.values()]
    full_gang = [dt for n, dt in engine.steps if n == GEN_SLOTS]
    first = out["g0"]["tokens"][:CPU_TOKENS]

    # the first request against the port's CPU run: prefill logits and
    # the first CPU_TOKENS greedy tokens
    _, card_rows = greedy_reference(layer, prompts[0], 1)
    launches_cpu = _kernels.LAUNCHES.snapshot()
    cpu_tokens, cpu_rows = greedy_reference(cpu_layer, prompts[0],
                                            CPU_TOKENS)
    if _kernels.LAUNCHES.snapshot() != launches_cpu:
        raise AssertionError("the CPU run launched a kernel")
    cpu_err = (card_rows[0] - cpu_rows[0]).abs().max().item()
    emit("generate", check="main run",
         model="TransformerLayer, GPT-1 (openai-gpt) depth and context",
         config=GPT_CONFIG, seed=seed + 5, setup_s=setup_s,
         requests=GEN_REQUESTS, max_slots=GEN_SLOTS,
         max_new_tokens=GEN_NEW_TOKENS,
         prompt_lengths=[int(p.size) for p in prompts],
         prefill_calls=prefill_calls, launches=launches,
         launches_expected=expected, joins=sched.counts["joins"],
         capacity=sched.stats()["capacity"], wall_s=wall,
         tokens_per_s=GEN_REQUESTS * GEN_NEW_TOKENS / wall,
         ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
         decode_steps=len(engine.steps), full_gang_steps=len(full_gang),
         decode_step_full_gang_p50_ms=1e3 * percentile(full_gang, 50),
         peak_memory_bytes=peak, cpu_prefill_logits_max_abs_err=cpu_err,
         cpu_tol=GEN_CPU_TOL, cpu_tokens=cpu_tokens, card_tokens=first,
         card=smi)
    if cpu_err > GEN_CPU_TOL:
        raise AssertionError(f"prefill logits differ from the CPU run by "
                             f"{cpu_err} (tol {GEN_CPU_TOL})")
    check_streams("card against CPU", layer, prompts[:1], {"g0": first},
                  {"g0": cpu_tokens})
    return launches[attn.KERNEL_NAME]


def generate_fast_path(layer, seed):
    """FAST_REQUESTS requests on the same weights through the plain
    engine, then chunked joins with a prefix cache (and two repeated
    prompts that must hit), int8 slabs and speculative decoding."""
    prompts = gen_prompts(seed + 8, FAST_REQUESTS)
    kw = dict(max_slots=GEN_SLOTS)
    ref, _, _ = run_scheduler(TransformerDecodeEngine(layer), prompts,
                              FAST_NEW_TOKENS, prefill_chunk=0, **kw)
    ref = {u: p["tokens"] for u, p in ref.items()}
    # chunked joins and the prefix cache
    cache = PrefixCache(max_bytes=1 << 31)
    eng = TransformerDecodeEngine(layer, prefix_cache=cache)
    chunked, _, _ = run_scheduler(eng, prompts, FAST_NEW_TOKENS,
                                  prefill_chunk=FAST_CHUNK, **kw)
    chunked = {u: p["tokens"] for u, p in chunked.items()}
    check_streams("chunked joins", layer, prompts, chunked, ref)
    chunk_calls = eng.prefill_calls
    repeat = [prompts[0], prompts[-1]]
    hits, _, _ = run_scheduler(eng, repeat, FAST_NEW_TOKENS,
                               prefill_chunk=FAST_CHUNK, **kw)
    if eng.prefill_calls != chunk_calls or cache.hits != 2:
        raise AssertionError(f"prefix-cache hits ran prefills: "
                             f"{eng.prefill_calls} != {chunk_calls}, "
                             f"{cache.stats()}")
    check_streams("prefix-cache hits", layer, repeat,
                  {u: p["tokens"] for u, p in hits.items()},
                  {"g0": chunked["g0"], "g1": chunked[f"g{len(prompts)-1}"]})
    # int8 slabs: (1 + 4/d)/4 of the f32 bytes
    eng8 = TransformerDecodeEngine(layer, kv_dtype="int8")
    int8, _, _ = run_scheduler(eng8, prompts, FAST_NEW_TOKENS, **kw)
    cap = GPT_CONFIG["seq_len"]
    bytes8 = kv_cache.kv_slab_bytes(eng8.alloc(GEN_SLOTS, cap))
    bytes32 = kv_cache.kv_slab_bytes(eng.alloc(GEN_SLOTS, cap))
    d = GPT_CONFIG["hidden_size"] // GPT_CONFIG["n_head"]
    if bytes8 * 4 * d != bytes32 * (d + 4):
        raise AssertionError(f"int8 slabs {bytes8} B vs f32 {bytes32} B")
    agree = np.mean([a == b for u in ref
                     for a, b in zip(int8[u]["tokens"], ref[u])])
    # speculative decoding with a draft of the target's first blocks
    spec = SpeculativeDecodeEngine(TransformerDecodeEngine(layer),
                                   TransformerDecodeEngine(draft_of(layer)),
                                   k=SPEC_K)
    spec_out, _, spec_wall = run_scheduler(spec, prompts, FAST_NEW_TOKENS,
                                           prefill_chunk=FAST_CHUNK, **kw)
    check_streams("speculative", layer, prompts,
                  {u: p["tokens"] for u, p in spec_out.items()}, ref)
    emit("generate", check="fast path", requests=FAST_REQUESTS,
         max_new_tokens=FAST_NEW_TOKENS, prefill_chunk=FAST_CHUNK,
         prompt_lengths=[int(p.size) for p in prompts],
         chunked_equal_plain=True, chunked_prefill_calls=chunk_calls,
         prefix_cache=cache.stats(), prefix_hits_equal_misses=True,
         int8_slab_bytes=bytes8, f32_slab_bytes=bytes32,
         int8_bytes_ratio=bytes8 / bytes32, int8_token_agreement=agree,
         speculative_equal_plain=True, speculative=spec.stats(),
         speculative_wall_s=spec_wall)


def check_chunk_on_card(layer, seed, device):
    """On a gang of GEN_SLOTS prompts prefilled at capacity 512:
    ``decode_chunk`` over 4 tokens against 4 ``decode_step`` calls, and
    the cached-decode probe of both. Returns the state and the fed
    tokens."""
    prompts = gen_prompts(seed + 9, GEN_SLOTS)
    cap = GPT_CONFIG["seq_len"]
    toks = np.zeros((GEN_SLOTS, max(p.size for p in prompts)), np.int64)
    for j, p in enumerate(prompts):
        toks[j, :p.size] = p
    lens = torch.tensor([p.size for p in prompts], dtype=torch.int32,
                        device=device)
    _, state = layer.prefill(torch.from_numpy(toks).to(device), lens,
                             layer.init_decode_state(GEN_SLOTS, cap))
    feed = torch.randint(1, GPT_CONFIG["vocab"], (GEN_SLOTS, 4),
                         generator=torch.Generator().manual_seed(seed))
    feed = feed.to(device)
    cached = {
        "decode_step": kv_cache.decode_step_is_cached(
            layer.decode_step, state.clone(), feed[:, 0], capacity=cap),
        "decode_chunk": kv_cache.decode_step_is_cached(
            layer.decode_chunk, state.clone(), feed, capacity=cap)}
    chunk_logits, _ = layer.decode_chunk(state.clone(), feed)
    st = state.clone()
    errs, same = [], True
    for c in range(feed.shape[1]):
        step_logits, st = layer.decode_step(st, feed[:, c])
        errs.append((step_logits - chunk_logits[:, c]).abs().max().item())
        same &= torch.equal(step_logits.argmax(-1),
                            chunk_logits[:, c].argmax(-1))
    emit("generate", check="on the card", gang=GEN_SLOTS, capacity=cap,
         chunk=feed.shape[1], chunk_vs_step_max_abs_err=max(errs),
         tol=CHUNK_STEP_TOL, greedy_equal=same, decode_step_is_cached=cached)
    if max(errs) > CHUNK_STEP_TOL or not same or not all(cached.values()):
        raise AssertionError(f"chunk vs step {errs}, greedy {same}, "
                             f"cached {cached}")
    return state, feed


def time_generation(layer, state, tok, seed, device, smi):
    """Prefill at PREFILL_SHAPES (host wall, device time by kernel group,
    K1 there) and one decode step on ``state`` (wall, host enqueue,
    device busy and idle share, its byte bound). Returns K1's timing at
    the last prefill shape."""
    cap = GPT_CONFIG["seq_len"]
    prefill = {}
    for b, l in PREFILL_SHAPES:
        ptoks = torch.randint(1, GPT_CONFIG["vocab"], (b, l),
                              generator=torch.Generator().manual_seed(l))
        ptoks = ptoks.to(device)
        plens = torch.full((b,), l, dtype=torch.int32, device=device)
        pstate = layer.init_decode_state(b, cap)
        fn = lambda: layer.prefill(ptoks, plens, pstate)
        walls = []
        for _ in range(6):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        prefill[f"B={b},L={l}"] = dict(
            wall_p50_ms=1e3 * percentile(walls[1:], 50),
            profile=profile_device(fn),
            k1=time_prefill_kernel(device, seed + l, b, l))
    enqueue, walls = [], []
    for _ in range(TIMED_DECODE_STEPS):
        t1 = time.perf_counter()
        _, state = layer.decode_step(state, tok)
        enqueue.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    weight_bytes = sum(int(p.nbytes) for p in layer.parameters())
    slab_bytes = kv_cache.kv_slab_bytes(state)
    step_bound, step_bound_by = bound_ms(
        weight_bytes + slab_bytes,
        2 * GEN_SLOTS * sum(p.numel() for p in layer.parameters()),
        CUDA_CORE_F32_FLOPS)
    emit("timing", path="generate", card=smi, prefill=prefill,
         decode_step=dict(
             gang=GEN_SLOTS, capacity=cap,
             lengths=state.lengths.tolist(),
             wall_p50_ms=1e3 * percentile(walls, 50),
             enqueue_p50_ms=1e3 * percentile(enqueue, 50),
             weight_bytes=weight_bytes, slab_bytes=slab_bytes,
             bound_ms=step_bound, bound_by=step_bound_by,
             profile=profile_device(lambda: layer.decode_step(state, tok))),
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"))
    b, l = PREFILL_SHAPES[-1]
    return prefill[f"B={b},L={l}"]["k1"]


def generate(seed, device, smi):
    """The generate phase on a GPT-width decoder from ``seed``: the main
    run, the fast path, the on-card checks and the timing. Returns K1's
    launches in the main run and its timing at the join prefill shape."""
    layer = build_decoder(seed + 5)
    launches = generate_main_run(layer, seed, device, smi)
    generate_fast_path(layer, seed)
    state, feed = check_chunk_on_card(layer, seed, device)
    return launches, time_generation(layer, state, feed[:, 0], seed,
                                     device, smi)


# ---------------------------------------------------------------------------
# checkpoint: the engine's store, failure policy, accumulation, save/load
# ---------------------------------------------------------------------------

# bench.py's classifier in bf16 on int32 ids (the train_bf16 setup) over 8
# distinct batches of TRAIN_BATCH rows, shuffled per epoch, 2 epochs; a
# checkpoint every CKPT_EVERY steps into a store keeping CKPT_KEEP.
CKPT_BATCHES, CKPT_EPOCHS, CKPT_EVERY, CKPT_KEEP = 8, 2, 4, 2
CKPT_STEPS = CKPT_BATCHES * CKPT_EPOCHS
CKPT_FAIL_AT, CKPT_PREEMPT_AT, CKPT_LOG_EVERY = 10, 6, 2
CKPT_ACCUM = 4
# the phase's directories, under the checkout (build/ is ignored by git),
# deleted when the phase ends
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_checkpoint")
# alternating windows of one epoch each: an async checkpoint every
# CKPT_EVERY steps against none
CKPT_TIMED_WINDOWS = 4
CKPT_SERVE_ROWS, CKPT_RESNET_ROWS = 8, 8
# one step, dropout off, accumulation CKPT_ACCUM against 1 on the same
# weights and batch: the loss, and each parameter's gradient relative to
# its norm, at the train parity gate's tolerances (PERF.md §2). Float32:
# products summed over 8-row microbatches and then added, against one sum
# over 32 rows; the head's 2-element bias gradient, a sum of 32 terms that
# mostly cancel, moves 8e-5 of its norm under that alone. bf16: the
# products' bf16 roundings fall at other places.
ACCUM_LOSS_TOL = {"float32": TRAIN_LOSS_TOL, "bfloat16": BF16_LOSS_TOL}
ACCUM_GRAD_TOL = {"float32": TRAIN_GRAD_TOL, "bfloat16": BF16_GRAD_TOL}
# bf16: a gradient past ACCUM_GRAD_TOL of its norm passes when accumulation
# lands no further than this many times the full batch's distance from
# the float32 step's gradient (see check_accumulation): accumulation
# rounds CKPT_ACCUM partial sums to bf16 where the full batch rounds one,
# so its rounding error is up to CKPT_ACCUM times the full batch's
# (about sqrt(CKPT_ACCUM) times when the roundings are independent)
ACCUM_BF16_FACTOR = float(CKPT_ACCUM)


class _Config:
    """Set fields of the context's config for a ``with`` block."""

    def __init__(self, **fields):
        self.fields = fields

    def __enter__(self):
        cfg = init_nncontext().config
        self.saved = {k: getattr(cfg, k) for k in self.fields}
        for k, v in self.fields.items():
            setattr(cfg, k, v)

    def __exit__(self, *exc):
        cfg = init_nncontext().config
        for k, v in self.saved.items():
            setattr(cfg, k, v)
        return False


class _Tap(ZooTrigger):
    """A checkpoint trigger wrapping ``inner`` that also calls ``fn`` the
    first time iteration ``at`` is reached, mid-epoch (``fn`` may record
    the state, or request a preemption)."""

    def __init__(self, inner, at=None, fn=None):
        self.inner, self.at, self.fn = inner, at, fn

    def __call__(self, record):
        if self.fn is not None and record.iteration == self.at and \
                not record.epoch_finished:
            self.fn()
            self.fn = None
        return self.inner(record)


class _StepClock(ZooTrigger):
    """A checkpoint trigger wrapping ``inner`` (or none) that synchronises
    the card and reads the host clock after every step."""

    def __init__(self, inner=None):
        self.inner, self.ticks = inner, []

    def __call__(self, record):
        if not record.epoch_finished:
            torch.cuda.synchronize()
            self.ticks.append(time.perf_counter())
        return self.inner(record) if self.inner is not None else False


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def ckpt_model(seed, dropout=TRAIN_P_DROP, dtype="bfloat16"):
    """The classifier of ``build_classifier`` with named layers: every run
    of the phase writes the same layer names into its checkpoints, so two
    runs' files can be compared byte for byte."""
    config = dict(BERT_CONFIG, hidden_p_drop=dropout, attn_p_drop=dropout)
    l = config["seq_len"]
    ins = [L.Input(shape=(l,), name=n) for n in
           ("tokens", "positions", "segments")] + \
        [L.Input(shape=(1, 1, l), name="mask")]
    _, pooled = L.BERT(name="ckpt_bert", **config)(ins)
    model = Model(ins, L.Dense(N_CLASSES, activation="softmax",
                               name="ckpt_head")(pooled), seed=seed)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.set_compute_dtype(dtype)
    return model


def trainer_state(trainer):
    """(name, device clone) of every parameter and Adam moment."""
    moments = trainer.opt_state[0]
    out = [(k, p.detach().clone()) for k, p in trainer.params().items()]
    out += [(f"{part}:{k}", t.detach().clone())
            for part in ("mu", "nu") for k, t in moments[part].items()]
    return out


def check_state_equal(trainer, want, what):
    """Every tensor of ``trainer_state`` equal to ``want``'s, in order (a
    model built anew has other auto-generated layer names)."""
    got = trainer_state(trainer)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tensors, expected "
                             f"{len(want)}")
    bad = [k for (k, g), (_, t) in zip(got, want) if not torch.equal(g, t)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ from the "
                             f"reference run, first {bad[0]}")


def manifest_crcs(directory):
    out = {}
    for sub in sorted(os.listdir(directory)):
        if sub.startswith(SPMDTrainer.CKPT_PREFIX):
            with open(os.path.join(directory, sub, "manifest.json")) as f:
                out[sub] = {k: v["crc32c"] for k, v in
                            json.load(f)["files"].items()}
    return out


def ckpt_fit(model, x, y, directory, trigger, epochs=CKPT_EPOCHS, **kw):
    model.set_checkpoint(directory, trigger=trigger)
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=epochs, **kw)
    return model.trainer


def collect():
    """Free the card's memory of the models dropped so far (their graphs
    hold reference cycles)."""
    gc.collect()
    torch.cuda.empty_cache()


def _rel(a, b):
    return ((a - b).norm() / max(b.norm().item(), 1e-12)).item()


def check_accumulation(seed, device):
    """One dropout-off step with accumulation CKPT_ACCUM against the same
    step without, on one batch and the same weights: float32, then bf16.
    The loss within ACCUM_LOSS_TOL; each gradient within ACCUM_GRAD_TOL of
    its norm, or in bf16, where a small gradient summed from terms that
    cancel (the head's 2-element bias) carries bf16's rounding of each
    microbatch's partial sum, no further from the float32 step's gradient
    than ACCUM_BF16_FACTOR times the bf16 full batch's own distance."""
    out = {}
    loss_fn = get_loss("sparse_categorical_crossentropy")
    ref = None
    for dtype in ("float32", "bfloat16"):
        model = build_classifier(seed + 7, dict(
            BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0))
        trainer = SPMDTrainer(model, loss_fn, Adam(lr=TRAIN_LR),
                              device=device, compute_dtype=dtype)
        trainer.ensure_initialized()
        x, y, _ = train_data(seed + 7, TRAIN_BATCH, ids=np.int32
                             if dtype == "bfloat16" else np.float32)
        batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
        runs = {}
        for accum in (1, CKPT_ACCUM):
            with _Config(grad_accum_steps=accum):
                loss = trainer.loss_and_grads(batch).item()
            runs[accum] = (loss, [p.grad.detach().clone() for p in
                                  model.parameters()])
        names = [k for k, _ in model.named_parameters()]
        (l1, g1), (l4, g4) = runs[1], runs[CKPT_ACCUM]
        tol = ACCUM_GRAD_TOL[dtype]
        worst, worst_name, bad = 0.0, None, []
        for k, a, b, r in zip(names, g4, g1, ref or [None] * len(names)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{k}: non-finite accumulated gradient")
            rel = _rel(a, b)
            if rel > worst:
                worst, worst_name = rel, k
            if rel > tol and (r is None or _rel(a, r) >
                              ACCUM_BF16_FACTOR * _rel(b, r)):
                bad.append(k)
        res = dict(loss_accum1=l1, loss_accum4=l4, loss_err=abs(l4 - l1),
                   loss_tol=ACCUM_LOSS_TOL[dtype], max_grad_rel_err=worst,
                   max_grad_rel_err_param=worst_name, grad_tol=tol)
        if ref is not None:
            k = names.index(worst_name)
            res.update(worst_accum4_vs_float32=_rel(g4[k], ref[k]),
                       worst_accum1_vs_float32=_rel(g1[k], ref[k]),
                       float32_factor=ACCUM_BF16_FACTOR)
        out[dtype] = res
        if res["loss_err"] > res["loss_tol"] or bad:
            emit("checkpoint", ok=False, accumulation=out)
            raise AssertionError(f"accumulation {CKPT_ACCUM} differs from "
                                 f"the full batch in {dtype} ({bad}): {res}")
        if ref is None:
            ref = g1
        del model, trainer, runs, g4
        collect()
    return out


def time_accumulation(model, x, y):
    """Launches of one training step under accumulation CKPT_ACCUM, then
    the step at accumulation 1 and CKPT_ACCUM in alternating windows of
    TIMED_STEPS steps (1, 4, 4, 1): wall per step and peak memory."""
    trainer = model.trainer
    batch = trainer.put_batch(([a[:TRAIN_BATCH] for a in x], y[:TRAIN_BATCH],
                               np.ones(TRAIN_BATCH, np.float32)))
    n_block = BERT_CONFIG["n_block"]
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    want = {k: CKPT_ACCUM * v for k, v in per_step.items()}
    with _Config(grad_accum_steps=CKPT_ACCUM):
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES.snapshot()
        dtypes = _kernels.LAUNCHES.by_dtype()
    if launches != want or any(set(v) != {"bfloat16"}
                               for v in dtypes.values()):
        raise AssertionError(f"accumulation {CKPT_ACCUM}: launches "
                             f"{dtypes}, expected {want} in bfloat16")
    step_s = {1: [], CKPT_ACCUM: []}
    peaks = {1: [], CKPT_ACCUM: []}
    for accum in (1, CKPT_ACCUM, CKPT_ACCUM, 1):
        with _Config(grad_accum_steps=accum):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                step_s[accum].append(time.perf_counter() - t0)
            peaks[accum].append(torch.cuda.max_memory_allocated())
    timing = {f"accum{a}": dict(step_ms=[1e3 * t for t in ts],
                                step_p50_ms=1e3 * percentile(ts, 50),
                                peak_memory_bytes=max(peaks[a]))
              for a, ts in step_s.items()}
    return launches, per_step, timing


def save_serve(model, x, directory, device):
    """``save_model``, ``InferenceModel().load`` and 8 rows served on the
    card, bit for bit against ``predict`` in float32 on the card."""
    model.set_compute_dtype("float32")
    rows = [a[:CKPT_SERVE_ROWS] for a in x]
    want = model.predict(rows, batch_size=CKPT_SERVE_ROWS)
    t0 = time.perf_counter()
    model.save_model(directory)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    im = InferenceModel().load(directory)
    load_s = time.perf_counter() - t0
    if im.model.device != device:
        raise AssertionError(f"InferenceModel.load put it on "
                             f"{im.model.device}")
    _kernels.LAUNCHES.reset()
    got = im.predict(rows)
    served_k1 = _kernels.LAUNCHES.get(attn.KERNEL_NAME)
    if not np.array_equal(got, want):
        raise AssertionError(f"the loaded classifier serves other outputs: "
                             f"max {np.abs(got - want).max()}")
    return dict(rows=CKPT_SERVE_ROWS, save_s=save_s, load_s=load_s,
                launches_served=served_k1, equal=True)


def save_serve_resnet(seed, directory):
    """A ResNet-50 ``ImageClassifier`` with seeded moving statistics
    through ``ZooModel.save_model`` and ``InferenceModel().load`` on the
    zoo-model directory: ``predict`` at batch 8, bit for bit."""
    clf = build_resnet(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in clf.model.named_buffers():
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen)
                      if name.endswith("moving_var") else
                      0.1 * torch.randn(buf.shape, generator=gen))
    x = np.random.default_rng(seed).standard_normal(
        (CKPT_RESNET_ROWS,) + RESNET_SHAPE).astype(np.float32)
    want = clf.predict(x, batch_size=CKPT_RESNET_ROWS)
    clf.save_model(directory)
    im = InferenceModel().load(directory)
    got = im.predict(x)
    if not np.array_equal(got, want):
        raise AssertionError(f"the loaded ResNet-50 serves other outputs: "
                             f"max {np.abs(got - want).max()}")
    n_stats = sum(1 for _ in clf.model.buffers())
    return dict(rows=CKPT_RESNET_ROWS, moving_statistics=n_stats,
                equal=True)


def time_async_steps(model, x, y, directory):
    """Steps with an async checkpoint every CKPT_EVERY steps against none,
    in alternating one-epoch windows (async, none, none, async): each
    step's wall between synchronised clock reads, and the p50."""
    step_s = {"async": [], "none": []}
    with _Config(async_checkpoint=True, keep_checkpoints=CKPT_KEEP):
        for w in range(CKPT_TIMED_WINDOWS):
            kind = ("async", "none", "none", "async")[w % 4]
            clock = _StepClock(SeveralIteration(CKPT_EVERY)
                               if kind == "async" else None)
            ckpt_fit(model, x, y, directory, clock, epochs=1)
            step_s[kind] += list(np.diff(clock.ticks))
    model.trainer.wait_for_checkpoint()
    return {k: dict(step_ms=[1e3 * t for t in v],
                    step_p50_ms=1e3 * percentile(v, 50),
                    step_max_ms=1e3 * max(v))
            for k, v in step_s.items()}


def checkpoint(seed, device, smi, root):
    """The checkpoint phase (see the module docstring): returns the
    phase's report and the launches a step under accumulation."""
    os.makedirs(root, exist_ok=True)
    disk = shutil.disk_usage(root)
    dirs = {k: os.path.join(root, k) for k in
            ("reference", "retry", "preempt", "async", "timed", "tb",
             "saved_bert", "saved_resnet")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    x, y, _ = train_data(seed + 3, CKPT_BATCHES * TRAIN_BATCH, ids=np.int32)
    # labels apart from the tokens (train_data's first token carries its
    # label, which the classifier learns to a loss of 0.0 in 5 steps): the
    # losses stay informative over all 16 steps
    y = np.random.default_rng(seed + 5).integers(
        0, N_CLASSES, len(y)).astype(np.float32)
    val_x, val_y, _ = train_data(seed + 4, TRAIN_BATCH, ids=np.int32)
    messages = _Messages()
    logging.getLogger("analytics_zoo_tpu_torch.engine").addHandler(messages)
    logging.getLogger("analytics_zoo_tpu_torch.engine").setLevel(logging.INFO)
    report = dict(model="BERT-base classifier (bench.py:353-438)",
                  compute_dtype="bfloat16", ids="int32", batch=TRAIN_BATCH,
                  batches_per_epoch=CKPT_BATCHES, epochs=CKPT_EPOCHS,
                  checkpoint_every=CKPT_EVERY, keep=CKPT_KEEP,
                  free_disk_bytes_before=disk.free, card=smi)
    base = dict(keep_checkpoints=CKPT_KEEP, async_checkpoint=False,
                failure_retry_times=0, auto_resume=False,
                log_every_n_steps=CKPT_LOG_EVERY)

    # 1. the reference run R, with summaries and validation
    at12 = {}
    with _Config(**base):
        np.random.seed(seed)
        r_model = ckpt_model(seed + 11)
        r_model.set_tensorboard(dirs["tb"], "reference")
        trigger = _Tap(SeveralIteration(CKPT_EVERY), 3 * CKPT_EVERY,
                       lambda: at12.update(state=trainer_state(
                           r_model.trainer)))
        t0 = time.perf_counter()
        r = ckpt_fit(r_model, x, y, dirs["reference"], trigger,
                     validation_data=(val_x, val_y))
        r_wall = time.perf_counter() - t0
    r_losses = list(r.step_losses)
    ref = trainer_state(r)
    if r.step != CKPT_STEPS or len(r_losses) != CKPT_STEPS or \
            not np.isfinite(r_losses).all():
        raise AssertionError(f"reference run: step {r.step}, losses "
                             f"{r_losses}")
    r_crcs = manifest_crcs(dirs["reference"])
    if sorted(r_crcs) != [f"ckpt-{CKPT_STEPS - CKPT_EVERY}",
                          f"ckpt-{CKPT_STEPS}"]:
        raise AssertionError(f"retention kept {sorted(r_crcs)}")
    summary = r_model.get_train_summary("Loss")
    want_steps = list(range(CKPT_LOG_EVERY, CKPT_STEPS + 1, CKPT_LOG_EVERY))
    if [s for s, _, _, _ in summary] != want_steps or any(
            v != np.float32(r_losses[s - 1]) for s, _, _, v in summary):
        raise AssertionError(f"Loss summary {summary} against the step "
                             f"losses {r_losses}")
    val_summary = r_model.get_validation_summary()
    if not val_summary:
        raise AssertionError("no validation summary")
    saves = [s for s in r.checkpoint_stats]
    report["reference"] = dict(
        losses=r_losses, wall_s=r_wall, saves=len(saves),
        summary_loss_windows=len(summary),
        summary_tags=sorted({t for _, _, t, _ in
                             r_model.get_train_summary()}),
        validation_scalars=len(val_summary))
    report["sync_save"] = dict(
        bytes=saves[-1]["bytes"],
        per_save=[{k: v for k, v in s.items()} for s in saves])
    del r_model, r
    collect()

    # 2. a failed step at CKPT_FAIL_AT, retried in the same fit
    os.environ["ZOO_TPU_FAULT"] = f"step:raise@{CKPT_FAIL_AT}"
    faults.reset()
    try:
        with _Config(**dict(base, failure_retry_times=1)):
            np.random.seed(seed)
            f_model = ckpt_model(seed + 11)
            f = ckpt_fit(f_model, x, y, dirs["retry"],
                         SeveralIteration(CKPT_EVERY))
    finally:
        del os.environ["ZOO_TPU_FAULT"]
        faults.reset()
    check_state_equal(f, ref, "the retried run")
    retried = [m for m in messages.lines if m.startswith("step failed")]
    if (f.step, f.epoch) != (CKPT_STEPS, CKPT_EPOCHS) or not retried or \
            f.step_losses != r_losses:
        raise AssertionError(f"retried run: step {f.step} epoch {f.epoch} "
                             f"losses {f.step_losses}, log {retried}")
    restored = [m for m in messages.lines if m.startswith("restored")]
    report["retry"] = dict(fault=f"step:raise@{CKPT_FAIL_AT}",
                           log=retried + restored, equal=True)
    del f_model, f
    collect()
    shutil.rmtree(dirs["retry"])

    # 3. preemption at CKPT_PREEMPT_AT, then a fresh model resumes
    with _Config(**base):
        np.random.seed(seed)
        p_model = ckpt_model(seed + 11)
        try:
            ckpt_fit(p_model, x, y, dirs["preempt"],
                     _Tap(SeveralIteration(CKPT_EVERY), CKPT_PREEMPT_AT,
                          request_preemption))
            raise AssertionError("the preemption was not honoured")
        except TrainingPreempted:
            pass
        finally:
            clear_preemption()
        drained = p_model.trainer.step
    del p_model
    collect()
    with open(os.path.join(dirs["preempt"], "latest")) as fh:
        latest = fh.read()
    if drained != CKPT_PREEMPT_AT or latest != f"ckpt-{CKPT_PREEMPT_AT}":
        raise AssertionError(f"drained at {drained}, latest {latest}")
    messages.lines.clear()
    with _Config(**dict(base, auto_resume=True)):
        a_model = ckpt_model(seed + 23)     # other weights: the load must win
        a = ckpt_fit(a_model, x, y, dirs["preempt"],
                     SeveralIteration(CKPT_EVERY))
    resumed = [m for m in messages.lines if m.startswith("auto-resume")]
    want_log = f"auto-resume: restored step {CKPT_PREEMPT_AT} epoch 0 " \
        f"(+{CKPT_PREEMPT_AT} batches)"
    if not resumed or not resumed[0].startswith(want_log):
        raise AssertionError(f"auto-resume said {resumed}")
    check_state_equal(a, ref, "the resumed run")
    if a.step != CKPT_STEPS or a.step_losses != r_losses[CKPT_PREEMPT_AT:]:
        raise AssertionError(f"resumed run: step {a.step} losses "
                             f"{a.step_losses}")
    report["preempt"] = dict(drained_at=drained, resumed=resumed[0],
                             load_s=a.last_load_s, equal=True)
    del a_model, a
    collect()
    shutil.rmtree(dirs["preempt"])

    # 4. async writes: the same state and the same bytes as R
    with _Config(**dict(base, async_checkpoint=True)):
        np.random.seed(seed)
        s_model = ckpt_model(seed + 11)
        s = ckpt_fit(s_model, x, y, dirs["async"],
                     SeveralIteration(CKPT_EVERY))
    check_state_equal(s, ref, "the async run")
    if s.step_losses != r_losses:
        raise AssertionError(f"async run losses {s.step_losses}")
    s_crcs = manifest_crcs(dirs["async"])
    if s_crcs != r_crcs:
        raise AssertionError(f"async checkpoints {s_crcs} against the "
                             f"reference's {r_crcs}")
    report["async"] = dict(
        equal=True, same_crc32c=sorted(s_crcs),
        stall_ms=[1e3 * st["stall_s"] for st in s.checkpoint_stats],
        snapshot_ms=[1e3 * st["snapshot_s"] for st in s.checkpoint_stats],
        wait_for_previous_ms=[1e3 * st["wait_s"]
                              for st in s.checkpoint_stats])
    shutil.rmtree(dirs["async"])

    # 5. gradient accumulation: launches, time and memory on the trained
    # model, then the dropout-off step against accumulation 1
    launches, per_step, acc_timing = time_accumulation(s_model, x, y)
    report["accumulation"] = dict(
        steps=CKPT_ACCUM, launches_per_step=launches,
        launches_per_step_accum1=per_step, timing=acc_timing)
    # the step with and without an async checkpoint every CKPT_EVERY
    report["async_step_timing"] = time_async_steps(s_model, x, y,
                                                   dirs["timed"])
    shutil.rmtree(dirs["timed"], ignore_errors=True)

    # 6. a corrupt newest checkpoint falls back to the previous one
    newest = f"ckpt-{CKPT_STEPS}"
    path = os.path.join(dirs["reference"], newest, "optim.npz")
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))
    messages.lines.clear()
    s.load_checkpoint(dirs["reference"])
    skipped = [m for m in messages.lines if "unusable" in m]
    if s.step != CKPT_STEPS - CKPT_EVERY or not skipped:
        raise AssertionError(f"after the corruption: step {s.step}, "
                             f"log {messages.lines}")
    check_state_equal(s, at12["state"], "the fallback restore")
    report["corruption"] = dict(flipped=f"{newest}/optim.npz",
                                restored_step=s.step, log=skipped[0],
                                load_s=s.last_load_s, equal=True)
    with open(os.path.join(dirs["reference"], f"ckpt-{CKPT_STEPS - CKPT_EVERY}",
                           "model.npz"), "rb") as fh:
        blob = fh.read()
    t0 = time.perf_counter()
    crc32c(blob)
    crc_s = time.perf_counter() - t0
    report["crc32c"] = dict(bytes=len(blob), s=crc_s,
                            gb_per_s=len(blob) / crc_s / 1e9)
    del at12, ref, blob
    shutil.rmtree(dirs["reference"])

    # 7. save, load, serve
    report["save_serve_bert"] = save_serve(s_model, x, dirs["saved_bert"],
                                           device)
    del s_model, s
    collect()
    report["accumulation"]["parity"] = check_accumulation(seed, device)
    report["save_serve_resnet"] = save_serve_resnet(seed + 13,
                                                    dirs["saved_resnet"])
    logging.getLogger("analytics_zoo_tpu_torch.engine").removeHandler(
        messages)
    shutil.rmtree(root)
    collect()
    return report, launches


# ---------------------------------------------------------------------------
# the sequence models: recurrent layers, TextClassifier and the zoo
# ---------------------------------------------------------------------------

# the reference TextClassifier example's defaults (pyzoo/zoo/examples/
# textclassification/text_classification.py, news20): 20 classes, 500
# tokens a text, GloVe 6B 200-d vectors for the 5000 most frequent words
# (a seeded (5001, 200) table stands in: no GloVe file is in the
# repository), encoder output 256, batch 128, Adagrad at 0.01
TC_CLASSES, TC_SEQ_LEN, TC_TOKEN_LEN, TC_MAX_WORDS = 20, 500, 200, 5000
TC_ENCODER_DIM, TC_BATCH, TC_STEPS, TC_LR = 256, 128, 8, 0.01
TC_ENCODERS = ("cnn", "lstm", "gru")
TC_PREDICT_ROWS = 32
TC_TIMED_STEPS, TC_WINDOWS = 5, 2
# the card's predictions against the port's CPU run of the same weights:
# a 500-step recurrence (and the convolution) in float32, summed in
# another order by cuBLAS / cuDNN and the CPU's BLAS
SEQ_CPU_TOL = 1e-4
# the other zoo models: predict against the CPU, then SEQ_FIT_STEPS steps
# of fit on one seeded batch
SEQ_FIT_STEPS = 4
# AnomalyDetector at the repo example's unroll (24) and the model's
# default hidden widths and dropouts
AD_UNROLL, AD_HIDDEN, AD_DROPOUTS, AD_BATCH = 24, (8, 32, 15), \
    (0.2, 0.2, 0.2), 1024
# KNRM at the reference's defaults (KNRM.scala): query 10, document 40,
# 300-d embeddings, 21 kernels; a 20,000-word vocabulary
KNRM_L1, KNRM_L2, KNRM_VOCAB, KNRM_EMBED, KNRM_KERNELS = 10, 40, 20000, \
    300, 21
KNRM_PAIRS, KNRM_QUERIES, KNRM_CANDIDATES = 256, 32, 10
# the ranking leg's corpora, as TextSets: KNRM_QUERIES queries of KNRM_L1
# words, each with KNRM_RELEVANT documents of KNRM_L2 words that open
# with the query's words and KNRM_IRRELEVANT random ones, over the
# 26**3 three-letter words (a vocabulary below KNRM_VOCAB); one relation
# pair a relevant document gives 256 pairs
KNRM_WORDS, KNRM_RELEVANT, KNRM_IRRELEVANT = 26 ** 3, 8, 8
# SessionRecommender at its default rnn and mlp widths (40, 20), with the
# history: 10,000 items embedded in 100, sessions of 10 clicks and
# histories of 5 (chosen here: the reference sets no defaults)
SR_ITEMS, SR_EMBED, SR_SESSION, SR_HISTORY, SR_BATCH = 10000, 100, 10, 5, \
    1024
SR_RECOMMEND, SR_MAX_ITEMS = 16, 5
# Seq2seq: an LSTM of 2 layers and 256 wide, a dense bridge, a
# TimeDistributed(Dense(feat)) generator
S2S_LAYERS, S2S_HIDDEN, S2S_FEAT, S2S_T_IN, S2S_T_OUT, S2S_BATCH = \
    2, 256, 32, 40, 20, 64
S2S_INFER_ROWS, S2S_INFER_LEN = 8, 20
# infer_reference re-runs the decoder over the whole prefix, so its
# products differ in shape (and summation) from the cached step's
S2S_REFERENCE_TOL = 1e-4


def cpu_twin(model):
    """A copy of ``model`` (a KerasNet on the card) on the CPU, with a CPU
    trainer."""
    trainer, model.trainer = model.trainer, None
    try:
        cpu_model = copy.deepcopy(model)
    finally:
        model.trainer = trainer
    cpu_model.trainer = SPMDTrainer(cpu_model, get_loss("mse"),
                                    get_optimizer("sgd"), device="cpu")
    return cpu_model


def zoo_twin(model):
    """A zoo model over the CPU twin of ``model``'s Keras model."""
    twin = copy.copy(model)
    twin.model = cpu_twin(model.model)
    return twin


def seeded_zoo_model(make, seed):
    """A zoo model built with the context's seed set to ``seed`` (its
    weights come from the seed the graph is built under)."""
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    try:
        model = make()
        model.model.graph_function()
    finally:
        config.seed = seed0
    return model


def keras_of(model):
    """The Keras model of a zoo model, or ``model`` itself."""
    return model if hasattr(model, "graph_function") else model.model


def check_predict(name, model, x, batch):
    """``predict`` on the card against the CPU's: the largest
    difference, gated at SEQ_CPU_TOL."""
    got = model.predict(x, batch_size=batch)
    want = cpu_twin(keras_of(model)).trainer.predict(x, batch_size=batch)
    got_l = got if isinstance(got, list) else [got]
    want_l = want if isinstance(want, list) else [want]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got_l, want_l))
    if not all(np.isfinite(g).all() and g.shape == w.shape
               for g, w in zip(got_l, want_l)) or err > SEQ_CPU_TOL:
        raise AssertionError(f"{name}: predict on the card off the CPU's "
                             f"by {err} (tol {SEQ_CPU_TOL})")
    return got, err


def no_launches(name):
    """K1-K5's launches since the sequence phase set the counts to 0:
    none, or ``name`` fails."""
    launches = _kernels.LAUNCHES.snapshot()
    if launches:
        raise AssertionError(f"{name} launched hand-written kernels "
                             f"{launches}")
    return launches


def fit_one_batch(name, model, x, y, batch, steps):
    """``steps`` steps of ``fit`` on one batch (one epoch a step): the
    losses (finite and falling), K1-K5's launches since the phase began
    (none), the wall and the peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=batch, nb_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = no_launches(name)
    peak = torch.cuda.max_memory_allocated()
    losses = list(keras_of(model).trainer.step_losses)
    if len(losses) != steps or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name} losses {losses}")
    return dict(losses=losses, k1_k5_launches=launches, fit_wall_s=wall,
                peak_memory_bytes=peak)


def text_data(seed, n):
    rs = np.random.default_rng(seed)
    x = rs.integers(0, TC_MAX_WORDS + 1, (n, TC_SEQ_LEN)).astype(np.int32)
    y = rs.integers(0, TC_CLASSES, n).astype(np.int32)
    return x, y


def text_classifier_leg(encoder, seed, table, x, y):
    """The full-width TextClassifier with ``encoder``: predict against
    the CPU; TC_STEPS steps of fit (falling loss, a finite nonzero
    gradient on every trainable parameter, the frozen table unmoved,
    K1-K5 not launched); evaluate."""
    model = seeded_zoo_model(lambda: TextClassifier(
        TC_CLASSES, table, sequence_length=TC_SEQ_LEN, encoder=encoder,
        encoder_output_dim=TC_ENCODER_DIM), seed)
    probs, err = check_predict(f"TextClassifier({encoder})", model,
                               x[:TC_PREDICT_ROWS], TC_PREDICT_ROWS)
    no_launches(f"TextClassifier({encoder}) predict")
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if row_err > ROW_SUM_TOL:
        raise AssertionError(f"TextClassifier({encoder}) predict rows off "
                             f"1 by {row_err}")
    table_layer = model.model.layers[0]
    table0 = table_layer.table.detach().clone()
    model.compile(Adagrad(lr=TC_LR), "sparse_categorical_crossentropy",
                  ["accuracy"])
    fit = fit_one_batch(f"TextClassifier({encoder})", model, x, y,
                        TC_BATCH, TC_STEPS)
    grads = {}
    for n, p in model.model.named_parameters():
        if p is table_layer.table:
            continue
        g = p.grad
        grads[n] = 0.0 if g is None or not torch.isfinite(g).all() \
            else g.abs().max().item()
    if min(grads.values()) <= 0.0:
        raise AssertionError(f"TextClassifier({encoder}) parameters "
                             f"without a gradient: "
                             f"{[n for n, g in grads.items() if g <= 0]}")
    if not torch.equal(table_layer.table.detach(), table0) or (
            table_layer.table.grad is not None and
            table_layer.table.grad.any()):
        raise AssertionError(f"TextClassifier({encoder}): the frozen "
                             "table moved or took a gradient")
    results = model.evaluate(x, y, batch_size=TC_BATCH)
    if not np.isfinite(results["loss"]) or \
            not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"TextClassifier({encoder}) evaluate "
                             f"{results}")
    return model, dict(
        encoder=encoder, params=sum(p.numel() for p in
                                    model.model.parameters()),
        predict_rows=TC_PREDICT_ROWS, predict_cpu_max_abs_err=err,
        predict_row_sum_max_err=row_err, min_param_grad=min(grads.values()),
        trainable_params_with_grad=len(grads), frozen_table_unmoved=True,
        evaluate=results, **fit)


def time_text_classifiers(models, x, y):
    """Each encoder's training step in alternating windows of
    TC_TIMED_STEPS (cnn, lstm, gru, gru, lstm, cnn): host clock around a
    synchronised step, p50, each window's peak memory; then one step's
    device time, launches and idle share from the profiler."""
    host = ([x], y, np.ones(len(y), np.float32))
    trainers = {e: m.model.trainer for e, m in models.items()}
    batches = {e: t.put_batch(host) for e, t in trainers.items()}
    step_s = {e: [] for e in models}
    peaks = {e: [] for e in models}
    order = list(models)
    for w in range(TC_WINDOWS):
        for e in (order if w % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TC_TIMED_STEPS):
                t0 = time.perf_counter()
                trainers[e].train_step(batches[e])
                torch.cuda.synchronize()
                step_s[e].append(time.perf_counter() - t0)
            peaks[e].append(torch.cuda.max_memory_allocated())
    out = {}
    for e in models:
        prof = profile_device(lambda: trainers[e].train_step(batches[e]))
        launches = sum(g["launches"] for g in (prof["groups"] or {})
                       .values())
        out[e] = dict(step_ms=[1e3 * t for t in step_s[e]],
                      step_p50_ms=1e3 * percentile(step_s[e], 50),
                      texts_per_s=TC_BATCH / percentile(step_s[e], 50),
                      peak_memory_bytes=max(peaks[e]),
                      launches_per_step=launches,
                      device_busy_ms=prof.get("device_busy_ms"),
                      idle_share=prof["idle_share"], profile=prof)
    return dict(windows=TC_WINDOWS, steps_per_window=TC_TIMED_STEPS,
                batch=TC_BATCH, **out)


def anomaly_leg(seed):
    rs = np.random.default_rng(seed)
    t = np.arange(AD_BATCH + AD_UNROLL, dtype=np.float32)
    series = np.sin(t / 12.0) + 0.1 * rs.standard_normal(t.shape)
    feats, labels, _ = AnomalyDetector.unroll(series, AD_UNROLL)
    feats, labels = feats[:AD_BATCH], labels[:AD_BATCH, None]
    model = seeded_zoo_model(lambda: AnomalyDetector(
        (AD_UNROLL, 1), hidden_layers=AD_HIDDEN, dropouts=AD_DROPOUTS), seed)
    _, err = check_predict("AnomalyDetector", model, feats, AD_BATCH)
    model.compile("rmsprop", "mse")
    fit = fit_one_batch("AnomalyDetector", model, feats, labels, AD_BATCH,
                        SEQ_FIT_STEPS)
    pred = model.predict(feats, batch_size=AD_BATCH).reshape(-1)
    _, _, anomaly = AnomalyDetector.detect_anomalies(labels, pred, 5)
    flagged = int(np.isfinite(anomaly).sum())
    if flagged < 1:
        raise AssertionError("AnomalyDetector flagged nothing")
    return dict(feature_shape=[AD_UNROLL, 1], hidden_layers=AD_HIDDEN,
                dropouts=AD_DROPOUTS, batch=AD_BATCH, optimizer="rmsprop",
                loss="mse", predict_cpu_max_abs_err=err,
                anomalies_flagged=flagged, **fit)


def knrm_pairs(rs, n):
    """n interleaved (relevant, irrelevant) documents for n / 2 queries:
    the relevant one repeats the query's words."""
    q = rs.integers(1, KNRM_VOCAB, (n // 2, KNRM_L1))
    pos = np.tile(q, (1, KNRM_L2 // KNRM_L1 + 1))[:, :KNRM_L2]
    neg = rs.integers(1, KNRM_VOCAB, (n // 2, KNRM_L2))
    x = np.empty((n, KNRM_L1 + KNRM_L2), np.float32)
    x[0::2] = np.concatenate([q, pos], 1)
    x[1::2] = np.concatenate([q, neg], 1)
    y = np.zeros((n, 1), np.float32)
    y[0::2] = 1.0
    return x, y


def knrm_group(rs):
    """One query's KNRM_CANDIDATES documents: the first two repeat the
    query's words (label 1), the rest are random (label 0)."""
    q = rs.integers(1, KNRM_VOCAB, KNRM_L1)
    docs = rs.integers(1, KNRM_VOCAB, (KNRM_CANDIDATES, KNRM_L2))
    docs[:2, :KNRM_L1] = q
    x = np.concatenate([np.tile(q, (KNRM_CANDIDATES, 1)), docs], 1)
    labels = np.zeros(KNRM_CANDIDATES, np.float32)
    labels[:2] = 1.0
    return x.astype(np.float32), labels


def knrm_word(i):
    return chr(97 + i // 676 % 26) + chr(97 + i // 26 % 26) + chr(97 + i % 26)


def knrm_corpora(rs):
    """The ranking leg's query and document TextSets, through tokenize,
    normalize, word2idx (the documents extend the queries' index) and
    shape_sequence, and their relations."""
    queries, docs, relations = [], [], []
    for qi in range(KNRM_QUERIES):
        words = [knrm_word(int(i))
                 for i in rs.integers(0, KNRM_WORDS, KNRM_L1)]
        queries.append(TextFeature(" ".join(words).title() + ".",
                                   uri=f"q{qi}"))
        for j in range(KNRM_RELEVANT + KNRM_IRRELEVANT):
            body = [knrm_word(int(i))
                    for i in rs.integers(0, KNRM_WORDS, KNRM_L2)]
            if j < KNRM_RELEVANT:
                body[:KNRM_L1] = words
            docs.append(TextFeature(" ".join(body), uri=f"d{qi}-{j}"))
            relations.append(Relation(f"q{qi}", f"d{qi}-{j}",
                                      int(j < KNRM_RELEVANT)))
    q = TextSet.array(queries).tokenize().normalize().word2idx() \
        .shape_sequence(KNRM_L1)
    d = TextSet.array(docs).tokenize().normalize() \
        .word2idx(existing_map=q.get_word_index()).shape_sequence(KNRM_L2)
    return q, d, relations


def knrm_ranking_leg(seed):
    """KNRM's ranking route as the reference takes it: the zoo model's
    graph under ``TimeDistributed`` (input (2, L1 + L2): a relevant and
    an irrelevant document for one query), trained by ``fit`` with
    ``rank_hinge`` on a ``from_relation_pairs`` TextSet, whose samples
    keep each pair whole through the shuffle; then NDCG@3 and MAP on a
    ``from_relation_lists`` TextSet, on the card and on the CPU twin of
    the trained weights (the wrapper trains KNRM's own)."""
    rs = np.random.default_rng(seed)
    t0 = time.perf_counter()
    q, d, relations = knrm_corpora(rs)
    pairs = TextSet.from_relation_pairs(relations, q, d)
    lists = TextSet.from_relation_lists(relations, q, d)
    text_s = time.perf_counter() - t0
    words = len(d.get_word_index())
    if len(pairs) < KNRM_PAIRS or words >= KNRM_VOCAB or \
            len(lists) != KNRM_QUERIES:
        raise AssertionError(f"KNRM corpora: {len(pairs)} pairs, {words} "
                             f"words, {len(lists)} lists")
    knrm = seeded_zoo_model(lambda: KNRM(
        KNRM_L1, KNRM_L2, KNRM_VOCAB, embed_size=KNRM_EMBED,
        kernel_num=KNRM_KERNELS, target_mode="ranking"), seed)
    ranker = Sequential()
    ranker.add(L.TimeDistributed(knrm.model,
                                 input_shape=(2, KNRM_L1 + KNRM_L2)))
    x = pairs.to_feature_set().features[0]
    _, err = check_predict("KNRM(ranking)", ranker, x, len(pairs))
    ranker.compile(Adam(lr=1e-3), "rank_hinge")
    fit = fit_one_batch("KNRM(ranking)", ranker, pairs, None, len(pairs),
                        SEQ_FIT_STEPS)
    twin = zoo_twin(knrm)
    ndcg, ndcg_cpu = knrm.evaluate_ndcg(lists, 3), \
        twin.evaluate_ndcg(lists, 3)
    mean_ap, map_cpu = knrm.evaluate_map(lists), twin.evaluate_map(lists)
    if abs(ndcg - ndcg_cpu) > 1e-6 or abs(mean_ap - map_cpu) > 1e-6:
        raise AssertionError(f"KNRM(ranking): NDCG@3 {ndcg} / {ndcg_cpu}, "
                             f"MAP {mean_ap} / {map_cpu} on the card / "
                             "the CPU")
    return dict(target_mode="ranking", loss="rank_hinge",
                route="TimeDistributed(knrm.model) on TextSet "
                      "from_relation_pairs", pairs=len(pairs),
                batch=len(pairs), queries=KNRM_QUERIES,
                documents=len(d), words=words, text_pipeline_s=text_s,
                text1_length=KNRM_L1, text2_length=KNRM_L2,
                vocab=KNRM_VOCAB, embed_size=KNRM_EMBED,
                kernel_num=KNRM_KERNELS, predict_cpu_max_abs_err=err,
                ndcg_at_3=ndcg, ndcg_at_3_cpu=ndcg_cpu, map=mean_ap,
                map_cpu=map_cpu, query_lists=len(lists), **fit)


def knrm_leg(seed, target_mode, loss):
    rs = np.random.default_rng(seed)
    x, y = knrm_pairs(rs, KNRM_PAIRS)
    model = seeded_zoo_model(lambda: KNRM(
        KNRM_L1, KNRM_L2, KNRM_VOCAB, embed_size=KNRM_EMBED,
        kernel_num=KNRM_KERNELS, target_mode=target_mode), seed)
    _, err = check_predict(f"KNRM({target_mode})", model, x, KNRM_PAIRS)
    model.compile(Adam(lr=1e-3), loss)
    fit = fit_one_batch(f"KNRM({target_mode})", model, x, y, KNRM_PAIRS,
                        SEQ_FIT_STEPS)
    # ranking on the card against the CPU twin of the trained weights
    groups = [knrm_group(rs) for _ in range(KNRM_QUERIES)]
    twin = zoo_twin(model)
    ndcg, ndcg_cpu = model.evaluate_ndcg(groups, 3), \
        twin.evaluate_ndcg(groups, 3)
    mean_ap, map_cpu = model.evaluate_map(groups), twin.evaluate_map(groups)
    if abs(ndcg - ndcg_cpu) > 1e-6 or abs(mean_ap - map_cpu) > 1e-6:
        raise AssertionError(f"KNRM({target_mode}): NDCG@3 {ndcg} / "
                             f"{ndcg_cpu}, MAP {mean_ap} / {map_cpu} on "
                             "the card / the CPU")
    return dict(target_mode=target_mode, loss=loss, batch=KNRM_PAIRS,
                text1_length=KNRM_L1, text2_length=KNRM_L2,
                vocab=KNRM_VOCAB, embed_size=KNRM_EMBED,
                kernel_num=KNRM_KERNELS, predict_cpu_max_abs_err=err,
                ndcg_at_3=ndcg, ndcg_at_3_cpu=ndcg_cpu, map=mean_ap,
                map_cpu=map_cpu, query_groups=KNRM_QUERIES, **fit)


def session_leg(seed):
    rs = np.random.default_rng(seed)
    sess = rs.integers(1, SR_ITEMS + 1, (SR_BATCH, SR_SESSION)) \
        .astype(np.int32)
    hist = rs.integers(1, SR_ITEMS + 1, (SR_BATCH, SR_HISTORY)) \
        .astype(np.int32)
    y = (sess[:, -1] - 1).astype(np.int32)
    model = seeded_zoo_model(lambda: SessionRecommender(
        SR_ITEMS, SR_EMBED, session_length=SR_SESSION, include_history=True,
        history_length=SR_HISTORY), seed)
    _, err = check_predict("SessionRecommender", model, [sess, hist],
                           SR_BATCH)
    model.compile(Adam(lr=1e-3), "sparse_categorical_crossentropy")
    fit = fit_one_batch("SessionRecommender", model, [sess, hist], y,
                        SR_BATCH, SEQ_FIT_STEPS)
    samples = [Sample([s, h]) for s, h in zip(sess[:SR_RECOMMEND],
                                              hist[:SR_RECOMMEND])]
    recs = model.recommend_for_session(samples, SR_MAX_ITEMS)
    want = zoo_twin(model).recommend_for_session(samples, SR_MAX_ITEMS)
    same = [[i for i, _ in r] for r in recs] == \
        [[i for i, _ in r] for r in want]
    prob_err = float(np.abs(np.array([[p for _, p in r] for r in recs]) -
                            np.array([[p for _, p in r] for r in want]))
                     .max())
    if not same or prob_err > SEQ_CPU_TOL:
        raise AssertionError(f"recommend_for_session on the card: items "
                             f"equal {same}, probabilities off by "
                             f"{prob_err}")
    return dict(items=SR_ITEMS, item_embed=SR_EMBED,
                rnn_hidden_layers=[40, 20], mlp_hidden_layers=[40, 20],
                session_length=SR_SESSION, history_length=SR_HISTORY,
                batch=SR_BATCH, predict_cpu_max_abs_err=err,
                recommend_sessions=SR_RECOMMEND, max_items=SR_MAX_ITEMS,
                recommendations_equal_cpu=same,
                recommendation_prob_max_err=prob_err, **fit)


def seq2seq_leg(seed):
    def make():
        return Seq2seq(
            RNNEncoder.initialize("lstm", S2S_LAYERS, S2S_HIDDEN),
            RNNDecoder.initialize("lstm", S2S_LAYERS, S2S_HIDDEN),
            [S2S_T_IN, S2S_FEAT], [S2S_T_OUT, S2S_FEAT],
            bridge=Bridge("dense", S2S_HIDDEN),
            generator=L.TimeDistributed(L.Dense(S2S_FEAT)))

    rs = np.random.default_rng(seed)
    x_enc = rs.standard_normal((S2S_BATCH, S2S_T_IN, S2S_FEAT)) \
        .astype(np.float32)
    x_dec = rs.standard_normal((S2S_BATCH, S2S_T_OUT, S2S_FEAT)) \
        .astype(np.float32)
    y = np.roll(x_dec, -1, axis=1)
    model = seeded_zoo_model(make, seed)
    _, err = check_predict("Seq2seq", model, [x_enc, x_dec], S2S_BATCH)
    model.compile(Adam(lr=1e-3), "mse")
    fit = fit_one_batch("Seq2seq", model, [x_enc, x_dec], y, S2S_BATCH,
                        SEQ_FIT_STEPS)
    start = rs.standard_normal(S2S_FEAT).astype(np.float32)
    src = x_enc[:S2S_INFER_ROWS]
    t0 = time.perf_counter()
    got = model.infer(src, start, max_seq_len=S2S_INFER_LEN)
    infer_s = time.perf_counter() - t0
    # the same weights' infer on the CPU
    twin = zoo_twin(model)
    layers = {l.name: l for l in twin.model.graph_function().layers}
    for role in ("encoder", "decoder", "bridge", "generator"):
        setattr(twin, role, layers[getattr(model, role).name])
    want = twin.infer(src, start, max_seq_len=S2S_INFER_LEN)
    cpu_err = float(np.abs(got - want).max())
    # the reference's loop on the card, one row, stopped by a token of
    # its own stream
    free = model.infer_reference(src[0], start, max_seq_len=6)
    stop = free[0, 4]
    ref = model.infer_reference(src[0], start, max_seq_len=S2S_INFER_LEN,
                                stop_sign=stop)
    cached = model.infer(src[0], start, max_seq_len=S2S_INFER_LEN,
                         stop_sign=stop)
    ref_err = float(np.abs(ref - cached).max()) \
        if ref.shape == cached.shape else float("inf")
    launches = no_launches("Seq2seq infer")
    if got.shape != (S2S_INFER_ROWS, S2S_INFER_LEN + 1, S2S_FEAT) or \
            not np.isfinite(got).all() or cpu_err > SEQ_CPU_TOL or \
            ref.shape != (1, 5, S2S_FEAT) or \
            ref_err > S2S_REFERENCE_TOL or launches:
        raise AssertionError(
            f"Seq2seq infer: shape {got.shape}, off the CPU by {cpu_err}; "
            f"with the stop sign {ref.shape} / {cached.shape}, off the "
            f"reference loop by {ref_err}; launches {launches}")
    return dict(rnn_type="lstm", nlayers=S2S_LAYERS, hidden=S2S_HIDDEN,
                bridge="dense", generator="TimeDistributed(Dense)",
                feat=S2S_FEAT, t_in=S2S_T_IN, t_out=S2S_T_OUT,
                batch=S2S_BATCH, predict_cpu_max_abs_err=err,
                infer_rows=S2S_INFER_ROWS, infer_len=S2S_INFER_LEN,
                infer_s=infer_s, infer_cpu_max_abs_err=cpu_err,
                infer_reference_steps=int(ref.shape[1]),
                infer_reference_max_abs_err=ref_err, **fit)


def sequence(seed, smi):
    """The sequence phase: the TextClassifier leg at news20's widths for
    each encoder, timed in alternating windows; then AnomalyDetector,
    KNRM (both target modes), SessionRecommender and Seq2seq. The launch
    counts are set to 0 as it starts and read as it ends, so every
    predict, fit, evaluate, timed and profiled step and infer of the
    phase is counted. Returns the report and K1-K5's launches over the
    phase (none, or it fails)."""
    t0 = time.perf_counter()
    _kernels.LAUNCHES.reset()
    table = np.random.default_rng(seed + 40).standard_normal(
        (TC_MAX_WORDS + 1, TC_TOKEN_LEN)).astype(np.float32)
    x, y = text_data(seed + 41, TC_BATCH)
    models, legs = {}, {}
    for i, encoder in enumerate(TC_ENCODERS):
        models[encoder], legs[encoder] = text_classifier_leg(
            encoder, seed + 42 + i, table, x, y)
    timing = time_text_classifiers(models, x, y)
    del models
    collect()
    others = dict(
        anomaly_detector=anomaly_leg(seed + 45),
        knrm_ranking=knrm_ranking_leg(seed + 46),
        knrm_classification=knrm_leg(seed + 47, "classification",
                                     "binary_crossentropy"),
        session_recommender=session_leg(seed + 48),
        seq2seq=seq2seq_leg(seed + 49))
    collect()
    launches = no_launches("the sequence phase")
    return dict(
        card=smi, model="TextClassifier (text_classification.py, news20)",
        classes=TC_CLASSES, sequence_length=TC_SEQ_LEN,
        token_length=TC_TOKEN_LEN, max_words=TC_MAX_WORDS,
        encoder_output_dim=TC_ENCODER_DIM, batch=TC_BATCH,
        optimizer=f"adagrad lr {TC_LR}",
        loss="sparse_categorical_crossentropy", steps=TC_STEPS,
        compute_dtype="float32",
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        text_classifier=legs, timing=timing, **others,
        k1_k5_launches=launches,
        clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                          "temperature.gpu"),
        wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

# bench.py's ResNet-50 leg (bench_resnet_mfu :551, _bench_resnet_mfu_at
# :601): ImageClassifier(class_num=1000, model_name="resnet-50") on
# 3 x 224 x 224 NCHW, bf16 over float32 weights, SGD at its default lr
# 0.01, sparse categorical cross-entropy, seeded N(0, 1) images and int32
# labels in [0, 1000); batch 256, the JAX package's own measured batch.
# Its FLOP count a step is 3 x 2 x 4.09e9 x batch (bench.py:548, :646).
RESNET_CLASSES, RESNET_SHAPE = 1000, (3, 224, 224)
RESNET_BATCH, RESNET_STEPS = 256, 8
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.09e9
RESNET_PARITY_ROWS, RESNET_PREDICT_ROWS = 2, 8
# one train_step, card against the port's CPU run, on RESNET_PARITY_SEEDS
# draws of the start (weights, the last gamma of each residual branch
# from U(RESNET_BRANCH_GAMMA), 2 images), so that every parameter carries
# a gradient. Whole model: (loss, moving statistics); float32 sums in
# another order, bf16 rounds at other places. The gradients are held
# layer by layer (utils/layer_parity.py): each layer's output, input
# gradients and parameter gradients from the card's own inputs, over the
# CPU's norm: float32 1e-4 (measured up to 9.8e-6 over the 3 starts,
# NVIDIA H100 80GB HBM3), bf16 2e-2 (measured up to 4.1e-3, where bf16
# arithmetic alone moves the CPU's layers up to 3.4e-3 from float32; the
# fused backward on NCHW bf16, which rounds dgamma and dbeta through
# bf16, read 5.1e-2). Whole-model gradients are reported, not gated: one
# float32 step of this ResNet-50 lands 0.4-0.7% of a gradient's norm
# from the float64 one on the CPU alone, as ReLU masks near zero flip
# (tools/resnet_grad_conditioning.py).
RESNET_PARITY_SEEDS = 3
RESNET_BRANCH_GAMMA = (0.1, 0.25)
RESNET_STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
RESNET_LAYER_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RESNET_PREDICT_TOL = 1e-4
RESNET_ROW_SUM_TOL = 1e-3
RESNET_TIMED_STEPS = 5


def conv_kernel_group(name: str) -> str:
    """The ResNet step's kernels by what they do, from their symbols:
    cuDNN's convolutions (forward, backward data, backward filter) and
    its NCHW <-> NHWC layout transposes, cuBLAS, PyTorch's batch norm
    kernels, pooling, reductions (the loss, the layout copies' sums) and
    elementwise kernels (ReLU, the adds, casts, SGD)."""
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout transposes (cuDNN)"
    if "wgrad" in low:
        return "convolution backward filter"
    if "dgrad" in low:
        return "convolution backward data"
    if any(s in low for s in ("fprop", "implicit_convolve", "winograd",
                              "convolve", "conv2d")):
        return "convolution forward"
    if any(s in low for s in ("cudnn", "xmma", "cutlass")):
        return "convolution (other cuDNN)"
    if any(s in low for s in ("gemm", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "batch_norm" in low:
        return "batch norm"
    if "pool" in low:
        return "pooling"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def draw_branch_gammas(model, seed):
    """The gamma of the last BatchNorm of every bottleneck branch drawn
    from U(RESNET_BRANCH_GAMMA) (0.1-0.25 of the Keras init of 1): small
    enough to keep the step's activations moderate, nonzero so that every
    convolution and BatchNorm in a branch carries a gradient."""
    gen = torch.Generator().manual_seed(seed)
    lo, hi = RESNET_BRANCH_GAMMA
    with torch.no_grad():
        for node in model.graph_function().nodes:
            if isinstance(node.layer, L.Add):
                gamma = node.inputs[0].node.layer.gamma
                gamma.copy_(lo + (hi - lo) * torch.rand(gamma.shape,
                                                        generator=gen))


def resnet_twin(model):
    """A second build of ResNet-50 on the CPU holding ``model``'s weights
    and moving statistics (copied in order: ``copy.deepcopy`` recurses
    once a graph node deep, too deep for this graph)."""
    twin = ImageClassifier(class_num=RESNET_CLASSES,
                           model_name="resnet-50").model
    with torch.no_grad():
        for mine, theirs in ((twin.parameters(), model.parameters()),
                             (twin.buffers(), model.buffers())):
            for a, b in zip(mine, theirs):
                a.copy_(b.detach().cpu())
    return twin


def resnet_data(seed, n):
    """bench.py:616-617: N(0, 1) float32 images, int32 labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + RESNET_SHAPE).astype(np.float32)
    y = rng.integers(0, RESNET_CLASSES, (n,)).astype(np.int32)
    return x, y


def build_resnet(seed):
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    clf = ImageClassifier(class_num=RESNET_CLASSES, model_name="resnet-50")
    config.seed = seed0     # the model drew its weights from seed
    return clf


def check_resnet_parity(seed, device):
    """ResNet-50 on the card against the port's CPU run from the same
    weights and seeded moving statistics: ``predict`` of
    RESNET_PREDICT_ROWS images in float32; then, on RESNET_PARITY_SEEDS
    starts (``draw_branch_gammas``), one SGD ``train_step`` on
    RESNET_PARITY_ROWS images in float32 and in bf16: the loss and every
    moving statistic after the step, every layer's forward and backward
    from the card's own inputs (``compare_layers``; in bf16 also how far
    bf16 arithmetic alone moves the CPU's layers from float32), a nonzero
    CPU gradient on every convolution kernel, and no launch of K1-K5."""
    clf = build_resnet(seed + 20)
    gen = torch.Generator().manual_seed(seed + 21)
    with torch.no_grad():
        for name, b in clf.model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5
                    if name.endswith("moving_var") else
                    0.2 * torch.randn(b.shape, generator=gen))
    x, y = resnet_data(seed + 22, RESNET_PREDICT_ROWS)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    cpu_model = resnet_twin(clf.model)
    got = clf.predict(x, batch_size=RESNET_PREDICT_ROWS)
    want = SPMDTrainer(cpu_model, loss_fn, get_optimizer("sgd"),
                       device="cpu").predict(x, RESNET_PREDICT_ROWS)
    predict_err = float(np.abs(got - want).max())
    out = dict(predict_rows=RESNET_PREDICT_ROWS,
               predict_max_abs_err=predict_err,
               predict_tol=RESNET_PREDICT_TOL,
               branch_gamma=RESNET_BRANCH_GAMMA, steps=[])
    if got.shape != (RESNET_PREDICT_ROWS, RESNET_CLASSES) or \
            not predict_err <= RESNET_PREDICT_TOL:
        emit("resnet_parity", ok=False, **out)
        raise AssertionError(f"ResNet-50 predict on the card differs from "
                             f"the CPU by {predict_err}")
    for k in range(RESNET_PARITY_SEEDS):
        start = resnet_twin(clf.model)
        draw_branch_gammas(start, seed + 30 + k)
        xk, yk = resnet_data(seed + 40 + k, RESNET_PARITY_ROWS)
        rows = ([xk], yk, np.ones(RESNET_PARITY_ROWS, np.float32))
        for dtype in ("float32", "bfloat16"):
            res = resnet_step_parity(start, rows, device, dtype)
            res.update(seed=seed + 30 + k)
            out["steps"].append(res)
            if not res["ok"]:
                emit("resnet_parity", ok=False, **out)
                raise AssertionError(f"ResNet-50 {dtype} step on the card "
                                     f"differs from the CPU: {res}")
    return out


def resnet_step_parity(start, rows, device, dtype):
    """One ``train_step`` of copies of ``start`` on the card and on the
    CPU in ``dtype``, the card's layers recorded and held against the
    CPU's (see check_resnet_parity)."""
    loss_fn = get_loss("sparse_categorical_crossentropy")
    card_model, cpu_model = resnet_twin(start), resnet_twin(start)
    card = SPMDTrainer(card_model, loss_fn, get_optimizer("sgd"),
                       device=device, compute_dtype=dtype)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("sgd"),
                      device="cpu", compute_dtype=dtype)
    card.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    with LayerRecorder(card_model) as recorder:
        card_loss = card.train_step(card.put_batch(rows)).item()
    launches = _kernels.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    cpu_loss = cpu.train_step(cpu.put_batch(rows)).item()
    cpu_s = time.perf_counter() - t0
    layers = compare_layers(
        recorder, resnet_twin(start),
        also_in=torch.float32 if dtype == "bfloat16" else None)
    worst = {"y": (0.0, None), "dx": (0.0, None), "param": (0.0, None)}
    wide = 0.0
    for name, r in layers.items():
        for key, val in [("y", r["y"])] + [("dx", d) for d in r["dx"]
                                           if d is not None] + \
                [("param", r[p]) for p in r["ref_norm"]]:
            if not val <= worst[key][0]:
                worst[key] = (val, name)
        wide = max(wide, r.get("vs_float32", 0.0))
    convs = {n: r["ref_norm"]["kernel"] for n, r in layers.items()
             if n.startswith("convolution2d")}
    zero_kernels = [n for n, norm in convs.items() if not norm > 0.0]
    whole = max(((g.grad.cpu() - q.grad).norm() /
                 max(q.grad.norm().item(), 1e-12)).item()
                for g, q in zip(card_model.parameters(),
                                cpu_model.parameters()))
    finite = all(torch.isfinite(p.grad).all().item()
                 for p in card_model.parameters())
    stats_err = max((b.cpu() - c).abs().max().item()
                    for b, c in zip(card_model.buffers(),
                                    cpu_model.buffers()))
    loss_tol, stats_tol = RESNET_STEP_TOL[dtype]
    layer_tol = RESNET_LAYER_TOL[dtype]
    ok = (not launches and finite and len(convs) == 53 and
          not zero_kernels and
          abs(card_loss - cpu_loss) <= loss_tol and
          stats_err <= stats_tol and
          all(v <= layer_tol for v, _ in worst.values()))
    return dict(ok=ok, dtype=dtype, rows=RESNET_PARITY_ROWS,
                card_loss=card_loss, cpu_loss=cpu_loss,
                loss_err=abs(card_loss - cpu_loss), loss_tol=loss_tol,
                moving_stats_max_abs_err=stats_err, stats_tol=stats_tol,
                layers=len(layers), layer_tol=layer_tol,
                layer_max_rel_err=worst,
                layer_bf16_vs_float32_on_cpu=wide,
                conv_kernels_checked=len(convs),
                conv_kernels_with_zero_cpu_grad=zero_kernels,
                min_conv_kernel_cpu_grad_norm=min(convs.values()),
                whole_model_max_grad_rel_err=whole, grads_finite=finite,
                kernel_launches=launches, cpu_step_s=cpu_s)


def check_float32_leaves(tree, where):
    """Every floating tensor in ``tree`` (dicts and lists of them) is
    float32."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_float32_leaves(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            check_float32_leaves(v, f"{where}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point() and \
            tree.dtype != torch.float32:
        raise AssertionError(f"{where}: {tree.dtype}")


def resnet_fit(seed, x, y):
    """bench.py's configuration through ``compile``/``fit``/``evaluate``/
    ``predict`` in bf16: RESNET_STEPS steps of ``fit`` on one seeded batch
    of RESNET_BATCH images (one epoch a step), with K1-K5's launch counts
    read around the fit."""
    clf = build_resnet(seed + 23)
    clf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    clf.model.set_compute_dtype("bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    clf.fit(x, y, batch_size=RESNET_BATCH, nb_epoch=RESNET_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses = list(clf.model.trainer.step_losses)
    if launches:
        raise AssertionError(f"the ResNet-50 fit launched {launches}")
    if len(losses) != RESNET_STEPS or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 losses {losses}")
    model = clf.model
    stats = model.state_tree()
    moved = {}
    for name, s in stats.items():
        mean, var = s["moving_mean"], s["moving_var"]
        if mean.dtype != torch.float32 or var.dtype != torch.float32 or \
                not torch.isfinite(mean).all() or \
                not torch.isfinite(var).all():
            raise AssertionError(f"{name}: moving statistics {mean.dtype} "
                                 f"{var.dtype}, or not finite")
        moved[name] = min(mean.abs().max().item(),
                          (var - 1).abs().max().item())
    if len(stats) != 53 or min(moved.values()) <= 0.0:
        raise AssertionError(f"moving statistics did not move: {moved}")
    check_float32_leaves(dict(model.named_parameters()), "params")
    check_float32_leaves({n: p.grad for n, p in model.named_parameters()},
                         "grads")
    check_float32_leaves(model.trainer.opt_state, "sgd state")
    kernels = {n: p.grad.abs().max().item()
               for n, p in model.named_parameters()
               if n.endswith(".kernel") and "convolution2d" in n}
    if len(kernels) != 53 or min(kernels.values()) <= 0.0:
        raise AssertionError(f"convolution kernels without a gradient: "
                             f"{[n for n, g in kernels.items() if g <= 0]}")
    results = clf.evaluate(x, y, batch_size=RESNET_BATCH // 2)
    probs = clf.predict(x[:RESNET_BATCH // 4], batch_size=RESNET_BATCH // 4)
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if not np.isfinite(results["loss"]) or \
            probs.shape != (RESNET_BATCH // 4, RESNET_CLASSES) or \
            not row_err <= RESNET_ROW_SUM_TOL:
        raise AssertionError(f"evaluate {results}, predict rows off 1 by "
                             f"{row_err}")
    return clf, dict(
        model="ResNet-50 ImageClassifier (bench.py:551-646)",
        classes=RESNET_CLASSES, input_shape=RESNET_SHAPE, data_format="th",
        compute_dtype="bfloat16", optimizer="sgd lr 0.01",
        loss="sparse_categorical_crossentropy", batch=RESNET_BATCH,
        steps=RESNET_STEPS, seed=seed,
        params=sum(p.numel() for p in model.parameters()), losses=losses,
        k1_k5_launches=launches, fit_wall_s=wall, peak_memory_bytes=peak,
        min_moving_stat_shift=min(moved.values()),
        min_conv_kernel_grad=min(kernels.values()),
        float32_params_grads_and_sgd_state=True, evaluate=results,
        predict_rows=RESNET_BATCH // 4, predict_row_sum_max_err=row_err,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        cudnn_benchmark=torch.backends.cudnn.benchmark)


def time_resnet_dtypes(bf16_clf, seed, x, y):
    """The bf16 step of the fitted model and a float32 model's step at the
    same batch, in alternating windows of RESNET_TIMED_STEPS steps (f32,
    bf16, bf16, f32): host clock around each synchronised step, p50,
    images/s, MFU by bench.py's count, each window's peak memory; then the
    step's device time by kernel group in each dtype, and the bf16
    forward and backward alone, whose difference from the step is the
    SGD update."""
    f32_clf = build_resnet(seed + 24)
    f32_clf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    trainers = {"float32": f32_clf.model._ensure_trainer(),
                "bfloat16": bf16_clf.model.trainer}
    trainers["float32"].ensure_initialized()
    batches = {dt: t.put_batch(([x], y, np.ones(RESNET_BATCH, np.float32)))
               for dt, t in trainers.items()}
    trainers["float32"].train_step(batches["float32"])     # warm-up
    step_s = {dt: [] for dt in trainers}
    peaks = {dt: [] for dt in trainers}
    order = list(trainers)
    for w in range(DTYPE_WINDOWS):
        for dt in (order if w % 2 == 0 else order[::-1]):
            trainer = trainers[dt]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(RESNET_TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batches[dt])
                torch.cuda.synchronize()
                step_s[dt].append(time.perf_counter() - t0)
            peaks[dt].append(torch.cuda.max_memory_allocated())
    out = {}
    for dt in trainers:
        p50 = percentile(step_s[dt], 50)
        flops = RESNET_FLOPS_PER_IMAGE * RESNET_BATCH
        out[dt] = dict(batch=RESNET_BATCH,
                       step_ms=[1e3 * t for t in step_s[dt]],
                       step_p50_ms=1e3 * p50,
                       images_per_s=RESNET_BATCH / p50,
                       tflops_per_s=flops / p50 / 1e12,
                       mfu=flops / p50 / PEAK_FLOPS[torch.bfloat16],
                       bound_ms=1e3 * flops / PEAK_FLOPS[torch.bfloat16],
                       peak_memory_bytes=max(peaks[dt]))
    f32 = trainers["float32"]
    out["float32"]["profile"] = profile_device(
        lambda: f32.train_step(batches["float32"]), conv_kernel_group)
    bf16 = trainers["bfloat16"]
    batch = batches["bfloat16"]
    step = profile_device(lambda: bf16.train_step(batch), conv_kernel_group)
    fwd_bwd = profile_device(lambda: bf16.loss_and_grads(batch),
                             conv_kernel_group)
    out["bfloat16"]["profile"] = step
    out["bfloat16"]["forward_backward_profile"] = fwd_bwd
    if step["groups"] and fwd_bwd["groups"]:
        out["bfloat16"]["launches_per_step"] = sum(
            g["launches"] for g in step["groups"].values())
        out["bfloat16"]["sgd_update"] = dict(
            device_ms=step["device_busy_ms"] - fwd_bwd["device_busy_ms"],
            launches=out["bfloat16"]["launches_per_step"] - sum(
                g["launches"] for g in fwd_bwd["groups"].values()))
    out["bf16_speedup_per_image"] = \
        out["bfloat16"]["images_per_s"] / out["float32"]["images_per_s"]
    return dict(windows=DTYPE_WINDOWS, steps_per_window=RESNET_TIMED_STEPS,
                mfu_peak="989 TFLOP/s (bf16 dense, H100 SXM data sheet)",
                flops_per_image=RESNET_FLOPS_PER_IMAGE, **out)


def resnet(seed, device, smi):
    """The resnet phase: parity with the CPU, bench.py's configuration
    through fit in bf16, and the timing of the bf16 and float32 steps."""
    t0 = time.perf_counter()
    parity = check_resnet_parity(seed, device)
    parity_s = time.perf_counter() - t0
    x, y = resnet_data(seed + 25, RESNET_BATCH)
    clf, report = resnet_fit(seed, x, y)
    report["parity"] = parity
    report["parity_s"] = parity_s
    report["timing"] = time_resnet_dtypes(clf, seed, x, y)
    report["clocks"] = nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu")
    emit("resnet", card=smi, **report)


# ---------------------------------------------------------------------------
# 12. cluster serving
# ---------------------------------------------------------------------------

# Cluster Serving's stream: bench.py's ResNet-50 ImageClassifier (predict
# records of one (3, 224, 224) float32 tensor) and the generate phase's
# GPT-width decoder (generate records) served from one file-backed stream
# fed by a client in a second process. Every CS_GEN_EVERY-th record is a
# generate record, with a prompt of CS_MIN_PROMPT-CS_MAX_PROMPT tokens.
CS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_serving")
CS_PREDICTS, CS_GENERATES, CS_GEN_EVERY = 256, 32, 9
CS_MIN_PROMPT, CS_MAX_PROMPT = 32, 448
CS_CONFIG = {"data": {"image_shape": "3, 224, 224"},
             "params": {"batch_size": 16, "top_n": 5, "decode_workers": 2,
                        "warmup": True},
             "generate": {"slots": 8, "max_len": 512, "max_new_tokens": 32}}
CS_BUCKETS = [1, 2, 4, 8, 16]
CS_CLIENT_TIMEOUT_S = 300.0
# the served rows against the port's CPU predict of CS_CPU_ROWS images
# (50 layers of float32 convolutions summed in another order: RESNET_
# PREDICT_TOL), and against the card's own direct predict of every image
# in batches of 16 (the loop pads to other batch shapes, where cuDNN may
# pick another algorithm: probabilities of ~1e-3 move by ~1e-9). Two
# classes whose probabilities lie within the tolerance may trade places
# in the top 5 (a near tie); any other difference in the ids fails.
CS_CPU_ROWS, CS_CPU_TOL, CS_DIRECT_TOL = 16, 1e-4, 1e-5
CS_REFERENCE_STREAMS = 8
CS_REGISTRY_RECORDS, CS_CANARY_WEIGHT = 64, 0.5
# pipelined and synchronous loops in alternating windows (pipelined,
# synchronous, synchronous, pipelined) of CS_WINDOW predict records, all
# queued before the loop starts
CS_WINDOW, CS_WINDOWS = 128, 4


def cs_spec():
    """What makes the stream, handed to the client process whole."""
    return dict(predicts=CS_PREDICTS, generates=CS_GENERATES,
                every=CS_GEN_EVERY, min_prompt=CS_MIN_PROMPT,
                max_prompt=CS_MAX_PROMPT, shape=RESNET_SHAPE,
                vocab=GPT_CONFIG["vocab"])


def cs_images(seed, spec):
    """The stream's images: N(0, 1) float32, as bench.py's ResNet leg."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((spec["predicts"],) + tuple(spec["shape"])) \
        .astype(np.float32)


def cs_stream(seed, spec):
    """[(uri, kind, payload)] in stream order: the images and the
    prompts, every ``spec["every"]``-th record a prompt."""
    n = spec["predicts"] + spec["generates"]
    if n // spec["every"] != spec["generates"]:
        raise ValueError(f"{spec['generates']} prompts are not every "
                         f"{spec['every']}th of {n} records")
    images = cs_images(seed, spec)
    rs = np.random.default_rng(seed + 1)
    prompts = [rs.integers(1, spec["vocab"], size=int(m))
               for m in rs.integers(spec["min_prompt"],
                                    spec["max_prompt"] + 1,
                                    size=spec["generates"])]
    out, i_img = [], 0
    for i in range(n):
        if i % spec["every"] == spec["every"] - 1:
            k = i // spec["every"]
            out.append((f"gen-{k}", "generate", prompts[k]))
        else:
            out.append((f"img-{i_img}", "predict", images[i_img]))
            i_img += 1
    return out


def cs_client(root, seed, spec, results):
    """The client process: InputQueue and OutputQueue over a
    FileStreamQueue at ``root``. Writes the stream as fast as it can, then
    waits for every result; puts {"results": {uri: (value, timing,
    finish, type)}, ...} (or {"error": ...}) on ``results``."""
    from analytics_zoo_tpu_torch.serving.client import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.queue_backend import \
        FileStreamQueue
    try:
        stream = cs_stream(seed, spec)
        q = FileStreamQueue(root)
        iq = InputQueue(backend=q)
        t0 = time.time()
        for uri, kind, payload in stream:
            if kind == "predict":
                iq.enqueue(uri, t=payload)
            else:
                iq.enqueue_generate(uri, payload)
        t_written = time.time()
        got = OutputQueue(backend=q).wait_all(
            [uri for uri, _, _ in stream], timeout=CS_CLIENT_TIMEOUT_S,
            poll=0.005, max_poll=0.05)
        t_done = time.time()
        results.put({"results": {
            uri: (np.asarray(r), r.timing, getattr(r, "finish", None),
                  type(r).__name__) for uri, r in got.items()},
            "write_s": t_written - t0, "wall_s": t_done - t0,
            "leftover": sorted(q.all_results(pop=False)),
            "stream_len": q.stream_len()})
    except Exception:  # noqa: BLE001 - reported to the parent
        import traceback
        results.put({"error": traceback.format_exc()})


def top_ids_agree(got_row, probs, tol):
    """A served top-n row ([[id, p], ...]) against a probability vector:
    (the largest probability error, the places where the ids differ by a
    near tie, and whether every other place agrees). The ids must equal
    the top-n of ``probs`` except where two classes' probabilities lie
    within ``tol``."""
    ids = got_row[:, 0].astype(np.int64)
    want = np.argsort(probs)[::-1][:len(ids)]
    err = float(np.abs(got_row[:, 1] - probs[ids]).max())
    ties, ok = 0, True
    for a, b in zip(ids, want):
        if a != b:
            if abs(probs[a] - probs[b]) <= tol:
                ties += 1
            else:
                ok = False
    return err, ties, ok and err <= tol


def check_served_rows(name, served, uris, probs, tol):
    """Every served predict row against ``probs`` (rows in ``uris``'s
    order): the largest error and the count of near ties; fails past
    ``tol``."""
    worst, ties, bad = 0.0, 0, []
    for uri, p in zip(uris, probs):
        err, t, ok = top_ids_agree(served[uri], p, tol)
        worst, ties = max(worst, err), ties + t
        if not ok:
            bad.append(uri)
    if bad:
        raise AssertionError(f"{name}: rows {bad[:5]} differ (largest "
                             f"probability error {worst}, tol {tol})")
    return dict(rows=len(uris), max_abs_err=worst, tol=tol, near_ties=ties)


def cs_direct_predict(im, x, batch=16):
    return np.concatenate([im.predict(x[i:i + batch])
                           for i in range(0, len(x), batch)])


def cs_window(im, x, pipelined):
    """One timing window: len(x) predict records queued on an in-process
    stream, then a loop of the CS_CONFIG model started and stopped after
    the last result: records/s, per-row queue/device/server ms, buckets."""
    config = copy.deepcopy(CS_CONFIG)
    config["params"]["pipelined"] = pipelined
    backend = InProcessStreamQueue()
    iq = InputQueue(backend=backend)
    uris = [f"w-{i}" for i in range(len(x))]
    for uri, row in zip(uris, x):
        iq.enqueue(uri, t=row)
    server = ClusterServing(model=im,
                            helper=ClusterServingHelper(config=config),
                            backend=backend)
    t0 = time.perf_counter()
    server.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120,
                                                poll=0.001, max_poll=0.005)
    wall = time.perf_counter() - t0
    server.stop()
    if len(got) != len(uris):
        raise AssertionError(f"timing window: {len(got)} of {len(uris)} "
                             f"results")
    timing = {k: [r.timing[k] for r in got.values()]
              for k in ("queue_ms", "device_ms", "server_ms")}
    out = dict(pipelined=pipelined, records=len(uris), wall_s=wall,
               records_per_s=len(uris) / wall,
               buckets=server.pipeline_stats()["buckets"])
    for k, v in timing.items():
        out[f"{k}_p50"] = percentile(v, 50)
        out[f"{k}_p95"] = percentile(v, 95)
    return out


def cs_registry_leg(seed, x, dirs):
    """The registry leg on the in-process transport: v1 then v2 (a canary
    of CS_CANARY_WEIGHT) of "resnet50" behind RoutedClusterServing, 64
    records served, each against its own version's direct predict; the
    canary's share against crc32 of the uris; v2 promoted and v1
    undeployed after its drain, and the manifest then lists v2 alone."""
    root = os.path.join(CS_ROOT, "registry")
    registry = ModelRegistry(root=root)
    backend = InProcessStreamQueue()
    serving = RoutedClusterServing(
        registry, helper=ClusterServingHelper(config=CS_CONFIG),
        backend=backend)
    t0 = time.perf_counter()
    serving.deploy("resnet50", path=dirs[0])
    serving.deploy("resnet50", path=dirs[1], canary_weight=CS_CANARY_WEIGHT)
    deploy_s = time.perf_counter() - t0
    uris = [f"reg-{i}" for i in range(CS_REGISTRY_RECORDS)]
    iq = InputQueue(backend=backend)
    for uri, row in zip(uris, x):
        iq.enqueue(uri, model="resnet50", t=row)
    serving.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120)
    serving.stop()
    stats = serving.pipeline_stats()
    if len(got) != len(uris) or stats["dead_letters"] or stats["dropped"]:
        raise AssertionError(f"registry leg: {len(got)} results, "
                             f"{stats['dead_letters']} dead letters")
    versions = registry._models["resnet50"]
    direct = {v: cs_direct_predict(versions[v].model, x) for v in (1, 2)}
    routed = {u: 2 if zlib.crc32(u.encode()) % 10000 / 10000.0 <
              CS_CANARY_WEIGHT else 1 for u in uris}
    rows = {v: [i for i, u in enumerate(uris) if routed[u] == v]
            for v in (1, 2)}
    checks = {f"v{v}": check_served_rows(
        f"registry v{v}", {u: np.asarray(got[u]) for u in uris},
        [uris[i] for i in rows[v]], direct[v][rows[v]], CS_DIRECT_TOL)
        for v in (1, 2)}
    served = {v: versions[v].requests for v in (1, 2)}
    if served != {v: len(rows[v]) for v in (1, 2)}:
        raise AssertionError(f"canary split {served}, crc32 of the uris "
                             f"gives {[len(rows[v]) for v in (1, 2)]}")
    registry.promote("resnet50", 2)
    removed = registry.undeploy("resnet50", 1)
    with open(os.path.join(root, ModelRegistry.MANIFEST)) as f:
        manifest = json.load(f)["models"]["resnet50"]
    listed = [v["version"] for v in manifest["versions"]]
    if removed != [1] or listed != [2] or manifest["active"] != 2 or \
            manifest["canary"] is not None:
        raise AssertionError(f"after promote and undeploy: removed "
                             f"{removed}, manifest {manifest}")
    return dict(records=len(uris), deploy_s=deploy_s,
                canary_weight=CS_CANARY_WEIGHT, routed_v2=served[2],
                routed_v1=served[1], rows=checks,
                manifest_versions=listed, buckets=stats["buckets"])


def cluster_serving(seed, device, smi):
    """The cluster_serving phase: the main run (file transport, a client
    process, predict and generate records from one stream), the registry
    leg, and the timing of the pipelined and synchronous loops. Returns
    K1-K5's launches in the main run."""
    shutil.rmtree(CS_ROOT, ignore_errors=True)
    os.makedirs(CS_ROOT)
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    dirs = []
    for k in range(2):
        clf = build_resnet(seed + k)
        dirs.append(os.path.join(CS_ROOT, f"resnet50-v{k + 1}"))
        clf.save_model(dirs[-1])
        del clf
    im = InferenceModel().load(dirs[0])
    if im.model.device != device:
        raise AssertionError(f"InferenceModel.load put it on "
                             f"{im.model.device}")
    layer = build_decoder(seed)
    server = ClusterServing(model=im,
                            helper=ClusterServingHelper(config=CS_CONFIG),
                            backend=FileStreamQueue(
                                os.path.join(CS_ROOT, "stream")))
    server.build_transformer_engine(layer)
    engine = server._gen_engine
    setup_s = time.perf_counter() - t0
    warm = server.warmup() if server.helper.warmup else {}
    if sorted(warm) != CS_BUCKETS:
        raise AssertionError(f"warmup returned buckets {sorted(warm)}")

    # the main run: the client process writes the stream and waits
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    spec = cs_spec()
    client = ctx.Process(target=cs_client, args=(
        os.path.join(CS_ROOT, "stream"), seed, spec, results))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    server.start()
    client.start()
    try:
        reply = results.get(timeout=CS_CLIENT_TIMEOUT_S + 120)
    finally:
        client.join(timeout=60)
        if client.is_alive():
            client.kill()
        server.stop()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    prefills = engine.prefill_calls
    if "error" in reply:
        raise AssertionError(f"the client process failed: {reply['error']}")
    stats = server.pipeline_stats()
    gen_stats = stats.get("generation", {})
    stream = cs_stream(seed, spec)
    got = reply["results"]
    expected = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * prefills}
    integrity = dict(
        results=len(got), uris=len(stream),
        results_out=stats["results_out"], records_in=stats["records_in"],
        dropped=stats["dropped"], dead_letters=stats["dead_letters"],
        shed=stats["shed"], queue=stats["queue"],
        committed=gen_stats.get("committed"),
        duplicate_commits=gen_stats.get("duplicate_commits"),
        leftover_results=reply["leftover"],
        stream_len=reply["stream_len"])
    if sorted(got) != sorted(u for u, _, _ in stream) or \
            stats["results_out"] != len(stream) or \
            stats["records_in"] != len(stream) or \
            stats["dropped"] or stats["dead_letters"] or stats["shed"] or \
            stats["queue"]["duplicates"] or stats["queue"]["seq_gaps"] or \
            gen_stats.get("committed") != CS_GENERATES or \
            gen_stats.get("duplicate_commits") or reply["leftover"] or \
            reply["stream_len"]:
        emit("cluster_serving", check="main run", ok=False, **integrity)
        raise AssertionError(f"cluster serving main run: {integrity}")
    if launches != expected:
        raise AssertionError(f"cluster serving launches {launches}, "
                             f"expected {expected} ({prefills} prefills)")

    # the predict rows: all against the card's direct predict, the first
    # CS_CPU_ROWS against the port's CPU predict
    img_uris = [u for u, kind, _ in stream if kind == "predict"]
    x = cs_images(seed, spec)
    served = {u: got[u][0] for u in img_uris}
    if any(got[u][3] != "ServingResult" or served[u].shape != (5, 2)
           for u in img_uris):
        raise AssertionError("a predict result is not a top-5 row")
    direct = cs_direct_predict(im, x)
    direct_check = check_served_rows("direct predict", served, img_uris,
                                     direct, CS_DIRECT_TOL)
    cpu_model = SPMDTrainer(resnet_twin(im.model.model),
                            get_loss("sparse_categorical_crossentropy"),
                            get_optimizer("sgd"), device="cpu")
    cpu_probs = cpu_model.predict(x[:CS_CPU_ROWS], CS_CPU_ROWS)
    cpu_check = check_served_rows("CPU predict", served,
                                  img_uris[:CS_CPU_ROWS], cpu_probs,
                                  CS_CPU_TOL)
    del cpu_model

    # the generate streams: against the scheduler alone on the same
    # engine, and CS_REFERENCE_STREAMS of them against greedy_reference
    gens = [(u, p) for u, kind, p in stream if kind == "generate"]
    streams = {}
    for u, _ in gens:
        value, _, finish, kind = got[u]
        if kind != "GenerationResult" or finish != "max_new_tokens" or \
                len(value) != CS_CONFIG["generate"]["max_new_tokens"]:
            raise AssertionError(f"{u}: {kind}, {finish}, {len(value)} "
                                 f"tokens")
        streams[f"g{len(streams)}"] = [int(t) for t in value]
    prompts = [p for _, p in gens]
    alone, _, _ = run_scheduler(engine, prompts,
                                CS_CONFIG["generate"]["max_new_tokens"],
                                max_slots=CS_CONFIG["generate"]["slots"])
    check_streams("cluster serving against the scheduler alone", layer,
                  prompts, streams,
                  {u: p["tokens"] for u, p in alone.items()})
    refs = {f"g{i}": greedy_reference(
        layer, prompts[i], CS_CONFIG["generate"]["max_new_tokens"])[0]
        for i in range(CS_REFERENCE_STREAMS)}
    check_streams("cluster serving against greedy_reference", layer,
                  prompts[:CS_REFERENCE_STREAMS],
                  {u: streams[u] for u in refs}, refs)
    ttft = [got[u][1]["ttft_ms"] for u, _ in gens]
    e2e = [got[u][1]["done_ts_ms"] - got[u][1]["enqueue_ts_ms"]
           for u, _ in gens]
    gen_span_s = (max(got[u][1]["done_ts_ms"] for u, _ in gens) -
                  min(got[u][1]["enqueue_ts_ms"] for u, _ in gens)) / 1e3
    rows = {k: [got[u][1][k] for u in img_uris]
            for k in ("queue_ms", "device_ms", "server_ms")}
    main = dict(
        records=len(stream), predicts=CS_PREDICTS, generates=CS_GENERATES,
        prompt_lengths=[int(p.size) for p in prompts], setup_s=setup_s,
        warmup_s=warm, launches=launches, launches_expected=expected,
        prefills=prefills, wall_s=wall, client_write_s=reply["write_s"],
        client_wall_s=reply["wall_s"],
        records_per_s=len(stream) / reply["wall_s"],
        buckets=stats["buckets"], direct=direct_check, cpu=cpu_check,
        reference_streams=CS_REFERENCE_STREAMS,
        ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
        generate_e2e_p50_ms=percentile(e2e, 50),
        generate_e2e_p95_ms=percentile(e2e, 95),
        generate_tokens_per_s=CS_GENERATES *
        CS_CONFIG["generate"]["max_new_tokens"] / gen_span_s,
        peak_memory_bytes=peak, **integrity)
    for k, v in rows.items():
        main[f"predict_{k}_p50"] = percentile(v, 50)
        main[f"predict_{k}_p95"] = percentile(v, 95)
    emit("cluster_serving", check="main run", ok=True,
         model="ImageClassifier(1000, 'resnet-50') and TransformerLayer "
               "(GPT-1 widths)", config=CS_CONFIG, seed=seed, card=smi,
         **main)
    del server

    # the registry leg
    registry = cs_registry_leg(seed, x[:CS_REGISTRY_RECORDS], dirs)
    emit("cluster_serving", check="registry", ok=True, **registry)

    # timing: pipelined against synchronous, alternating windows
    windows = [cs_window(im, x[:CS_WINDOW], pipelined=w in (0, 3))
               for w in range(CS_WINDOWS)]
    prof = profile_device(lambda: cs_window(im, x[:CS_WINDOW], True),
                          conv_kernel_group)
    # across the phase: K1 once a block for every prefill (the loop's, the
    # scheduler's alone and greedy_reference's), K2-K5 never
    phase_launches = _kernels.LAUNCHES.snapshot()
    phase_prefills = engine.prefill_calls + CS_REFERENCE_STREAMS
    want = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * phase_prefills}
    if phase_launches != want:
        raise AssertionError(f"the cluster_serving phase launched "
                             f"{phase_launches}, expected {want} "
                             f"({phase_prefills} prefills)")
    del layer, engine
    summary = {}
    for mode in (True, False):
        ws = [w for w in windows if w["pipelined"] == mode]
        summary["pipelined" if mode else "synchronous"] = dict(
            records_per_s=[w["records_per_s"] for w in ws],
            **{k: [w[k] for w in ws] for k in ws[0]
               if k.endswith(("_p50", "_p95"))},
            buckets=[w["buckets"] for w in ws])
    emit("timing", path="cluster_serving", card=smi,
         window_records=CS_WINDOW, windows=windows, by_loop=summary,
         main_run=dict(records_per_s=main["records_per_s"],
                       ttft_p50_ms=main["ttft_p50_ms"],
                       ttft_p95_ms=main["ttft_p95_ms"],
                       generate_e2e_p50_ms=main["generate_e2e_p50_ms"],
                       generate_e2e_p95_ms=main["generate_e2e_p95_ms"],
                       generate_tokens_per_s=main["generate_tokens_per_s"],
                       peak_memory_bytes=peak),
         warmup_s=warm, profile=prof, phase_launches=phase_launches,
         phase_prefills=phase_prefills,
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"))
    shutil.rmtree(CS_ROOT)
    return launches


# ---------------------------------------------------------------------------
# int8 inference
# ---------------------------------------------------------------------------

Q_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_int8")
# bench.py's bench_quant models (bench.py:860-880) at its batches,
# calibrated as bench_quant calibrates them: 3 seeded batches of 4
Q_BENCH_CALIB_BATCHES, Q_BENCH_CALIB_ROWS = 3, 4
# VGG-16 and ResNet-50 at full width, ImageClassifier(1000) on 3 x 224 x
# 224, calibrated on 4 seeded batches of 8; 2 images held against the CPU
Q_CALIB_BATCHES, Q_CALIB_ROWS, Q_PARITY_ROWS = 4, 8, 2
Q_VGG_KERNELS, Q_VGG_CHAINS, Q_RESNET_KERNELS = 16, 15, 54
# int8 against float32 on the card, reported only, over this many images
Q_AGREEMENT_ROWS = 16
# a float output of the int8 path against the CPU's from the same int32
# accumulators: float32 epilogue and softmax in another order
Q_FLOAT_TOL = 1e-6
# ResNet-50's int8 rows on the card against the CPU's int8 run from the
# same scales, relative to the row's largest probability, with the same
# top class: BatchNorm runs in float32 between the int8 convolutions, and
# the card's batch norm rounds differently from the CPU's, so an int8
# step may flip at a rounding tie of the next quantize; in the CPU parity
# tests such a flip moved a random-weight ResNet-50's probability by 1.1%
# of the row's largest (tests/test_torch_quantized_model.py)
Q_RESNET_TOL = 2e-2
Q_CS_CONFIG = {"data": {"image_shape": "3, 224, 224"},
               "params": {"batch_size": 16, "top_n": 5, "warmup": True}}
Q_REGISTRY_RECORDS, Q_CANARY_WEIGHT = 64, 0.5
# the timed runs: float32 and calibrated int8 of both models at each
# batch, Q_WINDOW_BATCHES batches a window, the windows alternating
Q_TIMED_BATCHES, Q_WINDOW_BATCHES, Q_WINDOWS = (16, 64), 4, 2


def q_bench_models():
    """bench_quant's MLP (512-1024-1024-128) and CNN (3 x 64 x 64), with
    its layer names, its batches and the JAX package's chain plan for
    them (tests/test_torch_quantized_model.py holds the port's plan
    against JAX's)."""
    def mlp(seed):
        m = Sequential(seed=seed)
        m.add(L.Dense(1024, activation="relu", input_shape=(512,),
                      name="qd1"))
        m.add(L.Dense(1024, activation="relu", name="qd2"))
        m.add(L.Dense(128, activation="relu", name="qout"))
        return m

    def cnn(seed):
        m = Sequential(seed=seed)
        m.add(L.Convolution2D(32, 3, 3, activation="relu",
                              border_mode="same", input_shape=(3, 64, 64),
                              name="qc1"))
        m.add(L.Convolution2D(32, 3, 3, activation="relu",
                              subsample=(2, 2), name="qc2"))
        m.add(L.Flatten())
        m.add(L.Dense(64, activation="relu", name="qcd1"))
        m.add(L.Dense(10, activation="relu", name="qcout"))
        return m

    return {"dense": (mlp, (64, 512), 3,
                      [("qd1", "qd2"), ("qd2", "qout")]),
            "cnn": (cnn, (8, 3, 64, 64), 4,
                    [("qc1", "qc2"), ("qc2", "qcd1"), ("qcd1", "qcout")])}


class Int8Trace:
    """What the int8 path computed in one forward, in order: every int32
    accumulator (``quant.int_product``), every entry quantize's int8
    (``quant._quantize_act``) and every int8 layer output (a requantized
    chain link, pooling, flatten), copied to the host."""

    def __init__(self, model):
        self.layers = model.graph_function().layers

    def __enter__(self):
        self.acc, self.entry, self.act = [], [], []
        self._saved = (quant.int_product, quant._quantize_act)
        product, quantize = self._saved

        def int_product(a, w):
            out = product(a, w)
            self.acc.append(out.cpu())
            return out

        def quantize_act(x, act_scale):
            out = quantize(x, act_scale)
            self.entry.append(out.cpu())
            return out

        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor) and out.dtype == torch.int8:
                self.act.append(out.cpu())

        quant.int_product, quant._quantize_act = int_product, quantize_act
        self._hooks = [layer.register_forward_hook(hook)
                       for layer in self.layers]
        return self

    def __exit__(self, *exc):
        quant.int_product, quant._quantize_act = self._saved
        for h in self._hooks:
            h.remove()
        return False


def compare_traces(card, cpu):
    """Element counts and the share of them that differ, per kind, and the
    largest difference of an int8 value (in quantization steps)."""
    out = {}
    for kind in ("acc", "entry", "act"):
        a, b = getattr(card, kind), getattr(cpu, kind)
        if [t.shape for t in a] != [t.shape for t in b]:
            raise AssertionError(f"int8 traces differ in shape ({kind}): "
                                 f"{len(a)} against {len(b)} tensors")
        n = sum(t.numel() for t in a)
        diff = sum(int((x != y).sum()) for x, y in zip(a, b))
        step = max([int((x.int() - y.int()).abs().max()) for x, y in
                    zip(a, b) if x.numel()] or [0])
        out[kind] = dict(tensors=len(a), elements=n, differing=diff,
                         max_abs_diff=step)
    return out


def q_census(fn):
    with OpCensus() as census:
        out = fn()
    return out, census.int8_summary()


def check_census(name, got, want):
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{name}: the int8 forward ran {got}, "
                             f"expected {want}")
    return got


def cpu_int8_copy(im, directory, model):
    """``model`` saved to ``directory`` with ``im``'s calibration, loaded
    back on the CPU by ``load_quantized``: the port's CPU int8 run from
    the same scales."""
    model.save_model(directory)
    keras_dir = InferenceModel._resolve_model_dir(directory)
    im.save_calibration(os.path.join(keras_dir,
                                     InferenceModel.CALIBRATION_FILE))
    return InferenceModel().load_quantized(directory, device="cpu")


def int8_bench_leg(seed, rs):
    """bench_quant's two models: the chain plan, the forward's structure
    under an op census (one int32 product a kernel, no float product, a
    rounding a chain edge plus the entry quantize, one division), the
    card's int8 outputs against the CPU's from the same scales, and (report
    only) against float32."""
    out = {}
    for key, (make, shape, n_kernels, chains) in q_bench_models().items():
        m = make(seed)
        calib = [rs.standard_normal((Q_BENCH_CALIB_ROWS,) + shape[1:])
                 .astype(np.float32) for _ in range(Q_BENCH_CALIB_BATCHES)]
        x = rs.standard_normal(shape).astype(np.float32)
        f32 = InferenceModel().load_keras_net(m)
        q = InferenceModel().load_keras_net(m, calibration=calib)
        if q.model.chains != chains:
            raise AssertionError(f"{key}: chains {q.model.chains}, the JAX "
                                 f"plan is {chains}")
        got, census = q_census(lambda: q.predict(x))
        check_census(key, census, dict(
            int32_products=n_kernels, float_products=0,
            roundings=len(chains) + 1, divisions=1))
        cpu = cpu_int8_copy(q, os.path.join(Q_ROOT, key), m)
        want = cpu.predict(x)
        err = float(np.abs(got - want).max())
        if err > Q_FLOAT_TOL * max(float(np.abs(want).max()), 1e-30):
            raise AssertionError(f"{key}: int8 on the card off the CPU's "
                                 f"by {err}")
        ref = f32.predict(x)
        out[key] = dict(batch=shape[0], chains=["->".join(c) for c in
                                                 chains],
                        census=census, cpu_max_abs_err=err,
                        rel_err_vs_f32=float(np.mean(np.abs(got - ref)) /
                                             (np.mean(np.abs(ref)) or 1.0)),
                        param_bytes=q.model.param_bytes())
    return out


def build_image_classifier(seed, name):
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    clf = ImageClassifier(class_num=RESNET_CLASSES, model_name=name)
    clf.model.graph_function()
    config.seed = seed0     # the model drew its weights from seed
    return clf


def image_batches(rs, n, rows):
    return [rs.standard_normal((rows,) + RESNET_SHAPE).astype(np.float32)
            for _ in range(n)]


def agreement(got, ref):
    """int8 rows against float32 rows: mean relative error and top-1
    agreement."""
    return dict(rel_err=float(np.mean(np.abs(got - ref)) /
                              np.mean(np.abs(ref))),
                top1_agreement=float(np.mean(got.argmax(1) ==
                                             ref.argmax(1))))


def int8_vgg_leg(seed, rs):
    """VGG-16 at full width, the fully chained case: 15 chain edges, 16
    int32 products, one division (the entry quantize) and one softmax;
    2 images against the CPU's int8 run from the same scales (every
    int32 accumulator and int8 activation equal, the softmax within
    Q_FLOAT_TOL); save_calibration then load_quantized (the same chains,
    the rows bit for bit). Returns the report and the models for the
    timed runs."""
    t0 = time.perf_counter()
    clf = build_image_classifier(seed, "vgg-16")
    build_s = time.perf_counter() - t0
    calib = image_batches(rs, Q_CALIB_BATCHES, Q_CALIB_ROWS)
    x = rs.standard_normal((Q_PARITY_ROWS,) + RESNET_SHAPE).astype(
        np.float32)
    f32 = InferenceModel().load_keras_net(clf)
    t0 = time.perf_counter()
    q = InferenceModel().load_keras_net(clf, calibration=calib)
    calibrate_s = time.perf_counter() - t0
    chains = q.model.chains
    if len(q.model.kernels) != Q_VGG_KERNELS or \
            len(chains) != Q_VGG_CHAINS:
        raise AssertionError(f"VGG-16: {len(q.model.kernels)} kernels, "
                             f"chains {chains}")
    _, census = q_census(lambda: q.predict(x))
    check_census("VGG-16", census, dict(
        int32_products=Q_VGG_KERNELS, float_products=0,
        roundings=Q_VGG_CHAINS + 1, divisions=1, softmaxes=1))
    with Int8Trace(clf.model) as card:
        got = q.predict(x)
    directory = os.path.join(Q_ROOT, "vgg16")
    cpu = cpu_int8_copy(q, directory, clf)
    t0 = time.perf_counter()
    with Int8Trace(cpu.model.model) as host:
        want = cpu.predict(x)
    cpu_s = time.perf_counter() - t0
    traces = compare_traces(card, host)
    err = float(np.abs(got - want).max())
    if any(t["differing"] for t in traces.values()) or \
            err > Q_FLOAT_TOL * float(np.abs(want).max()):
        raise AssertionError(f"VGG-16 int8 on the card against the CPU: "
                             f"{traces}, softmax off by {err}")
    reloaded = InferenceModel().load_quantized(directory)
    if reloaded.model.chains != chains or \
            not np.array_equal(reloaded.predict(x), got):
        raise AssertionError("VGG-16: load_quantized of the saved "
                             "directory planned other chains or rows")
    xs = rs.standard_normal((Q_AGREEMENT_ROWS,) + RESNET_SHAPE).astype(
        np.float32)
    report = dict(
        model="ImageClassifier(1000, 'vgg-16')", input=list(RESNET_SHAPE),
        build_s=build_s, calibrate_s=calibrate_s,
        calibration=f"{Q_CALIB_BATCHES} batches of {Q_CALIB_ROWS}",
        kernels=len(q.model.kernels), chains=len(chains), census=census,
        cpu_traces=traces, cpu_softmax_max_abs_err=err, cpu_int8_s=cpu_s,
        reloaded_chains_equal=True,
        vs_f32=agreement(np.concatenate([q.predict(xs[i:i + 8])
                                         for i in range(0, len(xs), 8)]),
                         np.concatenate([f32.predict(xs[i:i + 8])
                                         for i in range(0, len(xs), 8)])),
        param_bytes=q.model.param_bytes())
    del cpu, reloaded
    return report, (f32, q, InferenceModel().load_keras_net(clf,
                                                            quantize=True))


def int8_resnet_leg(seed, rs, device):
    """ResNet-50 at full width, the case with no chains (BatchNorm after
    every convolution: 54 kernels, each quantizing its own input): v1
    float32 and v2 int8 (``deploy(quantize=True)`` of the same
    directory, its calibration.json; a canary of Q_CANARY_WEIGHT) behind
    RoutedClusterServing on the in-process stream, 64 records each
    against its version's direct predict, distinct f32 and int8
    dispatch keys; ``recover(load=True)`` reloads v2 as int8 with equal
    rows; the int8 rows against the CPU's int8 run from the same scales
    (Q_RESNET_TOL). Returns the report and the models for the timed
    runs."""
    clf = build_resnet(seed)
    directory = os.path.join(Q_ROOT, "resnet50")
    clf.save_model(directory)
    calib = image_batches(rs, Q_CALIB_BATCHES, Q_CALIB_ROWS)
    f32 = InferenceModel().load_keras_net(clf)
    t0 = time.perf_counter()
    q = InferenceModel().load_keras_net(clf, calibration=calib)
    calibrate_s = time.perf_counter() - t0
    if len(q.model.kernels) != Q_RESNET_KERNELS or q.model.chains:
        raise AssertionError(f"ResNet-50: {len(q.model.kernels)} kernels, "
                             f"chains {q.model.chains}")
    x = rs.standard_normal((Q_REGISTRY_RECORDS,) + RESNET_SHAPE).astype(
        np.float32)
    _, census = q_census(lambda: q.predict(x[:Q_PARITY_ROWS]))
    check_census("ResNet-50", census, dict(
        int32_products=Q_RESNET_KERNELS, float_products=0,
        roundings=Q_RESNET_KERNELS, divisions=Q_RESNET_KERNELS,
        softmaxes=1))
    keras_dir = InferenceModel._resolve_model_dir(directory)
    q.save_calibration(os.path.join(keras_dir,
                                    InferenceModel.CALIBRATION_FILE))

    root = os.path.join(Q_ROOT, "registry")
    registry = ModelRegistry(root=root)
    backend = InProcessStreamQueue()
    serving = RoutedClusterServing(
        registry, helper=ClusterServingHelper(config=Q_CS_CONFIG),
        backend=backend)
    t0 = time.perf_counter()
    mv1 = serving.deploy("resnet50", path=directory)
    mv2 = serving.deploy("resnet50", path=directory, quantize=True,
                         canary_weight=Q_CANARY_WEIGHT)
    deploy_s = time.perf_counter() - t0
    qm = mv2.model.model
    if (mv1.dtype, mv2.dtype) != ("f32", "int8") or not qm.calibrated or \
            qm.chains or qm.device != device:
        raise AssertionError(f"int8 deploy: dtypes {mv1.dtype}, "
                             f"{mv2.dtype}, calibrated {qm.calibrated}, "
                             f"on {qm.device}")
    uris = [f"q-{i}" for i in range(Q_REGISTRY_RECORDS)]
    iq = InputQueue(backend=backend)
    for uri, row in zip(uris, x):
        iq.enqueue(uri, model="resnet50", t=row)
    serving.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120)
    serving.stop()
    stats = serving.pipeline_stats()
    if len(got) != len(uris) or stats["dead_letters"] or stats["dropped"]:
        raise AssertionError(f"int8 registry: {len(got)} results, "
                             f"{stats['dead_letters']} dead letters")
    direct = {1: cs_direct_predict(mv1.model, x),
              2: cs_direct_predict(mv2.model, x)}
    routed = {u: 2 if zlib.crc32(u.encode()) % 10000 / 10000.0 <
              Q_CANARY_WEIGHT else 1 for u in uris}
    rows = {v: [i for i, u in enumerate(uris) if routed[u] == v]
            for v in (1, 2)}
    checks = {f"v{v}": check_served_rows(
        f"int8 registry v{v}", {u: np.asarray(got[u]) for u in uris},
        [uris[i] for i in rows[v]], direct[v][rows[v]], CS_DIRECT_TOL)
        for v in (1, 2)}
    keys = sorted(serving.bucket_counts)
    if not any(k.endswith(":int8") for k in keys) or \
            not any(k.endswith(":f32") for k in keys):
        raise AssertionError(f"dispatch keys {keys}")
    recovered = ModelRegistry(root=root).recover(load=True)
    r2 = recovered._models["resnet50"][2]
    if r2.dtype != "int8" or not r2.model.model.calibrated or \
            not np.array_equal(r2.model.predict(x[:Q_PARITY_ROWS]),
                               direct[2][:Q_PARITY_ROWS]):
        raise AssertionError("recover did not reload v2 as the same int8 "
                             "model")
    del recovered, r2

    xp = x[:Q_PARITY_ROWS]
    with Int8Trace(clf.model) as card:
        card_rows = q.predict(xp)
    cpu = InferenceModel().load_quantized(directory, device="cpu")
    with Int8Trace(cpu.model.model) as host:
        cpu_rows = cpu.predict(xp)
    traces = compare_traces(card, host)
    errs = np.abs(card_rows - cpu_rows).max(1) / cpu_rows.max(1)
    if not np.array_equal(card_rows, direct[2][:Q_PARITY_ROWS]) or \
            (card_rows.argmax(1) != cpu_rows.argmax(1)).any() or \
            (errs > Q_RESNET_TOL).any():
        raise AssertionError(f"ResNet-50 int8 on the card against the "
                             f"CPU: {errs} of the rows' largest, {traces}")
    report = dict(
        model="ImageClassifier(1000, 'resnet-50')", calibrate_s=calibrate_s,
        kernels=len(q.model.kernels), chains=0, census=census,
        deploy_s=deploy_s, records=len(uris), routed_int8=len(rows[2]),
        routed_f32=len(rows[1]), rows=checks, dispatch_keys=keys,
        recovered_dtype="int8",
        cpu_rel_err=[float(e) for e in errs], cpu_tol=Q_RESNET_TOL,
        cpu_traces=traces,
        vs_f32=agreement(direct[2], direct[1]),
        param_bytes=q.model.param_bytes())
    del serving, registry, mv1, mv2, cpu
    return report, (f32, q, InferenceModel().load_keras_net(clf,
                                                            quantize=True))


def int8_op_group(evt):
    """A device kernel's group in the int8 and float forwards, by the
    outermost aten op that launched it: the integer GEMM, im2col and
    padding (the patch copy, its zero fill, SAME pads), pooling (its
    float16 widening is elementwise), cuDNN convolutions and float
    products of the float32 model, batch norm, layout copies, and the
    elementwise rest (the entry quantize, requantize, bias and scale
    epilogues, relu, residual adds, softmax)."""
    top, parent = evt, evt.cpu_parent
    while parent is not None:
        if parent.name.startswith("aten::"):
            top = parent
        parent = parent.cpu_parent
    name = top.name
    if name == "aten::_int_mm":
        return "integer GEMM (cuBLASLt)"
    if name in ("aten::copy_", "aten::zero_", "aten::zeros",
                "aten::pad", "aten::constant_pad_nd", "aten::fill_"):
        return "im2col and padding"
    if "max_pool" in name or "avg_pool" in name:
        return "pooling"
    if "conv" in name:
        return "convolution (cuDNN, float32)"
    if name in ("aten::matmul", "aten::mm", "aten::addmm", "aten::linear"):
        return "matmul (cuBLAS, float32)"
    if "batch_norm" in name:
        return "batch norm"
    if name in ("aten::contiguous", "aten::clone"):
        return "layout copies"
    return "requantize and elementwise"


def profile_forward(fn):
    """Device time by ``int8_op_group`` over one call of ``fn``, from
    ``torch.profiler`` (each kernel attributed to the CPU op that launched
    it), launches, and the device's idle share of the call's wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups, by = {}, "launching op"

    def add(group, ms, n):
        g = groups.setdefault(group, {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += ms
        g["launches"] += n

    for evt in prof.events():
        for k in getattr(evt, "kernels", ()):
            add(int8_op_group(evt), k.duration / 1e3, 1)
    if not groups:      # no kernel tied to its op: group by kernel name
        by = "kernel name"
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                add(conv_kernel_group(evt.key),
                    evt.self_device_time_total / 1e3, evt.count)
    busy_ms = sum(g["device_ms"] for g in groups.values())
    if busy_ms == 0.0:
        return dict(wall_ms=wall_us / 1e3, groups=None, idle_share=None)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_ms,
                grouped_by=by,
                launches=sum(g["launches"] for g in groups.values()),
                idle_share=1.0 - 1e3 * busy_ms / wall_us,
                groups=dict(sorted(groups.items(),
                                   key=lambda kv: -kv[1]["device_ms"])))


def time_int8(models, rs):
    """Float32, calibrated int8 and weight-only int8 (each kernel
    dequantized at every call) forwards of each model at each batch of
    Q_TIMED_BATCHES: records/s over Q_WINDOWS alternating windows of
    Q_WINDOW_BATCHES batches (inputs already on the card), then one
    profiled batch (device time by group, launches, idle share) and the
    peak memory of a batch."""
    runs = {(name, dtype, b): im for name, ims in models.items()
            for dtype, im in zip(("float32", "int8", "int8 weight-only"),
                                 ims)
            for b in Q_TIMED_BATCHES}
    inputs = {b: torch.from_numpy(rs.standard_normal(
        (b,) + RESNET_SHAPE).astype(np.float32)).cuda()
        for b in Q_TIMED_BATCHES}
    for (_, _, b), im in runs.items():        # warm every configuration
        im.predict_async(inputs[b])
    rates = {key: [] for key in runs}
    for _ in range(Q_WINDOWS):
        for key, im in runs.items():
            x = inputs[key[2]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(Q_WINDOW_BATCHES):
                im.predict_async(x)
            torch.cuda.synchronize()
            rates[key].append(Q_WINDOW_BATCHES * key[2] /
                              (time.perf_counter() - t0))
    out = []
    for key, im in runs.items():
        x = inputs[key[2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        im.predict_async(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_forward(lambda: im.predict_async(x))
        out.append(dict(model=key[0], dtype=key[1], batch=key[2],
                        records_per_s=rates[key],
                        records_per_s_median=float(np.median(rates[key])),
                        peak_memory_bytes=peak, profile=prof))
    return out


def int8_phase(seed, device, smi):
    """The int8 phase: bench_quant's models, VGG-16 (chained) and
    ResNet-50 (no chains, served through the registry) at full width, in
    float32 with TF32 off and in calibrated int8, weights from ``seed``;
    then the timed runs. The launch counts are set to 0 as it starts and
    read as it ends. Returns the report and K1-K5's launches."""
    shutil.rmtree(Q_ROOT, ignore_errors=True)
    os.makedirs(Q_ROOT)
    t0 = time.perf_counter()
    _kernels.LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rs = np.random.default_rng(seed + 60)
    bench = int8_bench_leg(seed + 61, rs)
    vgg, vgg_models = int8_vgg_leg(seed + 62, rs)
    resnet_report, resnet_models = int8_resnet_leg(seed + 63, rs, device)
    peak = torch.cuda.max_memory_allocated()
    timing = time_int8({"vgg-16": vgg_models, "resnet-50": resnet_models},
                       rs)
    launches = _kernels.LAUNCHES.snapshot()
    if launches:
        raise AssertionError(f"the int8 phase launched hand-written "
                             f"kernels {launches}")
    shutil.rmtree(Q_ROOT)
    return dict(card=smi, compute="float32 (TF32 off) and int8",
                bench_quant=bench, vgg16=vgg, resnet50=resnet_report,
                timing=timing, peak_memory_bytes=peak,
                k1_k5_launches=launches,
                clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu"),
                wall_s=time.perf_counter() - t0), launches


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

    # 5. train, in float32 and then in bf16
    trained, train_report = train(args.seed)
    train_launches = train_report["launches"]
    emit("train", **train_report)
    emit("train_parity", **check_train_parity(args.seed, dev))
    trained_bf16, bf16_report = train(args.seed, "bfloat16")
    bf16_report["parity"] = check_train_parity(args.seed, dev, "bfloat16")
    bf16_report["timing"] = time_train_dtypes(
        {"float32": trained, "bfloat16": trained_bf16}, args.seed)
    emit("train_bf16", card=smi, **bf16_report)

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

    # 7. generate, after the served and trained models' memory is freed
    # (their graphs hold reference cycles, so collect them first)
    del trained, trained_bf16, im, model
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches, prefill_k1 = generate(args.seed, dev, smi)

    # 8. NeuralCF
    emit("ncf", card=smi, **ncf(args.seed, dev))

    # 9. checkpoint, after the generation and NCF models are freed
    collect()
    ckpt_report, accum_launches = checkpoint(args.seed, dev, smi, CKPT_ROOT)
    emit("checkpoint", **ckpt_report)

    # 10. the sequence models
    collect()
    seq_report, seq_launches = sequence(args.seed, smi)
    emit("sequence", **seq_report)

    # 11. ResNet-50
    collect()
    resnet(args.seed, dev, smi)

    # 12. Cluster Serving
    collect()
    cs_launches = cluster_serving(args.seed, dev, smi)

    # 13. int8 inference
    collect()
    int8_report, int8_launches = int8_phase(args.seed, dev, smi)
    emit("int8", **int8_report)

    f32 = train_kern[torch.float32]
    bf = train_kern[torch.bfloat16]
    bf16_launches = bf16_report["launches"]
    errs = {attn.KERNEL_NAME: fwd_err[torch.float32],
            attn.DQ_KERNEL_NAME: bwd_err[torch.float32]["dq"],
            attn.DKV_KERNEL_NAME: bwd_err[torch.float32]["dkv"],
            dln.FWD_KERNEL_NAME: dln_err[torch.float32]["fwd"],
            dln.BWD_KERNEL_NAME: dln_err[torch.float32]["bwd"]}
    errs_bf16 = {attn.KERNEL_NAME: fwd_err[torch.bfloat16],
                 attn.DQ_KERNEL_NAME: bwd_err[torch.bfloat16]["dq"],
                 attn.DKV_KERNEL_NAME: bwd_err[torch.bfloat16]["dkv"],
                 dln.FWD_KERNEL_NAME: dln_err[torch.bfloat16]["fwd"],
                 dln.BWD_KERNEL_NAME: dln_err[torch.bfloat16]["bwd"]}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        row = f32[name]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=train_launches[name],
                     max_abs_err=errs[name], ms=row["ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"],
                     library_ms=row["library_ms"],
                     launches_bf16=bf16_launches[name],
                     max_abs_err_bf16=errs_bf16[name],
                     ms_bf16=bf[name]["ms"],
                     plain_ms_bf16=bf[name]["plain_ms"],
                     bound_ms_bf16=bf[name]["bound_ms"],
                     bound_by_bf16=bf[name]["bound_by"],
                     library_ms_bf16=bf[name]["library_ms"],
                     launches_grad_accum4=accum_launches[name],
                     launches_sequence=seq_launches.get(name, 0),
                     launches_cluster_serving=cs_launches.get(name, 0),
                     launches_int8=int8_launches.get(name, 0))
        if name == attn.KERNEL_NAME:
            serve_row = kern[torch.float32]
            entry.update(launches_serve=serve_launches[name],
                         ms_serve=serve_row["ms"],
                         bound_ms_serve=serve_row["bound_ms"],
                         library_ms_serve=serve_row["library_ms"],
                         launches_generate=gen_launches,
                         ms_prefill=prefill_k1["ms"],
                         bound_ms_prefill=prefill_k1["bound_ms"],
                         library_ms_prefill=prefill_k1["library_ms"])
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
