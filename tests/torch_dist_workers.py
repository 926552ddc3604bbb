"""Gangs of ranks for the port's multi-process CPU tests.

:func:`run_gang` starts ``world`` processes with the ``spawn`` start
method, each joining ``torch.distributed`` (gloo) through the launcher's
environment contract and ``init_nncontext(device="cpu")``, runs a worker
function of this module in each and returns what each rank returned.
Every wait is bounded: a gang that does not answer within its timeout is
killed and the test fails. This module imports no JAX, so the spawned
ranks (which re-import it to find their function) stay JAX-free.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import numpy as np


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(target, rank, world, port, results, args, config, device):
    try:
        os.environ["ZOO_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        os.environ["ZOO_TPU_NUM_PROCESSES"] = str(world)
        os.environ["ZOO_TPU_PROCESS_ID"] = str(rank)
        import torch

        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        from analytics_zoo_tpu_torch.common import nncontext as tnn

        tnn.init_nncontext(tnn.ZooConfig(**(config or {})), device=device)
        results.put((rank, True, target(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_gang(target, world, args=(), config=None, timeout=120.0,
             device="cpu"):
    """``target(rank, world, *args)`` on ``world`` spawned ranks joined
    with ``ZooConfig(**config)`` on ``device`` (gloo: on the CPU, or
    ranks sharing one card); returns the ranks' results in rank order. Raises AssertionError with a rank's traceback when one
    fails, and TimeoutError (after killing the gang) when the gang does
    not answer within ``timeout`` seconds."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(target, r, world, port,
                                              results, args, config,
                                              device),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"gang of {world} answered {sorted(got)} "
                                   f"within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"rank(s) {dead} died: exit codes "
                                         f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives_worker(rank, world, seed):
    """Each collective forward and backward on this rank's seeded input
    (on the context's device), with a seeded cotangent: {name: (output,
    input gradient)} as numpy."""
    import torch

    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    from analytics_zoo_tpu_torch.parallel import collectives as C

    dev = get_nncontext().device
    group = torch.distributed.group.WORLD
    rs = np.random.default_rng(seed + rank)
    x0 = rs.standard_normal((world * 2, 3, world * 2)).astype(np.float32)
    out = {}

    def run(name, fn):
        x = torch.tensor(x0, device=dev, requires_grad=True)
        y = fn(x)
        g = torch.tensor(np.random.default_rng(seed + 100 + rank)
                         .standard_normal(tuple(y.shape)).astype(np.float32),
                         device=dev)
        y.backward(g)
        out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())

    C.CALLS.reset()
    run("all_reduce", lambda x: C.all_reduce(x, group))
    run("all_gather", lambda x: C.all_gather(x, group, dim=1))
    run("reduce_scatter", lambda x: C.reduce_scatter(x, group, dim=2))
    run("all_to_all", lambda x: C.all_to_all(x, group, split_axis=0,
                                             concat_axis=2))
    perm = [(j, (j + 1) % world) for j in range(world)]
    run("ppermute", lambda x: C.ppermute(x, group, perm))
    # a partial permutation: rank 0 sends to rank 1 only
    run("ppermute_partial", lambda x: C.ppermute(x, group, [(0, 1)]))
    out["calls"] = C.CALLS.snapshot()
    out["mesh"] = (get_nncontext().mesh.shape, get_nncontext().backend)
    return out


def mesh_worker(rank, world):
    """This rank's mesh coordinates and the ranks of its groups."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

    mesh = get_nncontext().mesh
    groups = {}
    for axis in ("data", "seq"):
        g = mesh.group(axis)
        groups[axis] = None if g is None else \
            sorted(dist.get_process_group_ranks(g))
    return {"index": {a: mesh.index(a) for a in ("data", "seq")},
            "groups": groups}


# ---------------------------------------------------------------------------
# data-parallel and sequence-parallel fit
# ---------------------------------------------------------------------------

def bert_classifier(vocab, hidden, seq_len, n_block=2, n_head=2,
                    p_drop=0.0):
    """The port's small BERT classifier (test_torch_training.py's)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    bert = tl.BERT(vocab=vocab, hidden_size=hidden, n_block=n_block,
                   n_head=n_head, seq_len=seq_len,
                   intermediate_size=2 * hidden, hidden_p_drop=p_drop,
                   attn_p_drop=p_drop, output_all_block=False)
    ins = [tl.Input(shape=(seq_len,), name="tokens"),
           tl.Input(shape=(seq_len,), name="positions"),
           tl.Input(shape=(seq_len,), name="segments"),
           tl.Input(shape=(1, 1, seq_len), name="mask")]
    _, pooled = bert(ins)
    return Model(ins, tl.Dense(2, activation="softmax")(pooled))


def fit_worker(rank, world, arch, params, x, y, batch, epochs):
    """``fit`` of the small BERT classifier from the JAX weights
    ``params``: every rank's step losses, rank 0's trained parameters."""
    from analytics_zoo_tpu_torch.utils import load_jax_params

    model = bert_classifier(**arch)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    load_jax_params(model, params)
    model.fit(x, y, batch_size=batch, nb_epoch=epochs)
    out = {"losses": list(model.trainer.step_losses)}
    if rank == 0:
        out["params"] = {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()}
        out["predict"] = model.predict(x, batch_size=batch)
    else:
        model.predict(x, batch_size=batch)
    return out


def dropout_worker(rank, world, arch, x):
    """One training forward with dropout of the same rows on every rank,
    with the trainer's generator for step 0."""
    import torch

    model = bert_classifier(**arch)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    xs = [torch.as_tensor(a) for a in x]
    with torch.no_grad():
        out = trainer._forward(xs, trainer.generator(0), True)
    return out.numpy()


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

ZERO_N, ZERO_NIN, ZERO_HID = 64, 32, 48


def zero_data(seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((ZERO_N, ZERO_NIN)).astype(np.float32)
    y = (x[:, :1] * x[:, 1:2] > 0).astype(np.float32)
    return x, y


def zero_model(tag):
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
        Sequential

    model = Sequential()
    model.add(tl.Dense(ZERO_HID, activation="relu",
                       input_shape=(ZERO_NIN,), name=f"{tag}_d0"))
    model.add(tl.Dense(1, activation="sigmoid", name=f"{tag}_d1"))
    model.compile(optimizer="adam", loss="binary_crossentropy")
    return model


def zero_worker(rank, world, tag, params, steps, save_dir=None,
                save_at=None, load_dir=None):
    """``steps`` Adam steps on the same global batch (this rank's block of
    it), from ``params`` or from the checkpoint in ``load_dir``. Returns
    the losses, the first step's collective calls, this rank's optimizer
    state bytes, and after the load or the save at ``save_at``: the
    canonical optimizer leaves and the parameters."""
    from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch
    from analytics_zoo_tpu_torch.parallel import collectives, zero
    from analytics_zoo_tpu_torch.utils import load_jax_params
    from analytics_zoo_tpu_torch.utils.jax_weights import (
        optimizer_leaves, param_order)

    model = zero_model(tag)
    load_jax_params(model, params)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()

    def snapshot():
        leaves = optimizer_leaves(trainer.canonical_opt_state(),
                                  param_order(model))
        return ([np.array(l.detach()) if hasattr(l, "detach")
                 else np.asarray(l) for l in leaves],
                {n: p.detach().numpy().copy()
                 for n, p in model.named_parameters()})

    out = {"mode": trainer.zero_mode()}
    if load_dir is not None:
        trainer.load_checkpoint(load_dir)
        out["restored"] = snapshot()
    x, y = zero_data()
    batch = trainer.put_batch(trainer._rank_block(
        MiniBatch((x,), y, np.ones(ZERO_N, np.float32))))
    losses = []
    for i in range(steps):
        if i == 0:
            collectives.CALLS.reset()
        losses.append(float(trainer.train_step(batch)))
        if i == 0:
            out["calls"] = collectives.CALLS.snapshot()
        if save_at is not None and i + 1 == save_at:
            trainer.save_checkpoint(save_dir)
            out["saved"] = snapshot()
    out["losses"] = losses
    out["opt_bytes"] = zero.per_rank_bytes(trainer.opt_state)
    out["numel"] = sum(p.numel() for p in model.parameters())
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def seq_attention_worker(rank, world, q, k, v, kbias, do, cases):
    """Each case (mode, causal, layout) of the ``*_sharded`` attention on
    global operands (on the context's device): the global output, and
    this rank's share of the gradients of ``sum(out * do)`` (the
    cotangent split over the ranks, so the shares sum to the gradient),
    as numpy; under "launches" the kernels launched."""
    import torch

    from analytics_zoo_tpu_torch import parallel
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    from analytics_zoo_tpu_torch.ops import _kernels

    ctx = get_nncontext()
    mesh, dev = ctx.mesh, ctx.device
    out = {}
    _kernels.LAUNCHES.reset()
    for mode, causal, layout in cases:
        name = f"{mode}_attention{'_blhd' if layout == 'blhd' else ''}" \
            "_sharded"
        fn = getattr(parallel, name)
        ts = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (q, k, v)]
        if layout == "bhld":
            ins = [t.transpose(1, 2) for t in ts]
        else:
            ins = ts
        o = fn(*ins, mesh, causal=causal,
               kbias=torch.tensor(kbias, device=dev))
        if layout == "bhld":
            o = o.transpose(1, 2)
        (o * torch.tensor(do, device=dev) / world).sum().backward()
        out[(mode, causal, layout)] = (o.detach().cpu().numpy(),
                                       *(t.grad.cpu().numpy() for t in ts))
    out["launches"] = _kernels.LAUNCHES.snapshot()
    return out


def causal_lm(cfg):
    """The port's small causal ``TransformerLayer`` with a per-token
    head on its sequence output."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    ins = tl.Input(shape=(cfg["seq_len"],), name="tokens")
    seq, _ = tl.TransformerLayer(name="a_trunk", **cfg)(ins)
    return Model(ins, tl.Dense(1, name="b_head")(seq))


def causal_lm_worker(rank, world, cfg, params, x, y, batch, epochs):
    """``fit`` of :func:`causal_lm` from the JAX weights ``params`` with
    a token-level mse loss: every rank's step losses and ``predict`` of
    ``x``, rank 0's trained parameters."""
    from analytics_zoo_tpu_torch.utils import load_jax_params

    model = causal_lm(cfg)
    model.compile(optimizer="adam", loss="mse")
    load_jax_params(model, params)
    model.fit(x, y, batch_size=batch, nb_epoch=epochs)
    out = {"losses": list(model.trainer.step_losses),
           "predict": model.predict(x, batch_size=batch)}
    if rank == 0:
        out["params"] = {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()}
    return out
