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
                    p_drop=0.0, moe_experts=0):
    """The port's small BERT classifier (test_torch_training.py's)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    bert = tl.BERT(vocab=vocab, hidden_size=hidden, n_block=n_block,
                   n_head=n_head, seq_len=seq_len,
                   intermediate_size=2 * hidden, hidden_p_drop=p_drop,
                   attn_p_drop=p_drop, output_all_block=False,
                   moe_experts=moe_experts)
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


# ---------------------------------------------------------------------------
# tensor, pipeline and expert parallelism, FSDP
# ---------------------------------------------------------------------------

def flat_params(tree, prefix=""):
    """{layer: nested dict} as {"layer.path": numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(v.detach().cpu())
    return out


def layout_fit_worker(rank, world, arch, params, x, y, batch, epochs,
                      lr=None, ckpt=None, eval_batch=6):
    """``fit`` of the small BERT classifier from the JAX weights
    ``params`` under the gang's layout (Adam, or SGD at ``lr``): every
    rank's step losses, its parameters' shapes (its blocks), the layout's
    specs, the ZeRO mode, its optimizer-state bytes and moments' shapes,
    ``predict`` of ``x`` and ``evaluate`` at ``eval_batch``; rank 0 also
    the whole trained parameters. With ``ckpt`` the trainer saves a
    checkpoint there at the end."""
    from analytics_zoo_tpu_torch.parallel import zero
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.utils import load_jax_params
    from analytics_zoo_tpu_torch.utils.jax_weights import (
        optimizer_leaf_params, optimizer_leaves, param_order)

    model = bert_classifier(**arch)
    model.compile(optimizer="adam" if lr is None else SGD(lr=lr),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    load_jax_params(model, params)
    model.fit(x, y, batch_size=batch, nb_epoch=epochs)
    trainer = model.trainer
    order = param_order(model)
    moments = {}
    for leaf, path in zip(optimizer_leaves(trainer.opt_state, order),
                          optimizer_leaf_params(trainer.opt_state, order)):
        if path is not None:
            moments.setdefault(path, []).append(tuple(leaf.shape))
    out = {"losses": list(trainer.step_losses),
           "shapes": {n: tuple(p.shape)
                      for n, p in model.named_parameters()},
           # the leaves no axis cuts, which every rank must hold alike
           "whole_leaves": {n: p.detach().numpy().copy()
                            for n, p in model.named_parameters()
                            if n not in trainer.shards},
           "specs": dict(trainer.param_specs),
           "zero_mode": trainer.zero_mode(),
           "opt_bytes": zero.per_rank_bytes(trainer.opt_state),
           "moments": moments,
           "predict": model.predict(x, batch_size=batch),
           "evaluate": model.evaluate(x, y, batch_size=eval_batch)}
    whole = flat_params(model.get_params())
    if rank == 0:
        out["params"] = whole
    if ckpt is not None:
        trainer.save_checkpoint(ckpt)
    return out


def layout_resume_worker(rank, world, arch, ckpt, x, y, batch):
    """Restore the checkpoint in ``ckpt`` under the gang's layout: the
    whole restored parameters and canonical moments (rank 0), then one
    more step's loss."""
    from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch

    model = bert_classifier(**arch)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    trainer.load_checkpoint(ckpt)
    out = {"step": trainer.step,
           "shapes": {n: tuple(p.shape)
                      for n, p in model.named_parameters()}}
    whole = flat_params(model.get_params())
    if rank == 0:
        out["params"] = whole
    batch_t = trainer.put_batch(trainer._rank_block(
        MiniBatch(tuple(a[:batch] for a in x), y[:batch],
                  np.ones(batch, np.float32))))
    out["loss"] = float(trainer.train_step(batch_t))
    return out


def tp_forward_worker(rank, world, seed):
    """``test_transformer_tp_sharding_and_forward``'s layer (2 blocks, 4
    heads, hidden 32, L = 16) under the gang's layout: the pooled output
    of the whole layer before the layout (the reference), the same
    through the trainer's ``predict`` after it, and the qkv kernel's spec
    and this rank's shape of it."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    tokens = tl.Input(shape=(16,))
    layer = tl.TransformerLayer(n_block=2, n_head=4, vocab=100, seq_len=16,
                                hidden_size=32, output_all_block=False,
                                hidden_p_drop=0.0, attn_p_drop=0.0)
    _, pooled = layer(tokens)
    model = Model(tokens, pooled, seed=seed)
    x = np.random.default_rng(3).integers(0, 100, (8, 16)).astype(
        np.float32)
    with torch.no_grad():
        ref = model([torch.as_tensor(x)]).numpy()
    model.compile(optimizer="adam", loss="mse")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    name = f"{layer.name}.block0.qkv_w"
    return {"ref": ref, "pooled": model.predict(x, batch_size=8),
            "spec": trainer.param_specs[name],
            "qkv_shape": tuple(layer.block0.qkv_w.shape)}


def _tanh_stages(S, H, seed):
    """``test_pipeline_moe.py``'s stages: tanh(x @ w + b), per stage."""
    rs = np.random.default_rng(seed)
    return [{"w": (rs.standard_normal((H, H)) / np.sqrt(H)).astype(
        np.float32), "b": (rs.standard_normal(H) * 0.1).astype(np.float32)}
        for _ in range(S)]


def pipeline_stage_worker(rank, world, S, H, B, M, seed, x_seed):
    """``pipeline_forward`` of the tanh stages over the pipe group (this
    rank's stage), the output and the gradients of ``mean(out**2)``:
    this rank's stage's (w, b) and the input's, and the pipeline
    telemetry events this rank recorded. ``M`` a list: {M: that} for
    each."""
    if isinstance(M, (list, tuple)):
        return {m: pipeline_stage_worker(rank, world, S, H, B, m, seed,
                                         x_seed) for m in M}
    import torch

    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    from analytics_zoo_tpu_torch.parallel import pipeline
    from analytics_zoo_tpu_torch.utils import telemetry

    telemetry.reset_for_tests()
    telemetry.set_enabled(True)
    mesh = get_nncontext().mesh
    stage = mesh.index("pipe")
    mine = {k: torch.tensor(v, requires_grad=True)
            for k, v in _tanh_stages(S, H, seed)[stage].items()}
    x = torch.tensor(np.random.default_rng(x_seed).standard_normal(
        (B, H)).astype(np.float32), requires_grad=True)
    out = pipeline.pipeline_forward(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]), mine, x, mesh,
        n_microbatch=M)
    (out ** 2).mean().backward()
    events = [dict(ev.get("args", {}), name=ev["name"])
              for ev in telemetry.flight_events()
              if ev["name"].startswith("pipeline/")]
    telemetry.reset_for_tests()
    return {"out": out.detach().numpy(), "w": mine["w"].grad.numpy(),
            "b": mine["b"].grad.numpy(), "x": x.grad.numpy(),
            "events": events}


def pipeline_block_worker(rank, world, seed):
    """``test_pipeline_transformer_block_stage``: a BERT layer's blocks,
    built stacked under the pipe axis, pipelined one block a stage over
    the pipe group against the blocks run one after another."""
    import torch

    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    from analytics_zoo_tpu_torch.parallel import pipeline
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    H, L, B = 16, 8, 4
    bert = tl.BERT(vocab=50, hidden_size=H, n_block=4, n_head=2, seq_len=L,
                   intermediate_size=2 * H, output_all_block=False,
                   hidden_p_drop=0.0, attn_p_drop=0.0)
    params = bert.build(torch.Generator().manual_seed(seed), [(None, L)] * 4)
    blocks = params["blocks"]
    stage = get_nncontext().mesh.index("pipe")
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (B, L, H)).astype(np.float32))
    zero_bias = torch.zeros(B, 1, 1, L)

    def run(p, h):
        return bert._block(p, h, zero_bias[:h.shape[0]], None, False)

    with torch.no_grad():
        out = pipeline.pipeline_forward(
            run, {k: v[stage] for k, v in blocks.items()}, x,
            get_nncontext().mesh, n_microbatch=2)
        ref = x
        for i in range(4):
            ref = run({k: v[i] for k, v in blocks.items()}, ref)
    return {"out": out.numpy(), "ref": ref.numpy(),
            "stacked": tuple(blocks["qkv_w"].shape)}


def misconfig_worker(rank, world):
    """A Sequential of Dense layers under a pipe (or expert) axis:
    ``fit`` must raise instead of running replicated; the message."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    model = Sequential()
    model.add(tl.Dense(4, input_shape=(8,)))
    model.compile(optimizer="adam", loss="mse")
    x = np.zeros((16, 8), np.float32)
    y = np.zeros((16, 4), np.float32)
    try:
        model.fit(x, y, batch_size=16, nb_epoch=1)
    except ValueError as e:
        return str(e)
    return None


def moe_forward_worker(rank, world, seed):
    """``test_moe_forward_and_expert_sharding``'s SparseMoE (4 experts,
    hidden 16, 32 columns, top 2, capacity factor 2) under the gang's
    layout: its output on whole weights (the reference) and through the
    trainer's ``predict`` after the layout, the w_in spec and this rank's
    shape of it."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    inp = tl.Input(shape=(6, 16))
    layer = tl.SparseMoE(n_experts=4, intermediate_size=32, top_k=2,
                         capacity_factor=2.0)
    model = Model(inp, layer(inp), seed=seed)
    x = np.random.default_rng(5).standard_normal((4, 6, 16)).astype(
        np.float32)
    with torch.no_grad():
        ref = model([torch.as_tensor(x)]).numpy()
    model.compile(optimizer="adam", loss="mse")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    return {"ref": ref, "out": model.predict(x, batch_size=4),
            "spec": trainer.param_specs[f"{layer.name}.w_in"],
            "w_in": tuple(layer.w_in.shape)}
