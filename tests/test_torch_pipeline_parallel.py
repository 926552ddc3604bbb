"""Pipeline parallelism of the port (GPipe over the ``pipe`` axis)
against the JAX package on the CPU.

- ``parallel.pipeline.pipeline_forward`` over S = 4 pipe ranks, each
  holding its stage of ``test_pipeline_moe.py``'s tanh stages: the
  output and the gradients of the stages and of the input against JAX's
  ``pipeline_forward`` and ``jax.grad`` on a (data 1, pipe 4) mesh of the
  CPU devices, 1e-5 (JAX's own test takes 1e-5 and 1e-4); the BERT block
  trunk pipelined one block a stage against the blocks run in turn, 1e-4.
- The bubble property (``test_parallel_props.py``): each rank records
  the ticks it computed, and over the ranks the idle share is
  (S - 1)/(M + S - 1) exactly; one microbatch over S stages is flagged.
- The small BERT classifier (``torch_layout_cases``) built under the
  pipe axis stacks its blocks per stage (each rank holds n_block/S of
  them, 4 blocks) and trains through ``fit`` at pp = 2 and 4 (M = 4)
  against JAX's fit under the same axes (losses 1e-5, weights 2e-5,
  predict 1e-5); the trained stacked weights load into an unpipelined model of
  the port, whose ``predict`` gives the pipelined model's (1e-5).
- The refusals: a model with nothing laid out over ``pipe``, an
  ``n_block`` S does not divide, ``output_all_block``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_workers as workers
import torch_layout_cases as cases
from analytics_zoo_tpu import parallel as jpar
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

STAGE_TOL, BLOCK_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_pipeline(S, H, B, M, seed, x_seed):
    per_stage = [jax.tree.map(jnp.asarray, s)
                 for s in workers._tanh_stages(S, H, seed)]
    stacked = jpar.stack_stage_params(per_stage)
    mesh = jpar.make_mesh(data=1, pipe=S, devices=jax.devices()[:S])
    x = jnp.asarray(np.random.default_rng(x_seed).standard_normal(
        (B, H)).astype(np.float32))

    def loss(params, x):
        out = jpar.pipeline_forward(_stage_fn, params, x, mesh,
                                    n_microbatch=M)
        return (out ** 2).mean(), out

    (_, out), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(stacked, x)
    ref = jpar.sequential_reference(_stage_fn, per_stage, x)
    return np.asarray(out), jax.tree.map(np.asarray, g), np.asarray(gx), \
        np.asarray(ref)


@functools.lru_cache(maxsize=None)
def _port_pipeline(S, H, B, M, seed=2, x_seed=3):
    return workers.run_gang(workers.pipeline_stage_worker, S,
                            args=(S, H, B, M, seed, x_seed),
                            config=dict(data_parallel=1,
                                        pipeline_parallel=S),
                            timeout=cases.GANG_TIMEOUT_S)


@pytest.mark.parametrize("H,B,M", [(16, 8, 4), (8, 8, 2)])
def test_pipeline_forward_and_grads_match_jax(H, B, M):
    S = 4
    got = _port_pipeline(S, H, B, M)
    out, g, gx, ref = _jax_pipeline(S, H, B, M, 2, 3)
    np.testing.assert_allclose(out, ref, rtol=STAGE_TOL, atol=STAGE_TOL)
    for r in got:
        # the last stage's output on every pipe rank
        np.testing.assert_allclose(r["out"], out, rtol=STAGE_TOL,
                                   atol=STAGE_TOL)
        # the input's gradient on every rank
        np.testing.assert_allclose(r["x"], gx, rtol=1e-4, atol=STAGE_TOL)
    for stage, r in enumerate(got):
        np.testing.assert_allclose(r["w"], g["w"][stage], rtol=1e-4,
                                   atol=STAGE_TOL, err_msg=f"w {stage}")
        np.testing.assert_allclose(r["b"], g["b"][stage], rtol=1e-4,
                                   atol=STAGE_TOL, err_msg=f"b {stage}")


def test_pipeline_transformer_block_stage():
    got = workers.run_gang(workers.pipeline_block_worker, 4, args=(0,),
                           config=dict(data_parallel=1,
                                       pipeline_parallel=4),
                           timeout=cases.GANG_TIMEOUT_S)
    for r in got:
        assert r["stacked"] == (4, 16, 48)
        np.testing.assert_allclose(r["out"], r["ref"], rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)


BUBBLE_MS = (1, 2, 4, 8)


@pytest.mark.parametrize("M", BUBBLE_MS)
def test_pipeline_bubble_fraction_matches_analytic(M):
    """The idle share measured from each rank's recorded occupancy (the
    ticks it computed) is GPipe's (S - 1)/(M + S - 1); a one-microbatch
    schedule is flagged. (One gang runs every M.)"""
    S = 4
    got = [r[M] for r in _port_pipeline(S, 8, 16, BUBBLE_MS)]
    occ = [ev for r in got for ev in r["events"]
           if ev["name"] == "pipeline/stage_occupancy"]
    assert sorted(ev["rank"] for ev in occ) == list(range(S))
    busy = sum(ev["busy_ticks"] for ev in occ)
    total = sum(ev["total_ticks"] for ev in occ)
    analytic = (S - 1) / (M + S - 1)
    assert 1.0 - busy / total == pytest.approx(analytic, abs=1e-9)
    for r in got:
        sched = [ev for ev in r["events"]
                 if ev["name"] == "pipeline/schedule"]
        assert len(sched) == 1 and sched[0]["ticks"] == M + S - 1
        assert sched[0]["bubble_fraction"] == pytest.approx(analytic)
        degen = [ev for ev in r["events"]
                 if ev["name"] == "pipeline/degenerate_schedule"]
        assert len(degen) == (1 if M == 1 else 0)


def _items(d):
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def _fit(pp):
    arch = dict(cases.ARCH, n_block=4)
    config = dict(data_parallel=1, pipeline_parallel=pp,
                  pipeline_microbatches=4)
    params, losses, final, preds, (x, y), specs = cases.jax_fit(
        _items(config), _items(arch))
    got = workers.run_gang(workers.layout_fit_worker, pp,
                           args=(arch, params, x, y, cases.BATCH,
                                 cases.EPOCHS, None, None,
                                 cases.eval_batch(config)),
                           config=config, timeout=cases.GANG_TIMEOUT_S)
    return got, losses, final, preds, specs, config, arch, x


@pytest.mark.parametrize("pp", [2, 4])
def test_bert_pipeline_parallel_fit_matches_jax(pp):
    got, losses, final, preds, specs, config, arch, _ = _fit(pp)
    cases.assert_fit_matches(got, losses, final, preds)
    cases.assert_blocks(got, specs, config)
    name = "bert_1.blocks.qkv_w"
    assert cases.padded(specs[name], 3)[0] == "pipe"
    # each pipe rank holds its n_block / S stacked blocks
    assert got[0]["shapes"][name] == (arch["n_block"] // pp, 128, 384)


@pytest.mark.parametrize("pp", [2, 4])
def test_bert_pipeline_forward_matches_unpipelined(pp):
    """The trained stacked weights in an unpipelined port model (the
    per-block layout, restacked by ``load_jax_params``) predict what the
    pipelined model predicted."""
    from analytics_zoo_tpu_torch.utils import load_jax_params

    got, *_, arch, x = _fit(pp)
    tnn.init_nncontext(device="cpu")
    model = workers.bert_classifier(**arch)
    tree = {}
    for name, leaf in got[0]["params"].items():
        node = tree
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    load_jax_params(model, tree)
    assert any(n.endswith(".block0.qkv_w")
               for n, _ in model.named_parameters())
    np.testing.assert_allclose(model.predict(x, batch_size=cases.BATCH),
                               got[0]["predict"], rtol=0,
                               atol=cases.PREDICT_TOL)


def test_pipeline_with_dropout_trains_alike_on_every_pipe_rank():
    """Dropout 0.1 in the pipelined trunk (the port's own generator rule):
    finite losses, the same on both pipe ranks."""
    arch = dict(cases.ARCH, p_drop=0.1)
    x, y = cases.bert_data(1, cases.ROWS)
    tnn.init_nncontext(device="cpu")
    model = workers.bert_classifier(**{k: v for k, v in arch.items()
                                       if k != "p_drop"})
    params = {l.name: l.param_tree() for l in
              model.graph_function().layers if l.param_tree()}
    params = {k: {kk: _np(vv) for kk, vv in v.items()}
              for k, v in params.items()}
    tnn.set_nncontext(None)
    got = workers.run_gang(workers.layout_fit_worker, 2,
                           args=(arch, params, x, y, cases.BATCH, 1),
                           config=dict(data_parallel=1,
                                       pipeline_parallel=2),
                           timeout=cases.GANG_TIMEOUT_S)
    assert np.isfinite(got[0]["losses"]).all()
    assert got[0]["losses"] == got[1]["losses"]


def _np(v):
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return v.detach().numpy()


def test_pipeline_misconfig_errors_instead_of_silent_dp():
    got = workers.run_gang(workers.misconfig_worker, 2,
                           config=dict(data_parallel=1,
                                       pipeline_parallel=2),
                           timeout=cases.GANG_TIMEOUT_S)
    for msg in got:
        assert msg is not None and "'pipe' axis" in msg


@pytest.mark.parametrize("kw,match", [
    (dict(n_block=3), "must divide n_block=3"),
    (dict(n_block=2, output_all_block=True), "output_all_block=True")])
def test_stacked_layout_refusals_match_jax(kw, match):
    """JAX's n_block divisibility and output_all_block refusals, with its
    messages."""
    import torch

    jnn.set_nncontext(jnn.ZooContext(
        jnn.ZooConfig(data_parallel=1, pipeline_parallel=2),
        devices=jax.devices()[:2]))
    args = dict(vocab=20, hidden_size=8, n_head=2, seq_len=4, **kw)
    with pytest.raises(ValueError) as want:
        jsa.TransformerLayer(**args).build(jax.random.PRNGKey(0), (None, 4))
    ctx = tnn.init_nncontext(device="cpu")
    ctx.config.pipeline_parallel = 2
    with pytest.raises(ValueError, match=match) as got:
        tl.TransformerLayer(**args).build(torch.Generator(), (None, 4))
    assert str(got.value) == str(want.value)
