"""FSDP (``param_sharding="fsdp"``) and ZeRO-1's gspmd mode of the port
against the JAX package on the CPU, with sharded ``evaluate`` and
``predict``.

The small BERT classifier (``torch_layout_cases``) trains through
``fit`` on dp = 2 and 4 data ranks under the FSDP rules: each rank holds
1/dp of every parameter JAX's rules lay over ``data`` (the largest
divisible dimension of the embed/in/out-annotated ones), the forward
all-gathers them at use and the backward reduce-scatters their
gradients, so the gradients and the Adam moments stay cut. Each step's
loss, the trained whole weights, ``predict`` (every rank returns every
row, in order) and ``evaluate`` (the metric sums all-reduced over the
data ranks; evaluate's batch of 6 splits into blocks of 3 and, at dp =
4, pads to blocks of 2) are held to ``torch_layout_cases``' tolerances
against JAX's fit under the same config, and one SGD step at learning
rate 1 gives JAX's gradient to 1e-3 of its norm. With ZeRO-1 the trainer
runs JAX's gspmd mode: each moment is the block of JAX's widened spec
(the moments of the leaves FSDP leaves whole cut over ``data`` too).
"""

import functools

import numpy as np
import pytest

import torch_dist_workers as workers
import torch_layout_cases as cases
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu_torch.common import nncontext as tnn


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _items(d):
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def _fit(dp, zero=0, lr=None, epochs=cases.EPOCHS, batch=cases.BATCH):
    config = dict(data_parallel=dp, param_sharding="fsdp", zero_stage=zero)
    params, losses, final, preds, (x, y), specs = cases.jax_fit(
        _items(config), _items(cases.ARCH), lr, epochs, batch)
    got = workers.run_gang(workers.layout_fit_worker, dp,
                           args=(cases.ARCH, params, x, y, batch, epochs,
                                 lr),
                           config=config, timeout=cases.GANG_TIMEOUT_S)
    return got, params, losses, final, preds, specs, config


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_fit_matches_jax_and_each_rank_holds_its_blocks(dp):
    got, _, losses, final, preds, specs, config = _fit(dp)
    cases.assert_fit_matches(got, losses, final, preds)
    cases.assert_blocks(got, specs, config)
    # the hidden dims over data: the qkv kernel's rows, the token table's
    # columns (its vocabulary rows stay on the model axis, of one rank)
    assert cases.padded(specs["bert_1.block0.qkv_w"], 2) == ("data",
                                                             "model")
    assert got[0]["shapes"]["bert_1.block0.qkv_w"] == (128 // dp, 384)
    assert got[0]["shapes"]["bert_1.tok_emb"] == (102, 128 // dp)
    for r in got:
        assert r["zero_mode"] == "off"
        # the Adam moments are the rank's blocks: two float32 a weight
        local = sum(int(np.prod(s)) for s in r["shapes"].values())
        assert r["opt_bytes"] == 2 * 4 * local


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_with_zero_gspmd_matches_jax(dp):
    got, _, losses, final, preds, specs, config = _fit(dp, zero=1)
    cases.assert_fit_matches(got, losses, final, preds)
    mode, want = cases.jax_moment_blocks(config)
    assert mode == "gspmd"
    for r in got:
        assert r["zero_mode"] == "gspmd"
        for name, shapes in want.items():
            assert r["moments"][name] == shapes, (name, r["moments"][name],
                                                  shapes)
    # a layer norm's gain, whole under FSDP, has its moments cut too
    assert got[0]["moments"]["bert_1.block0.ln1_g"] == [(128 // dp,)] * 2
    # the moments of 4 bytes a weight: about 2/dp of the weights' bytes
    whole = sum(p.size for p in got[0]["params"].values())
    assert got[0]["opt_bytes"] <= 2 * 4 * whole / dp * 1.05


def test_fsdp_gradients_match_jax():
    got, params, _, final, _, _, _ = _fit(2, lr=1.0, epochs=1,
                                          batch=cases.ROWS)
    cases.assert_gradients_match(got, params, final)
