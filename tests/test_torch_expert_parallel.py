"""Expert parallelism of the port (``SparseMoE`` over the ``expert``
axis) against the JAX package on the CPU.

- ``test_pipeline_moe.py``'s SparseMoE under 4 expert ranks: the w_in
  spec puts ``expert`` first, each rank holds one of the 4 experts, and
  the output equals the layer's on whole weights (1e-4, JAX's tolerance).
- The small BERT classifier with a 4-expert top-2 MoE in each block
  (``torch_layout_cases``) trains through ``fit`` at ep = 2 and 4
  against JAX's fit under the same axes: losses 1e-5, predict 1e-5, and
  each leaf's move over the four Adam steps to 1e-2 of its norm. The
  MoE's gradients are 1e-4 of their norm from JAX's on one rank already
  (``test_torch_moe.py``: its experts' products and combine sum in other
  orders), and Adam's normalised step carries that into the router's
  small-gradient weights: its move is 2.0e-3 (ep 2), 1.8e-3 (ep 4) and
  5.1e-3 (ep 2 x tp 2) of its norm from JAX's, single weights up to
  1.2e-4 apart, where the dense layouts hold 2e-5; the port's own
  weights at ep = 1 and ep = 2 are the same bit for bit. Each rank holds
  the blocks JAX's specs give (E/ep experts, the router whole); one SGD
  step at learning rate 1 gives JAX's gradient (1e-3 of its norm).
  Beside a model axis (ep = 2 x tp = 2) the experts' ``mlp`` dimension
  is cut too.
- A model with nothing laid out over ``expert`` refuses the axis.
"""

import functools

import numpy as np
import pytest

import torch_dist_workers as workers
import torch_layout_cases as cases
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu_torch.common import nncontext as tnn

MOE_TOL = 1e-4
MOE_MOVE_TOL = 1e-2
ARCH = dict(cases.ARCH, moe_experts=4)


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
def _fit(ep, tp=1, lr=None, epochs=cases.EPOCHS, batch=cases.BATCH):
    config = dict(data_parallel=1, expert_parallel=ep, model_parallel=tp)
    params, losses, final, preds, (x, y), specs = cases.jax_fit(
        _items(config), _items(ARCH), lr, epochs, batch)
    got = workers.run_gang(workers.layout_fit_worker, ep * tp,
                           args=(ARCH, params, x, y, batch, epochs, lr),
                           config=config, timeout=cases.GANG_TIMEOUT_S)
    return got, params, losses, final, preds, specs, config


def test_moe_forward_and_expert_sharding():
    got = workers.run_gang(workers.moe_forward_worker, 4, args=(0,),
                           config=dict(data_parallel=1, expert_parallel=4),
                           timeout=cases.GANG_TIMEOUT_S)
    for r in got:
        assert r["spec"][0] == "expert"
        assert r["w_in"] == (1, 16, 32)
        assert r["out"].shape == (4, 6, 16)
        np.testing.assert_allclose(r["out"], r["ref"], rtol=MOE_TOL,
                                   atol=MOE_TOL)


@pytest.mark.parametrize("ep,tp", [(2, 1), (4, 1), (2, 2)])
def test_bert_moe_expert_parallel_fit_matches_jax(ep, tp):
    got, params, losses, final, preds, specs, config = _fit(ep, tp)
    cases.assert_fit_matches(got, losses, final, preds, weight_tol=None)
    cases.assert_moves_match(got, params, final, MOE_MOVE_TOL)
    cases.assert_blocks(got, specs, config)
    name = "bert_1.block0.moe.w_in"
    # the rules name the model axis whatever its size (one rank: whole)
    assert cases.padded(specs[name], 3) == ("expert", None, "model")
    assert got[0]["shapes"][name] == (4 // ep, 128, 256 // tp)
    assert got[0]["shapes"]["bert_1.block0.moe.router_w"] == (128, 4)


@pytest.mark.parametrize("ep", [2, 4])
def test_bert_moe_gradients_match_jax(ep):
    got, params, _, final, _, _, _ = _fit(ep, lr=1.0, epochs=1,
                                          batch=cases.ROWS)
    cases.assert_gradients_match(got, params, final)


def test_expert_axis_misconfig_raises():
    got = workers.run_gang(workers.misconfig_worker, 2,
                           config=dict(data_parallel=1, expert_parallel=2),
                           timeout=cases.GANG_TIMEOUT_S)
    for msg in got:
        assert msg is not None and "'expert' axis" in msg
