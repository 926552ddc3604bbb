"""ZeRO stage 1 of the port (``parallel/zero.py``, the engine's "flat"
mode) on gangs of ranks over gloo, held to JAX's own bounds
(``tests/test_zero.py``):

- loss parity: stage 1 reproduces stage 0's losses to <= 1e-6 over 20
  Adam steps at dp = 2 and dp = 4 (the reduce-scatter / shard update /
  all-gather is the same arithmetic, summed in another order), and the
  JAX package's stage-1 trajectory at dp = 4 to 1e-5 (PyTorch's BLAS
  against XLA's CPU dots, as ``test_torch_training.py`` allows);
- memory: each rank's optimizer-state bytes at dp = 4 are <= 0.30x the
  replicated bytes (ideal 1/dp = 0.25, plus padding);
- the collective contract, from the call counters of one step: a
  reduce-scatter and an all-gather, and no all-reduce of a
  full-gradient-sized operand (stage 0's step breaks it);
- checkpoints hold the canonical (parameter-shaped) optimizer state, so
  a dp = 4 checkpoint restores bit for bit at dp = 2, and stages 0 and 1
  restore each other's bit for bit and go on to the same losses.
"""

import functools

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature.feature_set import MiniBatch as JMiniBatch
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.parallel import zero

PARITY_TOL = 1e-6
JAX_TOL = 1e-5
STEPS = 20
SAVE_AT = 5
TAG = "zt"
GANG_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _jax_trainer(dp, stage):
    jnn.set_nncontext(jnn.ZooContext(
        jnn.ZooConfig(data_parallel=dp, zero_stage=stage),
        devices=jax.devices()[:dp]))
    model = JSequential()
    model.add(JDense(workers.ZERO_HID, activation="relu",
                     input_shape=(workers.ZERO_NIN,), name=f"{TAG}_d0"))
    model.add(JDense(1, activation="sigmoid", name=f"{TAG}_d1"))
    model.compile(optimizer="adam", loss="binary_crossentropy")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    return trainer


@functools.lru_cache(maxsize=None)
def _init_params():
    """The JAX model's initial weights, the start of every run here."""
    params = jax.tree.map(np.asarray, _jax_trainer(1, 0).params)
    jnn.set_nncontext(None)
    return params


@functools.lru_cache(maxsize=None)
def _run(dp, stage, save_dir=None, load_dir=None, steps=STEPS):
    return workers.run_gang(
        workers.zero_worker, dp,
        args=(TAG, _init_params(), steps, save_dir,
              SAVE_AT if save_dir else None, load_dir),
        config=dict(data_parallel=dp, zero_stage=stage),
        timeout=GANG_TIMEOUT_S)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("zero_ckpt")


def _dp4(stage, root):
    return _run(4, stage, save_dir=str(root / f"stage{stage}"))


@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_loss_parity(dp, ckpt_root):
    l0 = (_dp4(0, ckpt_root) if dp == 4 else _run(dp, 0))[0]["losses"]
    got1 = _dp4(1, ckpt_root) if dp == 4 else _run(dp, 1)
    assert got1[0]["mode"] == "flat"
    for r in got1:
        err = max(abs(a - b) for a, b in zip(l0, r["losses"]))
        assert err <= PARITY_TOL, f"dp={dp} loss diverged: {err}"
    assert len(l0) == STEPS


def test_zero1_matches_the_jax_trajectory(ckpt_root):
    trainer = _jax_trainer(4, 1)
    x, y = workers.zero_data()
    fn = trainer.build_train_step()
    want = []
    for i in range(STEPS):
        batch = trainer._put_batch(JMiniBatch([x], y, None))
        trainer.params, trainer.opt_state, trainer.net_state, logs = fn(
            trainer.params, trainer.opt_state, trainer.net_state, batch, i)
        want.append(float(logs["loss"]))
    got = _dp4(1, ckpt_root)[0]["losses"]
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


def test_zero_stage_validation():
    tnn.init_nncontext(tnn.ZooConfig(zero_stage=2), device="cpu")
    model = workers.zero_model("badstage")
    with pytest.raises(ValueError, match="zero_stage"):
        model._ensure_trainer().ensure_initialized()


def test_zero1_at_dp1_is_off():
    tnn.init_nncontext(tnn.ZooConfig(zero_stage=1), device="cpu")
    trainer = workers.zero_model("dp1")._ensure_trainer()
    trainer.ensure_initialized()
    assert trainer.zero_mode() == "off"


def test_zero1_opt_bytes_per_rank(ckpt_root):
    b0 = _dp4(0, ckpt_root)[0]["opt_bytes"]
    for r in _dp4(1, ckpt_root):
        assert r["opt_bytes"] <= 0.30 * b0, (r["opt_bytes"], b0)


def test_zero1_collective_contract(ckpt_root):
    got = _dp4(1, ckpt_root)
    for r in got:
        zero.assert_zero_collectives(r["calls"], r["numel"])
        assert r["calls"]["reduce_scatter"]["calls"] == 1
        assert r["calls"]["all_gather"]["calls"] == 1
    # the replicated step all-reduces the whole gradient
    r0 = _dp4(0, ckpt_root)[0]
    assert r0["calls"]["all_reduce"]["largest"] >= r0["numel"]
    with pytest.raises(AssertionError, match="no reduce_scatter"):
        zero.assert_zero_collectives(r0["calls"], r0["numel"])


def _assert_bit_equal(a, b):
    (opt_a, params_a), (opt_b, params_b) = a, b
    assert len(opt_a) == len(opt_b)
    for u, v in zip(opt_a, opt_b):
        np.testing.assert_array_equal(u, v)
    assert sorted(params_a) == sorted(params_b)
    for name in params_a:
        np.testing.assert_array_equal(params_a[name], params_b[name])


def test_zero1_checkpoint_reshards_dp4_to_dp2(ckpt_root):
    src = _dp4(1, ckpt_root)
    dst = _run(2, 1, load_dir=str(ckpt_root / "stage1"), steps=0)
    for r in dst:
        _assert_bit_equal(r["restored"], src[0]["saved"])


@pytest.mark.parametrize("src_stage,dst_stage", [(0, 1), (1, 0)])
def test_zero_checkpoint_stage_updown(ckpt_root, src_stage, dst_stage):
    src = _dp4(src_stage, ckpt_root)
    dst = _run(4, dst_stage, load_dir=str(ckpt_root / f"stage{src_stage}"),
               steps=5)
    _assert_bit_equal(dst[0]["restored"], src[0]["saved"])
    cont_src = src[0]["losses"][SAVE_AT:SAVE_AT + 5]
    err = max(abs(a - b) for a, b in zip(cont_src, dst[0]["losses"]))
    assert err <= PARITY_TOL, \
        f"post-restore trajectory diverged across stages: {err}"
