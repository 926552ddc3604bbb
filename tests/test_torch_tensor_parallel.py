"""Tensor parallelism of the port (the Megatron layout of
``TransformerLayer``/``BERT``) against the JAX package on the CPU.

The port's gang of model ranks over gloo trains the small BERT classifier
(``torch_layout_cases.ARCH``: 2 blocks, 4 heads, hidden 128, vocabulary
102) from JAX's weights; JAX trains it on as many devices of the CPU mesh
under the same axes, its layout from ``param_sharding="auto"``. Each
step's loss, the trained whole weights and ``predict`` are held to
``torch_layout_cases``' tolerances (1e-5, 2e-5, 1e-5), a gradient (one
SGD step at learning rate 1) to 1e-3 of its norm. Each rank holds the
block JAX's spec gives a device: qkv and MLP-in columns (q, k and v each
cut by heads), proj and MLP-out rows, the token table's rows at tp = 2,
and the whole table at tp = 4, where 102 does not split (JAX's
replication rule). With ZeRO-1 beside the model axis the trainer runs
JAX's gspmd mode, and every moment has the block JAX's widened spec gives
(``test_parallel.py::test_opt_state_inherits_param_shardings``). The
layout's checkpoint is the sharded format, each rank writing its regions
(a qkv block is three of them), read both ways across the packages and
restored under another layout (``test_distributed_2proc.py::
test_two_process_tp_sharded_checkpoint``).
"""

import functools
import os

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
import torch_layout_cases as cases
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.utils import sharded_checkpoint as jsc
from analytics_zoo_tpu_torch.common import nncontext as tnn

FORWARD_TOL = 2e-4   # test_transformer_tp_sharding_and_forward's


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _config(tp, dp=1, **extra):
    return dict(data_parallel=dp, model_parallel=tp, **extra)


def _items(d):
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def _fit(tp, dp=1, lr=None, epochs=cases.EPOCHS, batch=cases.BATCH,
         zero=0):
    config = _config(tp, dp, zero_stage=zero)
    params, losses, final, preds, (x, y), specs = cases.jax_fit(
        _items(config), _items(cases.ARCH), lr, epochs, batch)
    got = workers.run_gang(workers.layout_fit_worker, cases.world_of(config),
                           args=(cases.ARCH, params, x, y, batch, epochs,
                                 lr),
                           config=config, timeout=cases.GANG_TIMEOUT_S)
    return got, params, losses, final, preds, specs, config


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_fit_matches_jax_and_each_rank_holds_its_blocks(tp):
    got, _, losses, final, preds, specs, config = _fit(tp)
    cases.assert_fit_matches(got, losses, final, preds)
    cases.assert_blocks(got, specs, config)
    name = "bert_1.block0.qkv_w"
    assert cases.padded(specs[name], 2) == (None, "model")
    assert got[0]["shapes"][name] == (128, 3 * 128 // tp)
    # the vocabulary trap: 102 rows split over 2 ranks, not over 4
    table = cases.padded(specs["bert_1.tok_emb"], 2)
    assert table == (("model", None) if tp == 2 else (None, None))
    assert got[0]["shapes"]["bert_1.tok_emb"] == (102 // (tp if tp == 2
                                                          else 1), 128)
    assert all(r["zero_mode"] == "off" for r in got)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_gradients_match_jax(tp):
    got, params, _, final, _, _, _ = _fit(tp, lr=1.0, epochs=1,
                                          batch=cases.ROWS)
    cases.assert_gradients_match(got, params, final)


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_transformer_tp_sharding_and_forward(dp, tp):
    got = workers.run_gang(workers.tp_forward_worker, dp * tp, args=(5,),
                           config=_config(tp, dp),
                           timeout=cases.GANG_TIMEOUT_S)
    for r in got:
        assert cases.padded(r["spec"], 2) == (None, "model")
        assert r["qkv_shape"] == (32, 96 // tp)
        assert r["pooled"].shape == (8, 32)
        np.testing.assert_allclose(r["pooled"], r["ref"], rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)


def test_opt_state_inherits_param_shardings_under_zero_gspmd():
    got, *_, config = _fit(2, dp=2, zero=1)
    mode, want = cases.jax_moment_blocks(config)
    assert mode == "gspmd"
    assert want, "no moments found"
    for r in got:
        assert r["zero_mode"] == "gspmd"
        assert set(r["moments"]) == set(want)
        for name, shapes in want.items():
            assert r["moments"][name] == shapes, (name, r["moments"][name],
                                                  shapes)
    # the model-sharded qkv kernel's moments: (h/dp, 3h/tp) a rank
    assert got[0]["moments"]["bert_1.block0.qkv_w"] == [(64, 192)] * 2


def test_tp_sharded_checkpoint_read_both_ways(tmp_path, monkeypatch):
    config = _config(2)
    params, *_ = cases.jax_fit(_items(config), _items(cases.ARCH))
    x, y = cases.bert_data(0, cases.ROWS)
    port_dir = str(tmp_path / "port")
    saved = workers.run_gang(workers.layout_fit_worker, 2,
                             args=(cases.ARCH, params, x, y, cases.BATCH,
                                   1, None, port_dir),
                             config=config, timeout=cases.GANG_TIMEOUT_S)
    whole = saved[0]["params"]
    # the sharded format, no flat file: each rank wrote its regions
    tag = jsc.read_commit(port_dir)
    assert tag is not None and jsc.exists(port_dir, "params", tag)
    assert not os.path.exists(os.path.join(port_dir, "model.npz"))
    # restored under the same layout and under another (one data rank
    # pair, whole leaves)
    for other in (config, dict(data_parallel=2)):
        back = workers.run_gang(
            workers.layout_resume_worker, 2,
            args=(cases.ARCH, port_dir, x, y, cases.BATCH),
            config=other, timeout=cases.GANG_TIMEOUT_S)
        assert back[0]["step"] == 2
        for name, p in whole.items():
            np.testing.assert_array_equal(back[0]["params"][name], p,
                                          err_msg=name)
    # JAX restores the port's checkpoint under its own tp layout
    cases.jax_context(config)
    jmodel = cases.jax_classifier(cases.ARCH)
    jmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    trainer = jmodel._ensure_trainer()
    trainer.ensure_initialized()
    trainer.load_checkpoint(port_dir)
    assert trainer.step == 2
    jwhole = cases.by_port_name(jax.tree.map(np.asarray, trainer.params))
    for name, p in whole.items():
        np.testing.assert_array_equal(jwhole[name], p, err_msg=name)
    # and the port restores JAX's sharded checkpoint of a step more
    monkeypatch.setenv("ZOO_TPU_SHARDED_CHECKPOINT", "1")
    from analytics_zoo_tpu.feature.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu.common.zoo_trigger import MaxIteration
    trainer.train(ArrayFeatureSet(x, y), batch_size=cases.BATCH,
                  end_trigger=MaxIteration(3))
    jax_dir = str(tmp_path / "jax")
    trainer.save_checkpoint(jax_dir)
    jsaved = cases.by_port_name(jax.tree.map(np.asarray, trainer.params))
    monkeypatch.delenv("ZOO_TPU_SHARDED_CHECKPOINT")
    back = workers.run_gang(workers.layout_resume_worker, 2,
                            args=(cases.ARCH, jax_dir, x, y, cases.BATCH),
                            config=config, timeout=cases.GANG_TIMEOUT_S)
    assert back[0]["step"] == 3
    for name, p in jsaved.items():
        np.testing.assert_array_equal(back[0]["params"][name], p,
                                      err_msg=name)
