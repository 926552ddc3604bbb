"""Data-parallel ``fit`` of the port against the JAX package on the CPU.

A small BERT classifier (2 blocks, hidden 128, 2 heads, L = 32, dropout
0) trains from the same weights in both packages: the JAX model on the
first dp devices of the 8-device CPU mesh
(``ZooContext(ZooConfig(data_parallel=dp), devices=jax.devices()[:dp])``),
the port in a gang of dp ranks over gloo, each rank taking its block of
the global batch. Each step's loss is held to 1e-5 and the final weights
to 2e-5, ``test_fit_matches_jax_step_for_step``'s tolerances (two blocks
of float32 matmuls summed in another order; the gradient sum over ranks
adds one more order). A batch that does not divide by dp is padded with
zero-weight rows in both packages. With dropout on, each rank draws its
own masks.
"""

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch
from analytics_zoo_tpu_torch.parallel import RankMesh

VOCAB, HID, L = 100, 128, 32
ARCH = dict(vocab=VOCAB, hidden=HID, seq_len=L)
LOSS_TOL, WEIGHT_TOL = 1e-5, 2e-5
GANG_TIMEOUT_S = 180.0


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def jax_classifier(p_drop=0.0):
    bert = jsa.BERT(vocab=VOCAB, hidden_size=HID, n_block=2, n_head=2,
                    seq_len=L, intermediate_size=2 * HID,
                    hidden_p_drop=p_drop, attn_p_drop=p_drop,
                    output_all_block=False)
    ins = [jl.Input(shape=(L,), name="tokens"),
           jl.Input(shape=(L,), name="positions"),
           jl.Input(shape=(L,), name="segments"),
           jl.Input(shape=(1, 1, L), name="mask")]
    _, pooled = bert(ins)
    return JModel(ins, jl.Dense(2, activation="softmax")(pooled))


def bert_data(seed, n):
    rs = np.random.default_rng(seed)
    lengths = rs.integers(8, L + 1, size=n)
    pos = np.arange(L)[None, :]
    labels = rs.integers(0, 2, size=n)
    tokens = rs.integers(3, VOCAB, size=(n, L))
    tokens[:, 0] = 1 + labels
    x = [tokens.astype(np.float32),
         np.repeat(pos.astype(np.float32), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(np.float32),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, labels.astype(np.float32)


def jax_fit(config, x, y, batch, epochs, tmp_path, n_devices):
    """The JAX model's initial weights (numpy) and per-step losses."""
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1,
                                                   **config),
                                     devices=jax.devices()[:n_devices]))
    jmodel = jax_classifier()
    jmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jmodel.set_tensorboard(str(tmp_path), "jax")
    params = jax.tree.map(np.asarray, jmodel.get_params())
    jmodel.fit(x, y, batch_size=batch, nb_epoch=epochs)
    losses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    final = jax.tree.map(np.asarray, jmodel.get_params())
    return params, losses, final


def port_leaves(final, port_params):
    """JAX's trained weights keyed by the port's parameter names (the
    BERT layer, then the Dense, in creation order on both sides)."""
    jnames = list(final)
    tnames = sorted({k.split(".", 1)[0] for k in port_params},
                    key=lambda n: [k.split(".", 1)[0]
                                   for k in port_params].index(n))
    out = {}
    for tname, jname in zip(tnames, jnames):
        flat = jax.tree_util.tree_flatten_with_path(final[jname])[0]
        for path, leaf in flat:
            key = ".".join(str(getattr(p, "key", p)) for p in path)
            out[f"{tname}.{key}"] = leaf
    return out


@pytest.mark.parametrize("dp,batch", [(2, 8), (4, 8), (4, 6)])
def test_data_parallel_fit_matches_jax_step_for_step(tmp_path, dp, batch):
    x, y = bert_data(0, 16)
    epochs = 2
    params, jlosses, final = jax_fit({"data_parallel": dp}, x, y, batch,
                                     epochs, tmp_path, dp)
    got = workers.run_gang(workers.fit_worker, dp,
                           args=(ARCH, params, x, y, batch, epochs),
                           config=dict(data_parallel=dp),
                           timeout=GANG_TIMEOUT_S)
    steps = epochs * (16 // batch)
    assert len(jlosses) == steps
    for r in got:
        assert len(r["losses"]) == steps
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0,
                                   atol=LOSS_TOL)
    # every rank holds the same weights: rank 0's against JAX's
    want = port_leaves(final, got[0]["params"])
    for name, p in got[0]["params"].items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=WEIGHT_TOL,
                                   err_msg=name)
    assert np.isfinite(got[0]["predict"]).all()
    assert got[0]["predict"].shape == (16, 2)


def test_dropout_masks_differ_across_ranks():
    x, _ = bert_data(1, 4)
    got = workers.run_gang(workers.dropout_worker, 2,
                           args=(dict(ARCH, p_drop=0.3), x),
                           config=dict(data_parallel=2),
                           timeout=GANG_TIMEOUT_S)
    # the same weights (seeded build) and rows: only the masks differ
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    assert np.abs(got[0] - got[1]).max() > 1e-3


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_a_rank_takes_its_block_of_the_padded_global_batch(rank):
    """``P("data")`` slicing after ``_pad_to_dp_multiple``: 7 rows over
    dp = 3 pad to 9 with zero-weight copies of the last row; seq ranks of
    one data group take the same block."""
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer

    trainer = SPMDTrainer.__new__(SPMDTrainer)
    trainer.mesh = RankMesh((3, 1, 2, 1, 1), 2 * rank + 1)
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    y = np.arange(7, dtype=np.float32)
    xs, ys, w = trainer._rank_block(MiniBatch((x,), y,
                                              np.ones(7, np.float32)))
    full_x = np.concatenate([x, x[-1:], x[-1:]])
    full_w = np.array([1] * 7 + [0, 0], np.float32)
    np.testing.assert_array_equal(xs[0], full_x[3 * rank:3 * rank + 3])
    np.testing.assert_array_equal(w, full_w[3 * rank:3 * rank + 3])
    np.testing.assert_array_equal(ys, np.concatenate(
        [y, y[-1:], y[-1:]])[3 * rank:3 * rank + 3])
