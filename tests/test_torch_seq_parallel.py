"""Sequence parallelism of the port against the JAX package on the CPU.

- Ulysses and ring attention, forward and dq/dk/dv, through the
  ``*_sharded`` forms (global operands, L split over the seq group) at
  sp = 2 and 4, causal and not, with a padding key bias, in the
  (B, L, H, d) and (B, H, L, d) layouts, against JAX's per-shard
  functions under ``shard_map`` on the CPU mesh (``jax.vjp`` for the
  gradients). Float32;
  the ring's online softmax and the flash path sum in other orders than
  JAX's: 2e-5 on outputs and gradients of unit scale.
- The small BERT classifier's ``fit`` at data 2 x seq 2 (four ranks over
  gloo), in Ulysses and in ring mode, against JAX's ``fit`` of the same
  configuration on four CPU devices in ring mode
  (``test_bert_sequence_parallel_through_fit``'s; this JAX's replication
  check refuses its Ulysses branch inside the step): each step's loss to
  1e-5, the final weights to 2e-5 (``test_fit_matches_jax_step_for_step``'s
  tolerances), and the trained model's ``predict`` to 1e-5.
- A small causal ``TransformerLayer`` with a per-token head on its
  sequence output (a token-level mse loss) at seq 2, in both modes,
  against JAX's ring-mode ``fit`` on two CPU devices: the sequence output
  is the global (B, L, h) tensor on every seq rank, so each rank's losses
  and ``predict`` of the whole sequence match JAX's: losses and weights at
  the tolerances above, the unsquashed predictions at 5e-5.
"""

import functools
import pathlib
import tempfile

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from jax.sharding import PartitionSpec as P

from analytics_zoo_tpu import parallel as jpar
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.common.jax_compat import shard_map
from analytics_zoo_tpu_torch.common import nncontext as tnn
from test_torch_data_parallel import (ARCH, LOSS_TOL, WEIGHT_TOL, bert_data,
                                      jax_fit, port_leaves)

ATTN_TOL = 2e-5
PREDICT_TOL = 1e-5
# d = 16, as JAX's own Ulysses tests (tests/test_parallel.py) take it
B, L, H, D = 2, 16, 4, 16
CASES = [(mode, causal, layout) for mode in ("ulysses", "ring")
         for causal in (False, True) for layout in ("blhd", "bhld")]
GANG_TIMEOUT_S = 180.0


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _operands(seed=7):
    rs = np.random.default_rng(seed)
    q, k, v, do = (rs.standard_normal((B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    lengths = np.array([L, L - 5])
    kbias = np.where(np.arange(L)[None, :] < lengths[:, None], 0.0,
                     -10000.0).astype(np.float32)
    return q, k, v, kbias, do


@functools.lru_cache(maxsize=None)
def _port(sp):
    return workers.run_gang(workers.seq_attention_worker, sp,
                            args=(*_operands(), CASES),
                            config=dict(data_parallel=1,
                                        sequence_parallel=sp),
                            timeout=GANG_TIMEOUT_S)


def _jax(sp, mode, causal, layout):
    """JAX's per-shard function (``*_sharded``'s body) under
    ``shard_map`` with ``check_vma=False``: this JAX's replication check
    refuses the blockwise attention's scan carry inside the ``*_sharded``
    wrappers themselves."""
    q, k, v, kbias, do = _operands()
    mesh = jpar.make_mesh(data=1, seq=sp, devices=jax.devices()[:sp])
    per_shard = getattr(jpar, f"{mode}_attention"
                        f"{'_blhd' if layout == 'blhd' else ''}")
    spec = P(None, "seq", None, None) if layout == "blhd" \
        else P(None, None, "seq", None)
    sharded = shard_map(
        lambda q, k, v, kb: per_shard(q, k, v, "seq", causal=causal,
                                      kbias=kb),
        mesh=mesh, in_specs=(spec, spec, spec, P(None, "seq")),
        out_specs=spec, check_vma=False)

    def f(q, k, v):
        if layout == "bhld":
            q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
        o = sharded(q, k, v, kbias)
        return o.transpose(0, 2, 1, 3) if layout == "bhld" else o

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o, *vjp(do))

    return tuple(np.asarray(a) for a in jax.jit(fwd_bwd)(q, k, v, do))


@pytest.mark.parametrize("mode,causal,layout", CASES)
@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_attention_and_its_gradients_match_jax(sp, mode, causal,
                                                       layout):
    got = _port(sp)
    want = _jax(sp, mode, causal, layout)
    key = (mode, causal, layout)
    # every rank holds the whole output
    for r in range(sp):
        np.testing.assert_allclose(got[r][key][0], want[0], rtol=0,
                                   atol=ATTN_TOL, err_msg=f"out, rank {r}")
    for i, name in enumerate(("dq", "dk", "dv"), start=1):
        share = sum(got[r][key][i] for r in range(sp))
        np.testing.assert_allclose(share, want[i], rtol=0, atol=ATTN_TOL,
                                   err_msg=name)


def test_ulysses_needs_heads_divisible_by_the_ranks():
    import torch

    from analytics_zoo_tpu_torch.parallel import ulysses

    class _Group:
        pass

    # a group of three ranks over four heads (no collective is reached)
    orig = ulysses.group_size
    ulysses.group_size = lambda g: 3
    try:
        q = torch.zeros(1, 2, 4, 64)
        with pytest.raises(ValueError, match="heads % devices"):
            ulysses.ulysses_attention_blhd(q, q, q, _Group())
    finally:
        ulysses.group_size = orig


BERT_SP = {"data_parallel": 2, "sequence_parallel": 2,
           "sequence_parallel_mode": "ring"}


@functools.lru_cache(maxsize=None)
def _jax_bert_sp():
    """JAX's ring-mode fit of the BERT classifier at data 2 x seq 2 and
    its trained model's predictions: (x, y, initial weights, step losses,
    trained weights, predictions), once for both modes' tests."""
    x, y = bert_data(2, 16)
    with tempfile.TemporaryDirectory() as d:
        params, jlosses, final = jax_fit(BERT_SP, x, y, 8, 2,
                                         pathlib.Path(d), 4)
    return x, y, params, jlosses, final, _jax_predict(final, BERT_SP, x)


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_bert_sequence_parallel_fit_matches_jax(mode):
    x, y, params, jlosses, final, jmodel_pred = _jax_bert_sp()
    config = BERT_SP
    got = workers.run_gang(workers.fit_worker, 4,
                           args=(ARCH, params, x, y, 8, 2),
                           config=dict(config, sequence_parallel_mode=mode),
                           timeout=GANG_TIMEOUT_S)
    assert len(jlosses) == 4
    for r in got:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0,
                                   atol=LOSS_TOL)
    want = port_leaves(final, got[0]["params"])
    for name, p in got[0]["params"].items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=WEIGHT_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[0]["predict"], jmodel_pred, rtol=0,
                               atol=PREDICT_TOL)


def _jax_predict(final, config, x):
    """The JAX sequence-parallel model's predictions from ``final``."""
    from test_torch_data_parallel import jax_classifier

    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(**config),
                                     devices=jax.devices()[:4]))
    jmodel = jax_classifier()
    jmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    trainer = jmodel._ensure_trainer()
    trainer.ensure_initialized()
    names = list(jax.tree.map(np.asarray, trainer.params))
    trainer.set_params(dict(zip(names, final.values())), trainer.net_state)
    return jmodel.predict(x, batch_size=8)


LM = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
          intermediate_size=64, hidden_p_drop=0.0, attn_p_drop=0.0,
          bidirectional=False, output_all_block=False)
# the regression head's outputs are of unit scale with no softmax to
# squash them: the trained weights' 2e-5 (WEIGHT_TOL) carries through two
# blocks into the predictions at about that size, so 5e-5
LM_PREDICT_TOL = 5e-5


def _jax_lm():
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu.pipeline.api.keras.layers import \
        self_attention as jsa
    from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel

    ins = jl.Input(shape=(LM["seq_len"],), name="tokens")
    seq, _ = jsa.TransformerLayer(name="a_trunk", **LM)(ins)
    return JModel(ins, jl.Dense(1, name="b_head")(seq))


LM_SP = {"data_parallel": 1, "sequence_parallel": 2,
         "sequence_parallel_mode": "ring"}
LM_N, LM_BATCH, LM_EPOCHS = 8, 4, 2


@functools.lru_cache(maxsize=None)
def _jax_lm_sp():
    """JAX's ring-mode fit of :func:`_jax_lm` at seq 2 and its trained
    model's predictions: (x, y, initial weights, step losses, trained
    weights, predictions), once for both modes' tests."""
    rs = np.random.default_rng(5)
    x = rs.integers(0, LM["vocab"], size=(LM_N, LM["seq_len"])).astype(
        np.float32)
    y = rs.standard_normal((LM_N, LM["seq_len"], 1)).astype(np.float32)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1,
                                                   **LM_SP),
                                     devices=jax.devices()[:2]))
    jmodel = _jax_lm()
    jmodel.compile(optimizer="adam", loss="mse")
    with tempfile.TemporaryDirectory() as d:
        # the summary writer writes under d until the model's last call
        jmodel.set_tensorboard(d, "jax")
        params = jax.tree.map(np.asarray, jmodel.get_params())
        jmodel.fit(x, y, batch_size=LM_BATCH, nb_epoch=LM_EPOCHS)
        jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
        final = jax.tree.map(np.asarray, jmodel.get_params())
        jpred = np.asarray(jmodel.predict(x, batch_size=LM_BATCH))
    return x, y, params, jlosses, final, jpred


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_causal_sequence_output_fit_and_predict_match_jax(mode):
    x, y, params, jlosses, final, jpred = _jax_lm_sp()
    n, batch, epochs = LM_N, LM_BATCH, LM_EPOCHS
    config = LM_SP
    got = workers.run_gang(workers.causal_lm_worker, 2,
                           args=(LM, params, x, y, batch, epochs),
                           config=dict(config, sequence_parallel_mode=mode),
                           timeout=GANG_TIMEOUT_S)
    assert len(jlosses) == epochs * n // batch
    assert jpred.shape == (n, LM["seq_len"], 1)
    for r in got:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["predict"], jpred, rtol=0,
                                   atol=LM_PREDICT_TOL)
    want = port_leaves(final, got[0]["params"])
    for name, p in got[0]["params"].items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=WEIGHT_TOL,
                                   err_msg=name)
