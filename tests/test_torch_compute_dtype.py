"""``compute_dtype`` in the port against the JAX package on the CPU: the
config and its environment variable, the per-model override, bf16
training over float32 master weights, and the cast of float-encoded ids
(fault list C4: a behaviour of the reference that the port keeps).

Tolerances, bfloat16 compute on both sides. The two frameworks round
the same products and sums to bf16 (8 bits of mantissa) at other places;
the gaps below are of the same size as those between the port's bf16 run
and JAX's float32 run of the same steps, so rounding sets them:
- each step's loss within 1e-2 (measured up to 2.5e-3 over 3 steps);
- after 3 Adam steps at lr 1e-3, all parameters together within 1e-2 of
  their norm (measured 2.0e-3), and each weight matrix, table and
  layer-norm gain within 1e-2 of its own norm (measured up to 8.5e-3,
  the pooler's weight). Bias vectors start at zero and are held only
  within the whole: Adam's first steps are about +-lr on every element
  whatever the gradient's size, so an element whose gradient is near
  zero (the key part of ``qkv_b`` has a zero gradient in exact
  arithmetic) takes a step of random sign from the rounding noise, in
  either framework, and such a vector's own norm is a few lr (measured
  gaps up to 0.71 of it, and 2.3e-4 of it in float32);
- ``predict`` within 1e-2.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.utils import load_jax_params

# measured on the CPU (torch 2.13, jax 0.9): see the module docstring
BF16_LOSS_TOL = 1e-2
BF16_WEIGHT_REL_TOL = 1e-2


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_from_env_parses_each_field_by_its_type(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_COMPUTE_DTYPE", "bfloat16")
    monkeypatch.setenv("ZOO_TPU_SEED", "7")
    cfg = tnn.ZooConfig.from_env()
    assert cfg.compute_dtype == "bfloat16" and cfg.seed == 7
    assert tnn.ZooConfig().compute_dtype == "float32"
    monkeypatch.setenv("ZOO_TPU_SEED", "seven")
    with pytest.raises(ValueError, match="bad value for ZOO_TPU_SEED"):
        tnn.ZooConfig.from_env()
    monkeypatch.delenv("ZOO_TPU_SEED")

    @dataclasses.dataclass
    class Config(tnn.ZooConfig):
        flag: bool = False
        rate: float = 0.5

    for text, want in (("on", True), ("YES", True), ("0", False),
                       ("off", False)):
        monkeypatch.setenv("ZOO_TPU_FLAG", text)
        assert Config.from_env().flag is want
    monkeypatch.setenv("ZOO_TPU_RATE", "0.25")
    assert Config.from_env().rate == 0.25
    monkeypatch.setenv("ZOO_TPU_FLAG", "maybe")
    with pytest.raises(ValueError, match="bad value for ZOO_TPU_FLAG"):
        Config.from_env()


# ---------------------------------------------------------------------------
# a small BERT classifier in bf16
# ---------------------------------------------------------------------------

L, HID, HEADS, VOCAB, BATCH = 32, 64, 4, 100, 8


def _classifier(pkg):
    """2 blocks, hidden 64, 4 heads, seq 32, dropout off."""
    layers = jl if pkg == "jax" else tl
    bert_cls = jsa.BERT if pkg == "jax" else tl.BERT
    bert = bert_cls(vocab=VOCAB, hidden_size=HID, n_block=2, n_head=HEADS,
                    seq_len=L, intermediate_size=2 * HID,
                    hidden_p_drop=0.0, attn_p_drop=0.0,
                    output_all_block=False)
    ins = [layers.Input(shape=(L,), name="tokens"),
           layers.Input(shape=(L,), name="positions"),
           layers.Input(shape=(L,), name="segments"),
           layers.Input(shape=(1, 1, L), name="mask")]
    _, pooled = bert(ins)
    probs = layers.Dense(2, activation="softmax")(pooled)
    return (JModel if pkg == "jax" else TModel)(ins, probs)


def _data(seed, n):
    """int32 token, position and segment ids (as bench.py feeds BERT) and
    the float mask; the first token carries the label."""
    rs = np.random.default_rng(seed)
    lengths = rs.integers(8, L + 1, size=n)
    pos = np.arange(L)[None, :]
    labels = rs.integers(0, 2, size=n)
    tokens = rs.integers(3, VOCAB, size=(n, L))
    tokens[:, 0] = 1 + labels
    x = [tokens.astype(np.int32),
         np.repeat(pos.astype(np.int32), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(np.int32),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, labels.astype(np.int32)


def _paired(tmp_path):
    jmodel, tmodel = _classifier("jax"), _classifier("torch")
    load_jax_params(tmodel, _np_tree(jmodel.get_params()))
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jmodel.set_tensorboard(str(tmp_path), "bf16")
    return jmodel, tmodel


def test_bf16_fit_matches_jax_with_float32_master_weights(tmp_path):
    jmodel, tmodel = _paired(tmp_path)
    jmodel.set_compute_dtype("bfloat16")
    tmodel.set_compute_dtype("bfloat16")
    tnn.init_nncontext(device="cpu")
    x, y = _data(0, 3 * BATCH)
    jmodel.fit(x, y, batch_size=BATCH, nb_epoch=1)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tmodel.fit(x, y, batch_size=BATCH, nb_epoch=1)
    trainer = tmodel.trainer
    assert trainer.compute_dtype == torch.bfloat16
    assert len(trainer.step_losses) == len(jlosses) == 3
    np.testing.assert_allclose(trainer.step_losses, jlosses, rtol=0,
                               atol=BF16_LOSS_TOL)
    # the master weights and Adam's moments stay float32, and every
    # parameter got a float32 gradient
    for name, p in tmodel.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    moments = trainer.opt_state[0]
    assert all(t.dtype == torch.float32 for part in ("mu", "nu")
               for t in moments[part].values())
    want = copy.deepcopy(tmodel)
    load_jax_params(want, _np_tree(jmodel.get_params()))
    want = dict(want.named_parameters())
    got_all, want_all = [], []
    for name, p in tmodel.named_parameters():
        w = want[name].detach()
        got_all.append(p.detach().flatten())
        want_all.append(w.flatten())
        if name.endswith("_b") or name.endswith(".bias"):
            continue
        gap = (p.detach() - w).norm() / w.norm()
        assert gap <= BF16_WEIGHT_REL_TOL, (name, gap.item())
    got_all, want_all = torch.cat(got_all), torch.cat(want_all)
    assert (got_all - want_all).norm() <= \
        BF16_WEIGHT_REL_TOL * want_all.norm()
    # predict runs in bf16 too and agrees with JAX's bf16 predict
    got = tmodel.predict(x, batch_size=BATCH)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jmodel.predict(
        x, batch_size=BATCH)), rtol=0, atol=BF16_LOSS_TOL)
    # and it is not the float32 model's output: the casts are on
    f32 = tmodel.set_compute_dtype("float32").predict(x, batch_size=BATCH)
    assert tmodel.trainer.compute_dtype is None
    assert 0 < np.abs(f32 - got).max() < BF16_LOSS_TOL


def test_the_model_dtype_wins_over_the_config():
    tnn.init_nncontext(tnn.ZooConfig(compute_dtype="bfloat16"),
                       device="cpu")
    model = _classifier("torch")
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    assert model._ensure_trainer().compute_dtype == torch.bfloat16
    model.set_compute_dtype("float32")
    assert model.trainer is None
    assert model._ensure_trainer().compute_dtype is None
    model.set_compute_dtype("bf16")
    assert model._ensure_trainer().compute_dtype == torch.bfloat16
    model.set_compute_dtype(None)     # back to the config
    assert model._ensure_trainer().compute_dtype == torch.bfloat16
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    model.set_compute_dtype(None)
    assert model._ensure_trainer().compute_dtype is None


def test_bf16_rounds_float_ids_as_the_reference_does():
    """C4: under bf16 every floating input is cast, ids included, so
    float ids above 256 round: 1001 -> 1000, 257 -> 256, and 6040 -> 6048,
    past a 6041-row table, gives a NaN row. Both packages agree; int32 ids
    pass unchanged."""
    rows = 6041
    models = []
    for layers, model_cls in ((jl, JModel), (tl, TModel)):
        inp = layers.Input(shape=(1,))
        out = layers.Flatten()(layers.Embedding(rows, 3)(inp))
        models.append(model_cls(inp, out))
    jmodel, tmodel = models
    load_jax_params(tmodel, _np_tree(jmodel.get_params()))
    tnn.init_nncontext(device="cpu")
    table = next(tmodel.parameters()).detach()
    ids = np.array([[1001.0], [257.0], [6040.0], [5.0]], np.float32)
    for m in models:
        m.set_compute_dtype("bfloat16")
    got = tmodel.predict(ids)
    want = np.asarray(jmodel.predict(ids))
    np.testing.assert_array_equal(got, want)
    bf = table.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[[0, 1, 3]], bf[[1000, 256, 5]])
    assert np.isnan(got[2]).all()
    # in float32 the same ids select their own rows
    tmodel.set_compute_dtype("float32")
    np.testing.assert_array_equal(tmodel.predict(ids)[:3],
                                  table.numpy()[[1001, 257, 6040]])
    # int32 ids are not cast
    tmodel.set_compute_dtype("bfloat16")
    np.testing.assert_array_equal(tmodel.predict(ids.astype(np.int32))[:3],
                                  bf[[1001, 257, 6040]])


def test_bf16_float_positions_past_256_round_in_bert_as_in_jax():
    """C4 inside BERT: a float position of 299 rounds to 300 in bf16,
    past a 300-row position table, and the row's outputs are NaN on both
    sides (no error and no device assert in the port); positions below
    256 stay exact, and the other row agrees within 1e-2."""
    seq = 300
    models = []
    for pkg in ("jax", "torch"):
        layers = jl if pkg == "jax" else tl
        bert_cls = jsa.BERT if pkg == "jax" else tl.BERT
        ins = [layers.Input(shape=(seq,)), layers.Input(shape=(seq,)),
               layers.Input(shape=(seq,)), layers.Input(shape=(1, 1, seq))]
        _, pooled = bert_cls(vocab=50, hidden_size=64, n_block=1, n_head=1,
                             seq_len=seq, intermediate_size=128,
                             hidden_p_drop=0.0, attn_p_drop=0.0,
                             output_all_block=False)(ins)
        out = layers.Dense(2, activation="softmax")(pooled)
        models.append((JModel if pkg == "jax" else TModel)(ins, out))
    jmodel, tmodel = models
    load_jax_params(tmodel, _np_tree(jmodel.get_params()))
    tnn.init_nncontext(device="cpu")
    rs = np.random.default_rng(3)
    pos = np.arange(seq, dtype=np.float32)
    x = [rs.integers(0, 50, (2, seq)).astype(np.float32),
         np.stack([pos, pos % 256]), np.zeros((2, seq), np.float32),
         np.ones((2, 1, 1, seq), np.float32)]
    for m in models:
        m.set_compute_dtype("bfloat16")
    got = tmodel.predict(x)
    want = np.asarray(jmodel.predict(x))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    assert np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BF16_LOSS_TOL)


def test_bf16_embedding_gradient_sums_duplicate_ids_in_float32():
    """A bf16 table's gradient over 8192 lookups of 2 rows (BERT's segment
    table at batch 16 x 512) lands within 2**-8 of the float64 sum: the
    rows are gathered from float32 values, so the scatter-add of the
    backward sums in float32 and rounds to bf16 once (ROADMAP C6). Summed
    in bf16, one addition at a time, it lands ~10% off."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embeddings \
        import take_rows
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(2, 8, generator=gen).bfloat16().requires_grad_()
    ids = torch.randint(0, 2, (8192,), generator=gen)
    up = torch.randn(8192, 8, generator=gen).bfloat16()
    rows = take_rows(table, ids.float())
    assert torch.equal(rows, table.detach()[ids])
    (rows * up).sum().backward()
    want = torch.zeros(2, 8, dtype=torch.float64).index_add_(
        0, ids, up.double())
    err = ((table.grad.double() - want).norm() / want.norm()).item()
    assert err <= 2 ** -8
