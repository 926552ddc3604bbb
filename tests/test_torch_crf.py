"""The port's CRF ops, ``CRF`` layer and ``CRFLoss`` against the JAX
package on the CPU.

The forward algorithm, the path score and the log-likelihood agree with
JAX's within 1e-5 relative (float32 log-sum-exps in other orders), their
gradients within 1e-4 of each gradient's norm, and Viterbi's tags equal
JAX's exactly, ties included (the first index wins in both). A small
BiLSTM-CRF tagger trains through ``fit`` step for step against JAX's
``fit`` (losses within 1e-5), then decodes as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.ops import crf as jcrf
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import objectives as jo
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.ops import crf as tcrf
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as to
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _case(seed, b=4, l=7, e=5, masked=True):
    rs = np.random.default_rng(seed)
    unary = rs.standard_normal((b, l, e)).astype(np.float32)
    trans = rs.standard_normal((e, e)).astype(np.float32)
    tags = rs.integers(0, e, (b, l)).astype(np.int32)
    mask = None
    if masked:
        lengths = np.concatenate([[l], rs.integers(1, l + 1, b - 1)])
        mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return unary, trans, tags, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_ops_match_jax(seed, masked):
    unary, trans, tags, mask = _case(seed, masked=masked)
    for fn in ("crf_sequence_score", "crf_log_likelihood"):
        want = getattr(jcrf, fn)(_j(unary), _j(tags), _j(trans), _j(mask))
        got = getattr(tcrf, fn)(_t(unary), _t(tags), _t(trans), _t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=fn)
    want = jcrf.crf_log_normalizer(_j(unary), _j(trans), _j(mask))
    got = tcrf.crf_log_normalizer(_t(unary), _t(trans), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    jtags, jscore = jcrf.crf_decode(_j(unary), _j(trans), _j(mask))
    ttags, tscore = tcrf.crf_decode(_t(unary), _t(trans), _t(mask))
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert ttags.dtype == torch.int32
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore),
                               rtol=1e-5)


def test_crf_log_likelihood_gradients_match_jax():
    unary, trans, tags, mask = _case(5)

    def jloss(u, t):
        return -jcrf.crf_log_likelihood(u, _j(tags), t, _j(mask)).mean()

    gu, gt = jax.grad(jloss, argnums=(0, 1))(_j(unary), _j(trans))
    tu, tt = _t(unary).requires_grad_(), _t(trans).requires_grad_()
    (-tcrf.crf_log_likelihood(tu, _t(tags), tt, _t(mask)).mean()).backward()
    for got, want in ((tu.grad, gu), (tt.grad, gt)):
        err = np.linalg.norm(got.numpy() - np.asarray(want))
        assert err <= 1e-4 * np.linalg.norm(np.asarray(want))


def test_viterbi_ties_take_the_first_index_as_jax_does():
    b, l, e = 3, 5, 4
    unary = np.zeros((b, l, e), np.float32)
    unary[1, 2, 1:3] = 1.0                    # a tie between tags 1 and 2
    trans = np.zeros((e, e), np.float32)
    mask = np.ones((b, l), np.float32)
    mask[2, 3:] = 0
    jtags, _ = jcrf.crf_decode(_j(unary), _j(trans), _j(mask))
    ttags, _ = tcrf.crf_decode(_t(unary), _t(trans), _t(mask))
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert ttags.numpy()[1, 2] == 1 and (ttags.numpy()[0] == 0).all()
    single = tcrf.crf_decode(_t(unary[:, :1]), _t(trans))[0]
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(jcrf.crf_decode(_j(unary[:, :1]),
                                                   _j(trans))[0]))


def test_crf_loss_matches_jax_with_integer_and_one_hot_tags():
    unary, trans, tags, _ = _case(7, masked=False)
    b, e = unary.shape[0], unary.shape[-1]
    jtrans = np.broadcast_to(trans, (b, e, e))
    for y in (tags, np.eye(e, dtype=np.float32)[tags]):
        want = jo.CRFLoss()([_j(unary), _j(jtrans)], _j(y))
        got = to.CRFLoss()([_t(unary), _t(jtrans.copy())], _t(y))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="CRF layer"):
        to.CRFLoss()(_t(unary), _t(tags))


# -- a BiLSTM-CRF tagger through fit --------------------------------------

SEQ, VOCAB, EMB, HID, TAGS = 6, 30, 8, 6, 4


def _tagger(pkg):
    m = jl if pkg == "jax" else tl
    words = m.Input(shape=(SEQ,), name="words")
    x = m.Embedding(VOCAB, EMB)(words)
    x = m.Bidirectional(m.LSTM(HID, return_sequences=True))(x)
    x = m.TimeDistributed(m.Dense(TAGS))(x)
    out = m.CRF(TAGS)(x)
    return (JModel if pkg == "jax" else TModel)(words, list(out))


def _tag_data(seed, n):
    rs = np.random.default_rng(seed)
    words = rs.integers(0, VOCAB, (n, SEQ)).astype(np.float32)
    tags = (words.astype(np.int64) % TAGS).astype(np.float32)
    return words, tags


def test_bilstm_crf_fits_step_for_step_and_decodes_like_jax(tmp_path):
    jmodel, tmodel = _tagger("jax"), _tagger("torch")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    for model in (jmodel, tmodel):
        model.compile(optimizer="adam", loss="crf")
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path), "jax")
    x, y = _tag_data(0, 16)
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tnn.init_nncontext(device="cpu")
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    assert len(tmodel.trainer.step_losses) == len(jlosses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=0, atol=1e-5)
    assert tmodel.trainer.step_losses[-1] < tmodel.trainer.step_losses[0]
    junary, jtrans = jmodel.predict(x, batch_size=8)
    tunary, ttrans = tmodel.predict(x, batch_size=8)
    np.testing.assert_allclose(tunary, np.asarray(junary), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ttrans, np.asarray(jtrans), rtol=0,
                               atol=1e-5)
    want = jl.CRF.decode(np.asarray(junary), np.asarray(jtrans))
    got = tl.CRF.decode(tunary, ttrans)
    np.testing.assert_array_equal(got, want)
