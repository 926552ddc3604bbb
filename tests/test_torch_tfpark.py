"""The port's ``tfpark`` (``TFDataset``, ``GANEstimator``) against the JAX
package on the CPU.

Every ``TFDataset`` factory gives the JAX factory's batches bit for bit
(ndarrays, Samples, feature sets, an ImageSet, a TextSet, strings, bytes
and a TFRecord file written here). ``GANEstimator``'s discriminator and
generator steps, fed the same real batches and noise from copied
weights, agree with JAX's ``d_step``/``g_step`` over 5 alternations:
losses and every parameter within 1e-5 (float32; one small MLP's matmuls
summed in another order, under Adam). The 1-D Gaussian case of
tests/test_tfpark.py runs as the JAX package's test runs it.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.feature import image as jimg
from analytics_zoo_tpu.feature.common import \
    ChainedPreprocessing as JChained
from analytics_zoo_tpu.feature.text import TextFeature as JTextFeature
from analytics_zoo_tpu.feature.text import TextSet as JTextSet
from analytics_zoo_tpu.feature.tfrecord import write_tfrecord as jwrite
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.tfpark import GANEstimator as JGAN
from analytics_zoo_tpu.tfpark import TFDataset as JTFDataset
from analytics_zoo_tpu.tfpark import tf_dataset as jtfd
from analytics_zoo_tpu_torch import tfpark as ttfpark
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature import feature_set as tfs
from analytics_zoo_tpu_torch.feature import image as timg
from analytics_zoo_tpu_torch.feature.common import \
    ChainedPreprocessing as TChained
from analytics_zoo_tpu_torch.feature.text import TextFeature as TTextFeature
from analytics_zoo_tpu_torch.feature.text import TextSet as TTextSet
from analytics_zoo_tpu_torch.feature.tfrecord import write_tfrecord
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.tfpark import GANEstimator, TFDataset
from analytics_zoo_tpu_torch.tfpark import tf_dataset as ttfd
from analytics_zoo_tpu_torch.utils import load_jax_params
from torch_parity import paired_leaves

GAN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _leaves(batch):
    return [np.asarray(a) for a in ttfd.batch_arrays(batch)]


def _same_batches(got: TFDataset, want, batch_size=4, **kw):
    assert len(got) == len(want)
    assert got.batch_size == want.batch_size
    gb = list(got.feature_set.batches(batch_size, **kw))
    wb = list(want.feature_set.batches(batch_size, **kw))
    assert len(gb) == len(wb) > 0
    for g, w in zip(gb, wb):
        gl, wl = _leaves(g), [np.asarray(a) for a in jtfd.batch_arrays(w)]
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype.hasobject:
                assert list(a) == list(b)
            else:
                assert a.tobytes() == b.tobytes()


def test_from_ndarrays_and_feature_sets_equal_jax():
    rs = np.random.default_rng(0)
    x = rs.standard_normal((12, 3)).astype(np.float32)
    x2 = rs.integers(0, 9, (12, 2)).astype(np.int32)
    y = rs.integers(0, 2, 12).astype(np.int32)
    for tensors in ((x, y), ([x, x2], y), x, [x, x2]):
        _same_batches(TFDataset.from_ndarrays(tensors, batch_size=4),
                      JTFDataset.from_ndarrays(tensors, batch_size=4),
                      shuffle=True, seed=3)
    got = TFDataset.from_ndarrays((x, y), batch_size=6,
                                  val_tensors=(x[:4], y[:4]))
    want = JTFDataset.from_ndarrays((x, y), batch_size=6,
                                    val_tensors=(x[:4], y[:4]))
    assert got.validation_set.size() == want.validation_set.size() == 4
    _same_batches(got, want, batch_size=6)
    _same_batches(TFDataset.from_feature_set(tfs.FeatureSet.array(x, y),
                                             batch_size=3),
                  JTFDataset.from_feature_set(jfs.FeatureSet.array(x, y),
                                              batch_size=3))
    assert TFDataset.from_dataset(tfs.FeatureSet.array(x)).batch_size == 32


def test_from_rdd_of_samples_equals_jax():
    rs = np.random.default_rng(1)
    rows = [(rs.standard_normal(4).astype(np.float32), np.int32(i % 3))
            for i in range(10)]
    got = TFDataset.from_rdd([tfs.Sample(f, l) for f, l in rows],
                             batch_size=5,
                             val_rdd=[tfs.Sample(f, l) for f, l in rows[:5]])
    want = JTFDataset.from_rdd([jfs.Sample(f, l) for f, l in rows],
                               batch_size=5,
                               val_rdd=[jfs.Sample(f, l) for f, l in
                                        rows[:5]])
    _same_batches(got, want, batch_size=5)
    assert got.validation_set.size() == 5


def test_from_image_set_equals_jax():
    arr = [np.full((5, 6, 3), i, np.float32) for i in range(4)]
    sets = {}
    for m, chain in ((timg, TChained), (jimg, JChained)):
        tr = chain([m.ImageMatToTensor(), m.ImageSetToSample()])
        sets[m] = m.ImageSet.array(arr, [1, 2, 3, 4]), tr
    got = TFDataset.from_image_set(sets[timg][0], sets[timg][1],
                                   batch_size=2)
    want = JTFDataset.from_image_set(sets[jimg][0], sets[jimg][1],
                                     batch_size=2)
    _same_batches(got, want, batch_size=2)
    with pytest.raises(ValueError, match="Sample"):
        TFDataset.from_image_set(timg.ImageSet.array(arr))


def test_from_text_set_equals_jax():
    texts = ["the cat sat on the mat", "a dog ran", "the dog sat",
             "cats and dogs"]
    sets = []
    for feat, tset in ((TTextFeature, TTextSet), (JTextFeature, JTextSet)):
        ts = tset.array([feat(t, label=i % 2) for i, t in enumerate(texts)])
        sets.append(ts.tokenize().normalize().word2idx()
                    .shape_sequence(5).generate_sample())
    _same_batches(TFDataset.from_text_set(sets[0], batch_size=2),
                  JTFDataset.from_text_set(sets[1], batch_size=2),
                  batch_size=2)
    bare = TTextSet.array([TTextFeature("no sample here")])
    with pytest.raises(ValueError, match="generate_sample"):
        TFDataset.from_text_set(bare)


def test_from_string_and_bytes_rdd_equal_jax():
    strings = [f"record {i}" for i in range(6)]
    _same_batches(TFDataset.from_string_rdd(strings, batch_size=3),
                  JTFDataset.from_string_rdd(strings, batch_size=3),
                  batch_size=3)
    blobs = [s.encode() for s in strings]
    _same_batches(TFDataset.from_bytes_rdd(blobs, batch_size=3),
                  JTFDataset.from_bytes_rdd(blobs, batch_size=3),
                  batch_size=3)


def _parse(rec):
    return (np.frombuffer(rec, np.float32),
            np.asarray([len(rec)], np.int32))


def test_from_tfrecord_file_equals_jax(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    rows = [np.arange(3, dtype=np.float32) + i for i in range(8)]
    assert write_tfrecord(path, [r.tobytes() for r in rows]) == 8
    jpath = str(tmp_path / "j.tfrecord")
    jwrite(jpath, [r.tobytes() for r in rows])
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = TFDataset.from_tfrecord_file(path, _parse, batch_size=4)
    want = JTFDataset.from_tfrecord_file(path, _parse, batch_size=4)
    assert len(got) == 8
    _same_batches(got, want)
    both = TFDataset.from_tfrecord_file([path, jpath], _parse, batch_size=4)
    assert len(both) == 16


# ---------------------------------------------------------------------------
# GANEstimator
# ---------------------------------------------------------------------------

def _mlps(layers, models, noise_dim=4):
    gen = models.Sequential()
    gen.add(layers.Dense(16, activation="relu", input_shape=(noise_dim,)))
    gen.add(layers.Dense(1))
    disc = models.Sequential()
    disc.add(layers.Dense(16, activation="relu", input_shape=(1,)))
    disc.add(layers.Dense(1))
    return gen, disc


def _close_params(tmodel, jparams, what):
    for path, got, want in paired_leaves(
            tmodel, jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(got, want, rtol=0, atol=GAN_TOL,
                                   err_msg=f"{what} {path}")


def test_gan_steps_match_jax_from_copied_weights():
    """Five alternations of one discriminator and one generator update on
    the same real batches and noise: losses and parameters within 1e-5."""
    jgen, jdisc = _mlps(jl, jmodels)
    tgen, tdisc = _mlps(tl, tmodels)
    jest = JGAN(jgen, jdisc, generator_optimizer=jopt.Adam(lr=5e-3),
                discriminator_optimizer=jopt.Adam(lr=5e-3), noise_dim=4)
    test = GANEstimator(tgen, tdisc,
                        generator_optimizer=topt.Adam(lr=5e-3),
                        discriminator_optimizer=topt.Adam(lr=5e-3),
                        noise_dim=4)
    jest._build()
    load_jax_params(tgen, jax.tree.map(np.asarray, jest.g_params))
    load_jax_params(tdisc, jax.tree.map(np.asarray, jest.d_params))
    test._build()
    assert test.device == torch.device("cpu")
    rs = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    gp, dp = jest.g_params, jest.d_params
    gs, ds = jest.g_opt_state, jest.d_opt_state
    for i in range(5):
        real = (rs.standard_normal((16, 1)) * 0.5 + 3.0).astype(np.float32)
        d_noise = rs.standard_normal((16, 4)).astype(np.float32)
        g_noise = rs.standard_normal((16, 4)).astype(np.float32)
        dp, ds, jd = jest._d_step(gp, dp, ds, real, d_noise, key)
        gp, gs, jg = jest._g_step(gp, dp, gs, g_noise, key)
        td = test.d_step(torch.from_numpy(real), torch.from_numpy(d_noise))
        tg = test.g_step(torch.from_numpy(g_noise))
        np.testing.assert_allclose(float(td), float(jd), rtol=0,
                                   atol=GAN_TOL, err_msg=f"d loss {i}")
        np.testing.assert_allclose(float(tg), float(jg), rtol=0,
                                   atol=GAN_TOL, err_msg=f"g loss {i}")
        _close_params(tdisc, dp, f"discriminator after {i}")
        _close_params(tgen, gp, f"generator after {i}")
    # generate from the same noise gives the same samples
    noise = rs.standard_normal((8, 4)).astype(np.float32)
    jest.g_params = gp
    np.testing.assert_allclose(test.generate(noise=noise),
                               jest.generate(noise=noise), rtol=0,
                               atol=GAN_TOL)


def test_gan_step_trains_only_its_own_side():
    gen, disc = _mlps(tl, tmodels)
    est = GANEstimator(gen, disc, noise_dim=4)
    real, noise = torch.full((8, 1), 3.0), est.noise(8)   # builds both
    before = {k: v.detach().clone() for k, v in gen.named_parameters()}
    assert before
    est.d_step(real, noise)
    assert all(torch.equal(before[k], v) for k, v in gen.named_parameters())
    assert all(p.grad is None for p in gen.parameters())
    before = {k: v.detach().clone() for k, v in disc.named_parameters()}
    est.g_step(est.noise(8))
    assert all(torch.equal(before[k], v)
               for k, v in disc.named_parameters())
    assert all(p.grad is None for p in disc.parameters())
    # each optimizer state mirrors its own side's parameters only
    adam = est.g_opt_state
    mu = adam[0]["mu"] if isinstance(adam, list) else adam["mu"]
    assert set(mu) == set(dict(gen.named_parameters()))


def test_gan_learns_1d_gaussian():
    """tests/test_tfpark.py's case, fed through TFDataset.from_ndarrays."""
    gen, disc = _mlps(tl, tmodels)
    rng = np.random.default_rng(0)
    real = (rng.standard_normal((512, 1)) * 0.5 + 3.0).astype(np.float32)
    est = GANEstimator(gen, disc, generator_optimizer=topt.Adam(lr=5e-3),
                       discriminator_optimizer=topt.Adam(lr=5e-3),
                       noise_dim=4)
    est.train(TFDataset.from_ndarrays(real, batch_size=64), steps=150)
    samples = est.generate(256)
    assert samples.shape == (256, 1)
    assert abs(float(samples.mean()) - 3.0) < 1.0
    assert set(est.last_losses) == {"g", "d"}
    assert est.steps == 150


def test_public_names():
    from analytics_zoo_tpu import tfpark as jtfpark
    assert sorted(ttfpark.__all__) == sorted(jtfpark.__all__)
