"""The port's Keras dataset loaders against the JAX package's: each one
on its seeded surrogate (no archive in the directory) and on a cached
file the test writes in the reference's layout, value for value and
dtype for dtype."""

import gzip
import json
import struct

import numpy as np
import pytest

from analytics_zoo_tpu.pipeline.api.keras import datasets as jd
from analytics_zoo_tpu_torch.pipeline.api.keras import datasets as td


def assert_same(got, want):
    """Nested tuples/lists of arrays or lists of int lists, equal."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name, kw", [
    ("mnist", {}),
    ("boston_housing", {}),
    ("boston_housing", {"test_split": 0.3}),
    ("imdb", {}),
    ("imdb", {"nb_words": 100, "oov_char": 2}),
    ("imdb", {"nb_words": 100, "oov_char": None}),
    ("reuters", {}),
    ("reuters", {"nb_words": 200, "test_split": 0.1}),
])
def test_surrogates_equal_jax(tmp_path, name, kw):
    where = {"mnist": {"location": str(tmp_path / "none")}}.get(
        name, {"dest_dir": str(tmp_path / "none")})
    got = getattr(td, name).load_data(**where, **kw)
    want = getattr(jd, name).load_data(**where, **kw)
    assert_same(got, want)


def _idx(path, magic, dims, data):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">" + "I" * (1 + len(dims)), magic, *dims))
        f.write(data.tobytes())


def test_mnist_reads_idx_files_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    for prefix, n in (("train", 12), ("t10k", 5)):
        _idx(tmp_path / f"{prefix}-images-idx3-ubyte.gz", 2051, (n, 28, 28),
             rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        _idx(tmp_path / f"{prefix}-labels-idx1-ubyte.gz", 2049, (n,),
             rng.integers(0, 10, n, dtype=np.uint8))
    got = td.mnist.load_data(str(tmp_path))
    assert got[0][0].shape == (12, 28, 28, 1)
    assert_same(got, jd.mnist.load_data(str(tmp_path)))
    _idx(tmp_path / "t10k-labels-idx1-ubyte.gz", 9999, (5,),
         np.zeros(5, np.uint8))
    with pytest.raises(ValueError, match="bad idx1 magic"):
        td.mnist.load_data(str(tmp_path))


def test_cached_npz_files_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "boston_housing.npz",
             x=rng.standard_normal((30, 13)), y=rng.standard_normal(30))
    seqs = np.empty(7, object)
    for i in range(7):
        seqs[i] = rng.integers(1, 400, int(rng.integers(3, 20))).tolist()
    np.savez(tmp_path / "imdb.npz", x_train=seqs[:5], y_train=np.arange(5),
             x_test=seqs[5:], y_test=np.arange(2))
    np.savez(tmp_path / "reuters.npz", x=seqs, y=np.arange(7) % 3)
    d = str(tmp_path)
    assert_same(td.boston_housing.load_data(dest_dir=d),
                jd.boston_housing.load_data(dest_dir=d))
    for kw in ({}, {"nb_words": 100}, {"nb_words": 100, "oov_char": None}):
        assert_same(td.imdb.load_data(dest_dir=d, **kw),
                    jd.imdb.load_data(dest_dir=d, **kw))
        assert_same(td.reuters.load_data(dest_dir=d, **kw),
                    jd.reuters.load_data(dest_dir=d, **kw))


def test_imdb_word_index_equals_jax(tmp_path):
    assert td.imdb.get_word_index(str(tmp_path)) == \
        jd.imdb.get_word_index(str(tmp_path))
    (tmp_path / "imdb_word_index.json").write_text(
        json.dumps({"the": 1, "a": 2}))
    assert td.imdb.get_word_index(str(tmp_path)) == {"the": 1, "a": 2} == \
        jd.imdb.get_word_index(str(tmp_path))
