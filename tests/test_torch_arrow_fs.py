"""The port's pyarrow.fs handler (``utils/arrow_fs.py``) against the JAX
package's, with pyarrow's ``LocalFileSystem`` mounted under a mock remote
scheme as the JAX tests mount it (no network). Both packages' adapters
answer the same calls with the same bytes, names and sizes; the port's
adapter also serves an object that only has pyarrow's methods, with
pyarrow hidden."""

import sys

import numpy as np
import pytest

pafs = pytest.importorskip("pyarrow.fs")

from analytics_zoo_tpu.utils import arrow_fs as jarrow  # noqa: E402
from analytics_zoo_tpu.utils import file_io as jio  # noqa: E402
from analytics_zoo_tpu_torch.utils import arrow_fs as tarrow  # noqa: E402
from analytics_zoo_tpu_torch.utils import file_io as tio  # noqa: E402


@pytest.fixture()
def mockfs(tmp_path):
    tarrow.register_arrow_filesystem("mockfs", pafs.LocalFileSystem())
    jarrow.register_arrow_filesystem("jmockfs", pafs.LocalFileSystem())
    yield f"mockfs://{tmp_path}", f"jmockfs://{tmp_path}"
    tio._SCHEMES.pop("mockfs", None)
    jio._SCHEMES.pop("jmockfs", None)


def _surface(io, root):
    """One pass over the file_io surface under ``root``; what it saw."""
    seen = {}
    io.write_bytes(f"{root}/sub/dir/blob.bin", b"hello remote")
    for i in range(3):
        io.write_bytes(f"{root}/ds/part-{i:05d}.parquet", b"p" * (10 * (i + 1)))
    io.write_bytes(f"{root}/ds/_SUCCESS", b"")
    seen["exists"] = io.exists(f"{root}/sub/dir/blob.bin")
    seen["read"] = io.read_bytes(f"{root}/sub/dir/blob.bin")
    seen["listdir"] = io.listdir(f"{root}/ds")
    seen["glob"] = [g.split("://", 1)[1] for g in
                    io.glob(f"{root}/ds/*.parquet")]
    seen["size"] = io.file_size(f"{root}/ds/part-00002.parquet")
    with io.open_file(f"{root}/notes.txt", "w") as f:
        f.write("text mode")
    with io.open_file(f"{root}/notes.txt", "r") as f:
        seen["text"] = f.read()
    io.rename(f"{root}/sub/dir/blob.bin", f"{root}/sub/dir/blob2.bin")
    seen["renamed"] = (io.exists(f"{root}/sub/dir/blob.bin"),
                       io.exists(f"{root}/sub/dir/blob2.bin"))
    io.remove(f"{root}/sub/dir/blob2.bin")
    seen["removed"] = io.exists(f"{root}/sub/dir/blob2.bin")
    with pytest.raises(FileNotFoundError):
        io.file_size(f"{root}/ds/part-99999.parquet")
    seen["missing_glob"] = io.glob(f"{root}/nowhere/*.npz")
    return seen


def test_arrow_scheme_answers_as_jax(mockfs, tmp_path):
    port, jax_root = mockfs
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = _surface(tio, port + "/p")
    want = _surface(jio, jax_root + "/j")
    got["glob"] = [g.replace("/p/", "/") for g in got["glob"]]
    want["glob"] = [g.replace("/j/", "/") for g in want["glob"]]
    assert got == want
    assert got["listdir"] == ["_SUCCESS"] + [f"part-{i:05d}.parquet"
                                             for i in range(3)]
    assert got["size"] == 30 and got["read"] == b"hello remote"


def test_npz_shards_and_checkpoint_bytes_over_the_scheme(mockfs):
    """A feature set reads its shards through the scheme, and the bytes a
    shard holds equal the local file's."""
    from analytics_zoo_tpu_torch.feature.feature_set import (DiskFeatureSet,
                                                             FeatureSet)
    port, _ = mockfs
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    local = port.split("://", 1)[1] + "/s0.npz"
    DiskFeatureSet.write_shard(local, x, x[:, :1])
    fs = FeatureSet.files([f"{port}/s0.npz"], shard_per_host=False)
    (batch,) = list(fs.batches(10, shuffle=False))
    np.testing.assert_array_equal(batch.inputs[0], x)


class _DuckFS:
    """pyarrow.fs's methods over a real LocalFileSystem, returning
    infos whose ``type`` is a plain int and taking any selector with
    pyarrow's fields."""

    def __init__(self):
        self.inner = pafs.LocalFileSystem()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def get_file_info(self, what):
        if isinstance(what, list):
            infos = self.inner.get_file_info(what)
        else:
            infos = self.inner.get_file_info(pafs.FileSelector(
                what.base_dir, recursive=what.recursive))

        class Info:
            def __init__(self, i):
                self.path, self.size, self.type = i.path, i.size, int(i.type)
        return [Info(i) for i in infos]


def test_adapter_serves_a_duck_filesystem_without_pyarrow(tmp_path,
                                                          monkeypatch):
    duck = _DuckFS()
    adapter = tarrow.ArrowFileSystem(duck)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.fs", None)
    root = str(tmp_path)
    with adapter.open(root + "/a/b.bin", "wb") as f:
        f.write(b"xyz")
    assert adapter.exists(root + "/a/b.bin")
    assert not adapter.exists(root + "/a/c.bin")
    assert adapter.listdir(root + "/a") == ["b.bin"]
    assert adapter.glob(root + "/a/*.bin") == [root + "/a/b.bin"]
    assert adapter.size(root + "/a/b.bin") == 3
    with pytest.raises(ImportError):
        tarrow.make_arrow_filesystem("hdfs")


def test_unknown_scheme_raises_as_jax():
    with pytest.raises(ValueError, match="no pyarrow filesystem"):
        tarrow.make_arrow_filesystem("ftp")
    with pytest.raises(ValueError, match="no pyarrow filesystem"):
        jarrow.make_arrow_filesystem("ftp")
