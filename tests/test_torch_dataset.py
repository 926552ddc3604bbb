"""The port's datasets against the JAX package on the CPU: shard discovery
and assignment, sharded npz / csv / parquet / arrow files and directories,
the memory tiers (DIRECT arena, mmap fallback, DISK_AND_DRAM, generators),
TFRecord files written by each package and read by the other, the native
reader against the plain one, corrupt checksums, and the host arena.

Every comparison is exact: the same files (or numpy inputs from a seed)
go through both packages and the batches, plans and bytes must be equal.
The csv reader is the standard library's here and pandas' in the JAX
package; on numeric columns they agree value for value.
"""

import os
import struct

import numpy as np
import pytest

from analytics_zoo_tpu_torch.feature.dataset import (
    ShardedDatasetFeatureSet, assign_shards, discover_shards,
    write_parquet_shards)
from analytics_zoo_tpu_torch.feature.feature_set import (
    DirectFeatureSet, DiskFeatureSet, FeatureSet, MmapFeatureSet, MiniBatch,
    ShardedFileFeatureSet, minibatch_len, pad_minibatch, process_topology)
from analytics_zoo_tpu_torch.feature.tfrecord import (
    read_tfrecord, read_tfrecord_reference, write_tfrecord)
from analytics_zoo_tpu_torch.utils.native_loader import load_zoo_data

from analytics_zoo_tpu.feature import dataset as jds
from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.feature import tfrecord as jtf


def _leaves(batch):
    t = batch.targets
    ts = list(t) if isinstance(t, (list, tuple)) else [t]
    return list(batch.inputs) + ts + [batch.weights]


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            if x is None or y is None:
                assert x is None and y is None, i
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, i
            assert x.tobytes() == y.tobytes(), f"batch {i} differs"


def _sizes():
    rng = np.random.default_rng(7)
    for num_processes in range(1, 6):
        for n_shards in range(0, 13):
            yield rng.integers(0, 1 << 20, n_shards).tolist(), num_processes


# -- assignment and discovery ---------------------------------------------
def test_assign_shards_equals_jax():
    for sizes, p in _sizes():
        plan = assign_shards(sizes, p)
        assert plan == jds.assign_shards(sizes, p)
        assert sorted(i for h in plan for i in h) == list(range(len(sizes)))
    for n in range(0, 13):
        for p in range(1, 6):
            assert assign_shards([0] * n, p) == jds.assign_shards([0] * n, p)
    for bad in (([1, 2], 0), ([1, -2], 2)):
        with pytest.raises(ValueError):
            assign_shards(*bad)


def test_discover_shards_equals_jax(tmp_path):
    d = tmp_path / "ds"
    d.mkdir()
    for i, name in enumerate(["part-00002.parquet", "part-00000.npz",
                              "part-00001.csv", "_SUCCESS", ".part-0.crc",
                              "README.txt", "x.arrow"]):
        (d / name).write_bytes(b"x" * (10 + i))
    got = discover_shards(str(d))
    assert [tuple(s) for s in got] == \
        [tuple(s) for s in jds.discover_shards(str(d))]
    assert [s.path.rsplit("/", 1)[1] for s in got] == [
        "part-00000.npz", "part-00001.csv", "part-00002.parquet", "x.arrow"]
    single = discover_shards(str(d / "part-00000.npz"))
    assert len(single) == 1 and single[0].size == 11
    with pytest.raises(FileNotFoundError):
        discover_shards(str(tmp_path / "missing"))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "_SUCCESS").write_bytes(b"")
    with pytest.raises(ValueError, match="no dataset shards"):
        discover_shards(str(empty))


def test_process_topology(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_PROCESS_ID", raising=False)
    monkeypatch.delenv("ZOO_TPU_NUM_PROCESSES", raising=False)
    assert process_topology() == (0, 1)
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("ZOO_TPU_NUM_PROCESSES", "3")
    assert process_topology() == (1, 3)


# -- sharded files ----------------------------------------------------------
def _write_frames(tmp_path, fmt, n_shards=4, rows=10, seed=0):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_shards):
        df = pd.DataFrame({"a": rng.standard_normal(rows),
                           "b": rng.standard_normal(rows),
                           "c": rng.integers(-5, 5, rows),
                           "label": rng.integers(0, 2, rows)})
        p = str(tmp_path / f"shard{i}.{fmt}")
        if fmt == "csv":
            df.to_csv(p, index=False)
        else:
            df.to_parquet(p, index=False)
        paths.append(p)
    return paths


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_sharded_files_equal_jax(tmp_path, fmt):
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    paths = _write_frames(tmp_path, fmt)
    for kw in (dict(label_col="label"),
               dict(columns=["b", "c"], label_col="label"),
               dict()):
        got = FeatureSet.files(paths, shard_per_host=False, **kw)
        want = jfs.FeatureSet.files(paths, shard_per_host=False, **kw)
        assert got.size() == want.size() == 40
        for bkw in (dict(batch_size=8),
                    dict(batch_size=16, shuffle=True, seed=3,
                         drop_remainder=False, pad_remainder=True)):
            assert_batches_equal(got.batches(**bkw), want.batches(**bkw))


def test_sharded_files_striping_equals_jax(tmp_path):
    paths = _write_frames(tmp_path, "csv")
    for pid in range(2):
        got = ShardedFileFeatureSet(paths, label_col="label",
                                    process_index=pid, num_processes=2)
        want = jfs.ShardedFileFeatureSet(paths, label_col="label",
                                         process_index=pid, num_processes=2)
        assert got.paths == want.paths == paths[pid::2]
        assert got.size() == 20
        assert_batches_equal(got.batches(8, drop_remainder=False),
                             want.batches(8, drop_remainder=False))
    with pytest.raises(ValueError, match="no shards"):
        ShardedFileFeatureSet(paths[:1], process_index=1, num_processes=2)


def test_csv_column_types_equal_pandas(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b,c,label\n1.5,2,,0\n-3,4,5.25,1\n7,8,9,1\n")
    for kw in (dict(label_col="label"), dict(columns=["c"], label_col="a")):
        (got,) = FeatureSet.files([str(p)], shard_per_host=False,
                                  **kw).batches(3, drop_remainder=False)
        (want,) = jfs.FeatureSet.files([str(p)], shard_per_host=False,
                                       **kw).batches(3, drop_remainder=False)
        assert np.isnan(got.inputs[0]).sum() == \
            np.isnan(want.inputs[0]).sum()
        np.testing.assert_array_equal(got.inputs[0], want.inputs[0])
        assert got.targets.dtype == want.targets.dtype
        np.testing.assert_array_equal(got.targets, want.targets)


def test_npz_disk_and_dram_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for s in range(4):
        p = str(tmp_path / f"shard{s}.npz")
        DiskFeatureSet.write_shard(
            p, [rng.standard_normal((20, 3)).astype(np.float32),
                rng.integers(0, 9, (20, 2)).astype(np.int32)],
            rng.integers(0, 2, 20).astype(np.int32))
        paths.append(p)
    got = FeatureSet.rdd(paths, memory_type="DISK_AND_DRAM(2)")
    want = jfs.FeatureSet.rdd(paths, memory_type="DISK_AND_DRAM(2)")
    assert isinstance(got, DiskFeatureSet) and got.size() == 80
    for kw in (dict(shuffle=True, seed=2),
               dict(drop_remainder=False, pad_remainder=True)):
        assert_batches_equal(got.batches(12, **kw), want.batches(12, **kw))
    assert_batches_equal(FeatureSet.disk(paths).batches(10),
                         jfs.FeatureSet.disk(paths).batches(10))


def test_dataset_dirs_equal_jax(tmp_path):
    """npz and parquet directories through ``from_dataset``, two hosts:
    each host's shards and batches are JAX's, disjoint and covering."""
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    y = np.arange(64, dtype=np.float32)
    uri = str(tmp_path / "parquet_ds")
    assert write_parquet_shards(uri, x, y, num_shards=8) == \
        [f"{uri}/part-{i:05d}.parquet" for i in range(8)]
    npz = tmp_path / "npz_ds"
    npz.mkdir()
    for i in range(3):
        DiskFeatureSet.write_shard(str(npz / f"shard-{i}.npz"),
                                   np.full((5 + i, 2), i, np.float32),
                                   np.full(5 + i, i, np.float32))
    for d, hosts, label in ((uri, 2, "label"), (str(npz), 2, None)):
        names = []
        for pid in range(hosts):
            got = FeatureSet.from_dataset(d, label_col=label,
                                          process_index=pid,
                                          num_processes=hosts)
            want = jds.ShardedDatasetFeatureSet(d, label_col=label,
                                                process_index=pid,
                                                num_processes=hosts)
            assert isinstance(got, ShardedDatasetFeatureSet)
            assert got.local_shards == want.local_shards
            names += got.local_shards
            assert_batches_equal(
                got.batches(4, shuffle=True, seed=pid,
                            drop_remainder=False),
                want.batches(4, shuffle=True, seed=pid,
                             drop_remainder=False))
        assert sorted(names) == sorted(os.path.basename(s.path) for s in
                                       discover_shards(d))
    with pytest.raises(ValueError, match="no shards for process 3"):
        FeatureSet.from_dataset(str(npz), process_index=3, num_processes=4)


def test_arrow_ipc_with_list_column_equals_jax(tmp_path):
    pa = pytest.importorskip("pyarrow")
    n = 12
    rng = np.random.default_rng(1)
    img = rng.standard_normal((n, 6)).astype(np.float32)
    table = pa.table({"img": [row.tolist() for row in img],
                      "s": np.arange(n, dtype=np.float32),
                      "label": rng.standard_normal(n).astype(np.float32)})
    path = tmp_path / "shard-0.arrow"
    with pa.ipc.new_file(str(path), table.schema) as w:
        w.write_table(table)
    got = FeatureSet.from_dataset(str(path), label_col="label",
                                  process_index=0, num_processes=1)
    want = jds.ShardedDatasetFeatureSet(str(path), label_col="label",
                                        process_index=0, num_processes=1)
    assert_batches_equal(got.batches(n, drop_remainder=False),
                         want.batches(n, drop_remainder=False))
    shapes = sorted(np.asarray(f).shape for f in
                    next(got.batches(n, drop_remainder=False)).inputs)
    assert shapes == [(n, 1), (n, 6)]


# -- memory tiers -------------------------------------------------------------
def test_direct_tier_is_the_native_arena_and_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    got = FeatureSet.rdd(FeatureSet.array([x], [y]), memory_type="DIRECT")
    want = jfs.FeatureSet.rdd(jfs.FeatureSet.array([x], [y]),
                              memory_type="DIRECT")
    assert type(got) is DirectFeatureSet
    assert got.features[0].ctypes.data % 64 == 0
    assert_batches_equal(got.batches(16, shuffle=True, seed=1),
                         want.batches(16, shuffle=True, seed=1))


def test_full_arena_falls_back_to_mmaps_and_says_so(monkeypatch, tmp_path,
                                                    caplog):
    import logging

    from analytics_zoo_tpu_torch.utils import native_loader

    def full(self, capacity):
        raise MemoryError(f"cannot allocate {capacity}-byte arena")

    monkeypatch.setattr(native_loader.ZooDataLib, "arena", full)
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch.feature"):
        fs = FeatureSet.rdd(FeatureSet.array(x, x[:, 0]),
                            memory_type="DIRECT",
                            arena_path=str(tmp_path / "mm"))
    assert type(fs) is MmapFeatureSet
    assert any("memory-mapped" in r.message for r in caplog.records)
    assert os.path.exists(tmp_path / "mm" / "x0.npy")
    assert not fs.features[0].flags.owndata  # a view of the mapped file
    np.testing.assert_array_equal(next(fs.batches(10)).inputs[0], x)


def test_a_failed_native_build_raises_through_rdd(monkeypatch):
    from analytics_zoo_tpu_torch.utils import native_loader

    def broken():
        raise native_loader.NativeCompileError(
            "building zoo_data.cpp failed")

    monkeypatch.setattr(
        "analytics_zoo_tpu_torch.utils.native_loader.load_zoo_data", broken)
    with pytest.raises(native_loader.NativeCompileError):
        FeatureSet.rdd(FeatureSet.array(np.zeros((4, 2), np.float32)),
                       memory_type="PMEM")


def _gen():
    for i in range(11):
        yield np.full(3, i, np.float32), np.float32(i)


def test_generator_and_samples_equal_jax():
    for kw in (dict(), dict(drop_remainder=False, pad_remainder=True),
               dict(drop_remainder=False)):
        assert_batches_equal(
            FeatureSet.generator(_gen, 11).batches(4, **kw),
            jfs.FeatureSet.generator(_gen, 11).batches(4, **kw))
    samples = [jfs.Sample(np.full(2, i), np.float32(i)) for i in range(5)]
    got = FeatureSet.sample_rdd(samples)
    want = jfs.FeatureSet.sample_rdd(samples)
    assert_batches_equal(got.batches(2, drop_remainder=False),
                         want.batches(2, drop_remainder=False))


def test_pad_minibatch_equals_jax():
    b = MiniBatch((np.arange(6.0).reshape(3, 2),), [np.arange(3)], None)
    jb = jfs.MiniBatch((np.arange(6.0).reshape(3, 2),), [np.arange(3)],
                       None)
    got, want = pad_minibatch(b, 5), jfs.pad_minibatch(jb, 5)
    assert minibatch_len(got) == jfs.minibatch_len(want) == 5
    assert_batches_equal([got], [want])
    assert pad_minibatch(b, 2) is b


# -- TFRecord ---------------------------------------------------------------
def _records(n=50):
    return [bytes([i % 256]) * (i * 13 % 97) for i in range(n)]


def test_tfrecord_bytes_equal_and_read_across_packages(tmp_path):
    mine, theirs = str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")
    assert write_tfrecord(mine, _records()) == 50
    jtf.write_tfrecord(theirs, _records())
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(read_tfrecord(theirs, verify_crc=True)) == _records()
    assert list(jtf.read_tfrecord(mine, verify_crc=True)) == _records()


def test_native_reader_equals_the_plain_one(tmp_path):
    rng = np.random.default_rng(3)
    recs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 5000, 40)] + [b""]
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    native = list(read_tfrecord(path, verify_crc=True))
    assert native == list(read_tfrecord_reference(path, verify_crc=True))
    assert native == recs
    assert list(read_tfrecord(path)) == recs
    empty = str(tmp_path / "e.tfrecord")
    write_tfrecord(empty, [])
    assert list(read_tfrecord(empty)) == []


@pytest.mark.parametrize("where, verify, message", [
    (14, True, "data crc mismatch"),     # a payload byte
    (2, False, "length crc mismatch"),   # a length byte: always checked
    (-1, True, "data crc mismatch"),     # the payload's checksum
])
def test_corrupt_crc_raises(tmp_path, where, verify, message):
    path = str(tmp_path / "c.tfrecord")
    write_tfrecord(path, [b"hello world", b"second record"])
    raw = bytearray(open(path, "rb").read())
    raw[where] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match=message):
        list(read_tfrecord(path, verify_crc=verify))
    with pytest.raises(IOError):
        list(read_tfrecord_reference(path, verify_crc=True))


def test_truncated_tfrecord_raises(tmp_path):
    path = str(tmp_path / "t.tfrecord")
    write_tfrecord(path, [b"x" * 100])
    data = open(path, "rb").read()
    for cut in (6, 30):
        open(path, "wb").write(data[:cut])
        with pytest.raises(IOError, match="truncated"):
            list(read_tfrecord(path))
    assert struct.unpack("<Q", data[:8])[0] == 100


# -- the host arena -----------------------------------------------------------
def test_host_arena_store_view_reset():
    arena = load_zoo_data().arena(1 << 16)
    a = np.arange(256, dtype=np.float32).reshape(16, 16)
    b = np.arange(63, dtype=np.int8)
    c = np.asfortranarray(np.arange(12, dtype=np.float64).reshape(3, 4))
    va, vb, vc = arena.store(a), arena.store(b), arena.store(c)
    np.testing.assert_array_equal(va.numpy(), a)
    np.testing.assert_array_equal(vb.numpy(), b)
    np.testing.assert_array_equal(vc.numpy(), c)
    assert arena.used == 1024 + 64 + 128
    assert va.offset % 64 == 0 and vb.offset % 64 == 0 and \
        vc.offset % 64 == 0
    assert arena.capacity == 1 << 16
    arena.reset()
    assert arena.used == 0
    arena.close()


def test_host_arena_full_raises():
    arena = load_zoo_data().arena(4096)
    with pytest.raises(MemoryError, match="arena full"):
        for _ in range(100):
            arena.store(np.zeros(128, np.float64))
    assert arena.used == 4096
    arena.close()


def test_native_library_lands_under_build(tmp_path):
    from analytics_zoo_tpu_torch.utils import native_loader

    load_zoo_data()
    built = [p.name for p in native_loader.BUILD_DIR.iterdir()]
    assert any(n.startswith("libzoo_torch_data.") and n.endswith(".so")
               for n in built)
    assert native_loader.BUILD_DIR.parts[-2:] == ("build", "torch_native")
