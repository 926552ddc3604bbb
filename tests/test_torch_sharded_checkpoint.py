"""The sharded checkpoint format (``utils/sharded_checkpoint.py``) of the
port against the JAX package's, on the CPU.

- Module level: JAX writes a leaf split over four devices (pieces in one
  shard file) and the port reads it whole and by region; the port writes
  a leaf split across two processes' files and JAX loads it onto a
  replicated and onto a split layout; the port re-shards its own files;
  a missing shard file, pieces that do not cover a leaf, and a corrupt
  file raise.
- Trainer level (``ZOO_TPU_SHARDED_CHECKPOINT=1``): a JAX trainer's
  sharded checkpoint restores into the port's trainer, and the port's
  into JAX's, parameters and Adam state bit for bit, with the step.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_workers as workers
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature.feature_set import MiniBatch as JMiniBatch
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu.utils import sharded_checkpoint as jsc
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.feature_set import MiniBatch
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils import sharded_checkpoint as tsc
from analytics_zoo_tpu_torch.utils.jax_weights import (optimizer_leaves,
                                                       param_order)

TAG = "sc"


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _leaves(seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((8, 6)).astype(np.float32),
            rs.standard_normal((4,)).astype(np.float32),
            np.asarray(7, np.int32)]


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

def test_the_port_reads_jax_shards_whole_and_by_region(tmp_path):
    leaves = _leaves()
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    split = NamedSharding(mesh, P("model", None))
    arrays = [jax.device_put(leaves[0], split),
              jax.device_put(leaves[1], NamedSharding(mesh, P())),
              leaves[2]]
    jsc.save_shards(str(tmp_path), "params", arrays, tag="s3")
    jsc.write_manifest(str(tmp_path), "params", arrays, tag="s3")
    jsc.write_commit(str(tmp_path), "s3")
    assert tsc.read_commit(str(tmp_path)) == "s3"
    assert tsc.exists(str(tmp_path), "params", "s3")
    got = tsc.load_shards(str(tmp_path), "params", tag="s3")
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
    assert got[2].dtype == np.int32
    block = tsc.load_shards(str(tmp_path), "params", tag="s3",
                            regions=[(slice(2, 7), slice(1, 4)), None,
                                     None])[0]
    np.testing.assert_array_equal(block, leaves[0][2:7, 1:4])


def test_jax_reads_a_leaf_the_port_split_across_two_processes(tmp_path):
    leaves = _leaves(1)
    d = str(tmp_path)
    # process p writes rows [4p, 4p + 4) of the matrix, process 0 the rest
    for p in (0, 1):
        pieces = [(0, [(4 * p, 4 * p + 4), (0, 6)],
                   leaves[0][4 * p:4 * p + 4])]
        if p == 0:
            pieces += [(1, [(0, 4)], leaves[1]), (2, [], leaves[2])]
        tsc.save_shards(d, "optim", leaves, process_index=p, pieces=pieces)
    tsc.write_manifest(d, "optim", leaves, n_shard_files=2)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["optim.shard0.npz", "optim.shard1.npz"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    repl = NamedSharding(mesh, P())
    for sh in (repl, NamedSharding(mesh, P(None, "data"))):
        got = jsc.load_shards(d, "optim", [sh, repl, repl])
        for a, b in zip(got, leaves):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_the_port_reshards_its_own_files(tmp_path):
    leaves = _leaves(2)
    d = str(tmp_path)
    tsc.save_shards(d, "params", leaves, process_index=0)
    tsc.save_shards(d, "params", leaves, process_index=1)   # empty
    tsc.write_manifest(d, "params", leaves, n_shard_files=2)
    for p in range(4):
        got = tsc.load_shards(d, "params", regions=[
            (slice(2 * p, 2 * p + 2), slice(0, 6)), None, None])
        np.testing.assert_array_equal(got[0], leaves[0][2 * p:2 * p + 2])
        np.testing.assert_array_equal(got[1], leaves[1])


def test_an_incomplete_checkpoint_raises(tmp_path):
    leaves = _leaves(3)
    d = str(tmp_path / "missing")
    tsc.save_shards(d, "params", leaves, process_index=0)
    tsc.write_manifest(d, "params", leaves, n_shard_files=2)
    with pytest.raises(FileNotFoundError, match="incomplete"):
        tsc.load_shards(d, "params")
    # pieces that do not cover the leaf
    d = str(tmp_path / "uncovered")
    tsc.save_shards(d, "params", leaves, process_index=0,
                    pieces=[(0, [(0, 4), (0, 6)], leaves[0][:4]),
                            (1, [(0, 4)], leaves[1]), (2, [], leaves[2])])
    tsc.write_manifest(d, "params", leaves, n_shard_files=1)
    with pytest.raises(ValueError, match="incomplete or corrupt"):
        tsc.load_shards(d, "params")
    # a corrupt file fails its checksum
    d = str(tmp_path / "corrupt")
    tsc.save_shards(d, "params", leaves, process_index=0)
    tsc.write_manifest(d, "params", leaves, n_shard_files=1)
    path = os.path.join(d, "params.shard0.npz")
    raw = bytearray(open(path, "rb").read())
    raw[-40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tsc.ChecksumError):
        tsc.load_shards(d, "params")


# ---------------------------------------------------------------------------
# trainer level
# ---------------------------------------------------------------------------

def _jax_trainer(steps):
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(data_parallel=1),
                                     devices=jax.devices()[:1]))
    model = JSequential()
    model.add(JDense(workers.ZERO_HID, activation="relu",
                     input_shape=(workers.ZERO_NIN,), name=f"{TAG}_d0"))
    model.add(JDense(1, activation="sigmoid", name=f"{TAG}_d1"))
    model.compile(optimizer="adam", loss="binary_crossentropy")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    x, y = workers.zero_data()
    fn = trainer.build_train_step()
    for i in range(steps):
        batch = trainer._put_batch(JMiniBatch([x], y, None))
        trainer.params, trainer.opt_state, trainer.net_state, _ = fn(
            trainer.params, trainer.opt_state, trainer.net_state, batch, i)
    trainer.step = steps
    return trainer


def _port_trainer(params):
    tnn.init_nncontext(device="cpu")
    model = workers.zero_model(TAG)
    load_jax_params(model, params)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    return trainer


def _port_state(trainer):
    opt = [np.array(l.detach()) if hasattr(l, "detach") else np.asarray(l)
           for l in optimizer_leaves(trainer.opt_state,
                                     param_order(trainer.model))]
    params = jax.tree.map(lambda t: t.detach().numpy(),
                          trainer.model.param_tree())
    return params, opt


def _assert_equal(jt, tt):
    params, opt = _port_state(tt)
    jparams = jax.tree.map(np.asarray, jt.params)
    assert sorted(jparams) == sorted(params)
    for name in jparams:
        for key in jparams[name]:
            np.testing.assert_array_equal(params[name][key],
                                          jparams[name][key])
    jopt = [np.asarray(l) for l in jax.tree.leaves(jt.opt_state)]
    assert len(jopt) == len(opt)
    for a, b in zip(opt, jopt):
        np.testing.assert_array_equal(a, b)
    assert tt.step == jt.step


def test_the_port_restores_a_jax_trainers_sharded_checkpoint(
        tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SHARDED_CHECKPOINT", "1")
    jt = _jax_trainer(3)
    jt.save_checkpoint(str(tmp_path))
    assert jsc.read_commit(str(tmp_path)) == "s3"
    tt = _port_trainer(jax.tree.map(np.asarray, jt.params))
    tt.load_checkpoint(str(tmp_path))
    _assert_equal(jt, tt)


def test_jax_restores_the_ports_sharded_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SHARDED_CHECKPOINT", "1")
    jt = _jax_trainer(0)
    tt = _port_trainer(jax.tree.map(np.asarray, jt.params))
    x, y = workers.zero_data()
    batch = tt.put_batch(MiniBatch((x,), y, np.ones(len(x), np.float32)))
    for _ in range(4):
        tt.train_step(batch)
    tt.save_checkpoint(str(tmp_path))
    assert tsc.read_commit(str(tmp_path)) == "s4"
    assert not any(n.startswith("ckpt-") for n in os.listdir(tmp_path))
    jt.load_checkpoint(str(tmp_path))
    _assert_equal(jt, tt)
