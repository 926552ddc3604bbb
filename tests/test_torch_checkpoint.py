"""The port's checkpoint store, failure policy, summaries and file formats
against the JAX package on the CPU.

The store's contract is the JAX package's (``tests/test_fault_tolerance.py``,
``tests/test_engine_smoke.py::test_async_checkpoint``), held here for the
port: a crash and a resume are bit-exact against the run that never
stopped, a write that dies midway is never visible, a corrupt checkpoint
falls back to the previous one, retention keeps the last k. Those
comparisons are bitwise, port against port, with the CPU's BLAS pinned to
one thread (its summation order may change between runs in one process
otherwise). The port against JAX:

- the same training run, port and JAX from copied weights: 1e-5 on the
  parameters after 10 Adam steps (float32 matmuls summed in another
  order, 1e-6 apart per step);
- a JAX trainer's checkpoint restored into the port, dropout off, float32:
  the next 3 losses and the Adam moments within 1e-5 of JAX continuing;
- crc32c, pytree files, optimizer leaves and TensorBoard events: exact.
"""

import logging
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.common.zoo_trigger import \
    MaxIteration as JMaxIteration
from analytics_zoo_tpu.common.zoo_trigger import \
    SeveralIteration as JSeveralIteration
from analytics_zoo_tpu.feature.feature_set import \
    ArrayFeatureSet as JArrayFeatureSet
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu.pipeline.estimator.estimator import \
    Estimator as JEstimator
from analytics_zoo_tpu.utils import crc32c as jcrc
from analytics_zoo_tpu.utils import serialization as jser
from analytics_zoo_tpu.utils import tensorboard as jtb
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.common.zoo_trigger import (MaxIteration,
                                                        SeveralIteration)
from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.pipeline import engine
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
from analytics_zoo_tpu_torch.utils import (crc32c, faults, file_io,
                                           serialization, tensorboard)
from analytics_zoo_tpu_torch.utils.faults import (FaultInjected,
                                                  TransientFault)
from analytics_zoo_tpu_torch.utils.file_io import FileIORetryExhausted
from analytics_zoo_tpu_torch.utils.jax_weights import (
    load_optimizer_leaves, optimizer_leaves, param_order)

from test_torch_training import (OPTIMIZERS, _build_optimizer, _classifier,
                                 _data as _bert_data)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("ZOO_TPU_FAULT", "ZOO_TPU_FAULT_STATE", "ZOO_TPU_AUTO_RESUME",
              "ZOO_TPU_SHARDED_CHECKPOINT"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    engine.clear_preemption()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    torch.set_num_threads(threads)
    faults.reset()
    engine.clear_preemption()
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _ctx(**cfg):
    tnn.set_nncontext(None)
    tnn.set_nncontext(tnn.ZooContext(tnn.ZooConfig(**cfg), device="cpu"))


def _xy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    return x, y


def _make_est(ckpt_dir):
    # fixed layer names and the context's seed: every fresh Estimator
    # starts from the same weights and maps onto the same checkpoint keys
    model = Sequential()
    model.add(tl.Dense(8, activation="relu", input_shape=(4,), name="ft_d1"))
    model.add(tl.Dense(1, name="ft_d2"))
    return Estimator(model, topt.Adam(lr=1e-2),
                     model_dir=None if ckpt_dir is None else str(ckpt_dir))


def _train(est, steps, trigger=None):
    est.train(ArrayFeatureSet(*_xy()), "mse",
              end_trigger=MaxIteration(steps),
              checkpoint_trigger=trigger or SeveralIteration(1),
              batch_size=8)
    return est


def _leaves(trainer):
    order = param_order(trainer.model)
    params = trainer.params()
    return [params[k].detach().numpy().copy() for k in order] + \
        [np.asarray(l.detach().numpy() if torch.is_tensor(l) else l).copy()
         for l in optimizer_leaves(trainer.opt_state, order)]


def _assert_bit_exact(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert np.array_equal(g, r)


def _jax_straight_run(steps):
    """The JAX Estimator's run of ``_train`` from the port model's initial
    weights: its parameters, by port name."""
    model = _make_est(None).model
    model.graph_function()
    init = {k: p.detach().numpy() for k, p in model.named_parameters()}
    jmodel = JSequential()
    jmodel.add(jl.Dense(8, activation="relu", input_shape=(4,),
                        name="ft_d1"))
    jmodel.add(jl.Dense(1, name="ft_d2"))
    jest = JEstimator(jmodel, jopt.Adam(lr=1e-2))
    jest._ensure_trainer(jobj.get_loss("mse"), None)
    jest.trainer.set_params(
        {layer: {"kernel": init[f"{layer}.kernel"],
                 "bias": init[f"{layer}.bias"]}
         for layer in ("ft_d1", "ft_d2")}, {})
    jest.train(JArrayFeatureSet(*_xy()), "mse",
               end_trigger=JMaxIteration(steps), batch_size=8)
    params = jax.tree.map(np.asarray, jest.trainer.params)
    return {f"{l}.{k}": v for l, d in params.items() for k, v in d.items()}


# -- the store: crash, resume, fall back, retain ------------------------

def test_resume_parity_bit_exact(tmp_path, monkeypatch):
    """10 straight steps against a failure at step 5 (not retried), a
    fresh trainer's load and 5 more: parameters and Adam state equal bit
    for bit; the straight run agrees with JAX's within 1e-5."""
    straight = _train(_make_est(tmp_path / "a"), 10)
    ref = _leaves(straight.trainer)
    want = _jax_straight_run(10)
    for k, p in straight.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)

    _ctx(failure_retry_times=0)
    monkeypatch.setenv("ZOO_TPU_FAULT", "step:raise@5")
    faults.reset()
    with pytest.raises(FaultInjected):
        _train(_make_est(tmp_path / "b"), 10)
    monkeypatch.delenv("ZOO_TPU_FAULT")
    faults.reset()

    # the fault fires before the step-5 checkpoint trigger: latest = 4
    resumed = _make_est(tmp_path / "b").load_checkpoint(str(tmp_path / "b"))
    assert resumed.trainer.step == 4
    assert resumed.trainer.epoch_batches == 4
    _train(resumed, 10)
    assert resumed.trainer.step == 10
    _assert_bit_exact(_leaves(resumed.trainer), ref)


def test_a_failed_step_restores_latest_and_goes_on(tmp_path, monkeypatch):
    """With retries left, the step failure restores ``latest`` (step 4)
    inside the same ``train`` and finishes equal to the straight run; the
    losses of the undone step are dropped."""
    straight = _train(_make_est(tmp_path / "a"), 10)
    monkeypatch.setenv("ZOO_TPU_FAULT", "step:raise@5")
    faults.reset()
    _ctx(failure_retry_times=1)
    retried = _train(_make_est(tmp_path / "b"), 10)
    assert retried.trainer.step == 10
    _assert_bit_exact(_leaves(retried.trainer), _leaves(straight.trainer))
    assert retried.trainer.step_losses == straight.trainer.step_losses


def test_crash_mid_write_never_visible(tmp_path, monkeypatch):
    """A save that dies mid-file leaves no manifest, keeps ``latest`` on
    the previous checkpoint, and restore skips the partial dir. (No
    retries: the port's retry policy would restore and go on.)"""
    d = tmp_path / "s"
    _ctx(failure_retry_times=0)
    monkeypatch.setenv("ZOO_TPU_FAULT", "ckpt-write:raise@2")
    faults.reset()
    with pytest.raises(FaultInjected):
        _train(_make_est(d), 10)
    monkeypatch.delenv("ZOO_TPU_FAULT")
    faults.reset()
    partial = d / "ckpt-2"
    assert partial.is_dir()
    assert not (partial / "manifest.json").exists()
    assert (d / "latest").read_text() == "ckpt-1"
    resumed = _make_est(d).load_checkpoint(str(d))
    assert resumed.trainer.step == 1


def test_checksum_corruption_falls_back(tmp_path, caplog):
    d = tmp_path / "c"
    est = _train(_make_est(d), 6)
    blob = bytearray((d / "ckpt-6" / "model.npz").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (d / "ckpt-6" / "model.npz").write_bytes(bytes(blob))
    with caplog.at_level(logging.WARNING):
        resumed = _make_est(d).load_checkpoint(str(d))
    assert resumed.trainer.step == 5
    assert any("ckpt-6 unusable" in r.getMessage() for r in caplog.records)
    assert est.trainer.step == 6


def test_all_checkpoints_corrupt_raises(tmp_path):
    d = tmp_path / "c"
    _train(_make_est(d), 5)
    for sub in d.glob("ckpt-*"):
        (sub / "model.npz").write_bytes(b"garbage")
    with pytest.raises(engine.ChecksumError):
        _make_est(d).load_checkpoint(str(d))


def test_retention_keeps_last_k(tmp_path):
    d = tmp_path / "k"
    _train(_make_est(d), 8)
    assert sorted(p.name for p in d.glob("ckpt-*")) == \
        ["ckpt-6", "ckpt-7", "ckpt-8"]
    assert (d / "latest").read_text() == "ckpt-8"


def test_legacy_root_flat_layout_loads(tmp_path):
    """The pre-v2 layout (the files in the directory itself, no manifest
    or ``latest``) still restores."""
    d = tmp_path / "legacy"
    est = _train(_make_est(d), 4)
    ref = _leaves(est.trainer)
    latest = (d / "latest").read_text()
    for f in os.listdir(d / latest):
        if f != "manifest.json":
            shutil.move(str(d / latest / f), str(d / f))
    for sub in list(d.glob("ckpt-*")):
        shutil.rmtree(sub)
    (d / "latest").unlink()
    resumed = _make_est(d).load_checkpoint(str(d))
    assert resumed.trainer.step == 4
    _assert_bit_exact(_leaves(resumed.trainer), ref)


class _PreemptAt:
    """A checkpoint trigger that also raises the preemption flag at step N
    (standing in for a SIGTERM handler)."""

    def __init__(self, at):
        self.at = at

    def __call__(self, record):
        if record.iteration >= self.at:
            engine.request_preemption()
        return True


def test_preemption_drains_and_checkpoints(tmp_path):
    d = tmp_path / "p"
    straight = _train(_make_est(tmp_path / "a"), 10)
    est = _make_est(d)
    with pytest.raises(engine.TrainingPreempted):
        est.train(ArrayFeatureSet(*_xy()), "mse",
                  end_trigger=MaxIteration(10),
                  checkpoint_trigger=_PreemptAt(3), batch_size=8)
    assert est.trainer.step == 3
    assert (d / "latest").read_text() == "ckpt-3"
    engine.clear_preemption()
    resumed = _make_est(d).load_checkpoint(str(d))
    assert resumed.trainer.step == 3
    _train(resumed, 10)
    assert resumed.trainer.step == 10
    _assert_bit_exact(_leaves(resumed.trainer), _leaves(straight.trainer))


def test_auto_resume_env(tmp_path, monkeypatch, caplog):
    d = tmp_path / "r"
    _train(_make_est(d), 5)
    monkeypatch.setenv("ZOO_TPU_AUTO_RESUME", "1")
    with caplog.at_level(logging.INFO):
        est = _train(_make_est(d), 10)
    assert est.trainer.step == 10
    assert any("auto-resume: restored step 5" in r.getMessage()
               for r in caplog.records)
    monkeypatch.delenv("ZOO_TPU_AUTO_RESUME")
    _ctx(auto_resume=True)
    again = _train(_make_est(d), 12)
    assert again.trainer.step == 12


def test_async_checkpoint(tmp_path):
    """``async_checkpoint``: the snapshot is synchronous, the write runs
    on the writer thread, ``train`` joins it, and the files equal a
    synchronous run's byte for byte (the same crc32c in each manifest)."""
    manifests = {}
    for mode in (False, True):
        _ctx(async_checkpoint=mode, log_every_n_steps=1000)
        d = tmp_path / f"async{int(mode)}"
        np.random.seed(0)    # the host RNG is part of the meta
        est = _train(_make_est(d), 8, trigger=SeveralIteration(2))
        assert est.trainer._ckpt_future is None
        manifests[mode] = {
            p.name: (p / "manifest.json").read_text()
            for p in sorted(d.glob("ckpt-*"))}
        assert est.trainer.checkpoint_stats[-1]["bytes"] > 0
        resumed = _make_est(d).load_checkpoint(str(d))
        assert resumed.trainer.step == 8
        _assert_bit_exact(_leaves(resumed.trainer), _leaves(est.trainer))
    assert manifests[True] == manifests[False]
    assert sorted(manifests[True]) == ["ckpt-4", "ckpt-6", "ckpt-8"]


def test_an_async_write_holds_the_state_of_its_step(tmp_path):
    """A step right after an async save changes the parameters in place;
    the files still hold the saved step's state."""
    _ctx(async_checkpoint=True)
    est = _train(_make_est(tmp_path / "w"), 3)
    trainer = est.trainer
    before = _leaves(trainer)
    trainer.save_checkpoint(str(tmp_path / "x"))
    x, y = _xy()
    trainer.train_step(trainer.put_batch(([x[:8]], y[:8],
                                          np.ones(8, np.float32))))
    trainer.wait_for_checkpoint()
    fresh = _make_est(tmp_path / "x").load_checkpoint(str(tmp_path / "x"))
    _assert_bit_exact(_leaves(fresh.trainer), before)
    assert not np.array_equal(_leaves(trainer)[0], before[0])


def test_the_sharded_format_is_refused(tmp_path, monkeypatch):
    """The sharded format is ported now (ROADMAP A12): with
    ``ZOO_TPU_SHARDED_CHECKPOINT=1`` training writes it (a commit, no
    flat ``ckpt-*`` store), and a fresh trainer restores it bit for bit
    (tests/test_torch_sharded_checkpoint.py holds it against JAX)."""
    monkeypatch.setenv("ZOO_TPU_SHARDED_CHECKPOINT", "1")
    est = _train(_make_est(tmp_path / "s"), 2)
    names = os.listdir(tmp_path / "s")
    assert "sharded.commit" in names
    assert not any(n.startswith("ckpt-") for n in names)
    fresh = _make_est(tmp_path / "s").load_checkpoint(str(tmp_path / "s"))
    _assert_bit_exact(_leaves(fresh.trainer), _leaves(est.trainer))


# -- file_io retry envelope ---------------------------------------------

def test_file_io_retries_transient(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FILE_RETRY_BACKOFF_S", "0.001")
    monkeypatch.setenv("ZOO_TPU_FAULT", "file-io:transient@2")
    faults.reset()
    p = str(tmp_path / "x.bin")
    file_io.write_bytes(p, b"payload")
    assert file_io.read_bytes(p) == b"payload"


def test_file_io_retry_exhausted_is_typed(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FILE_RETRY_BACKOFF_S", "0.001")
    monkeypatch.setenv("ZOO_TPU_FAULT", "file-io:transient@99")
    faults.reset()
    with pytest.raises(FileIORetryExhausted) as ei:
        file_io.write_bytes(str(tmp_path / "y.bin"), b"data")
    assert ei.value.attempts == 4
    assert isinstance(ei.value.__cause__, TransientFault)


def test_file_io_permanent_error_not_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FILE_RETRY_BACKOFF_S", "5.0")
    with pytest.raises(FileNotFoundError):
        file_io.read_bytes(str(tmp_path / "missing.bin"))


# -- formats against the JAX package -------------------------------------

def test_crc32c_matches_jax():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    rs = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000, 65537):
        data = rs.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jcrc.crc32c(data)
        assert crc32c.crc32c(data) == want == crc32c.crc32c_reference(data)
        assert crc32c.masked_crc(data) == jcrc.masked_crc(data)
        assert crc32c.crc32c(data[n // 2:], crc32c.crc32c(data[:n // 2])) \
            == want


def test_pytree_files_read_across_packages():
    rs = np.random.default_rng(1)
    tree = {"params": {"dense_1": {"kernel": rs.standard_normal((3, 2)),
                                   "bias": np.zeros(2, np.float32)},
                       "bert_2": {"block0": {"qkv_w": np.ones((2, 6))}}},
            "state": {}, "meta": [np.asarray(3), (np.int32(4), 2.5)]}
    port_bytes = serialization.pytree_bytes(tree)
    jax_bytes = jser.pytree_bytes(tree)
    for got in (jser.pytree_from_bytes(*port_bytes),
                serialization.pytree_from_bytes(*jax_bytes),
                serialization.pytree_from_bytes(*port_bytes)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(jser.pytree_from_bytes(*jax_bytes))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    # the same tree gives the same bytes every time
    assert serialization.pytree_bytes(tree) == port_bytes
    leaves = [np.arange(6.0).reshape(2, 3), np.asarray(7, np.int32)]
    got = jser.leaves_from_bytes(serialization.leaves_bytes(leaves), leaves)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)


def test_tensorboard_events_read_across_packages(tmp_path):
    w = tensorboard.TrainSummary(str(tmp_path), "port")
    w.add_scalar("Loss", 0.25, 3)
    w.add_scalar("Loss", 0.125, 6)
    w.close()
    j = jtb.ValidationSummary(str(tmp_path), "jax")
    j.add_scalar("Top1Accuracy", 0.5, 7)
    j.close()
    port_dir = str(tmp_path / "port" / "train")
    jax_dir = str(tmp_path / "jax" / "validation")
    assert [(s, t, v) for s, _, t, v in jtb.read_scalars(port_dir)] == \
        [(3, "Loss", 0.25), (6, "Loss", 0.125)]
    assert [(s, t, v) for s, _, t, v in tensorboard.read_scalars(jax_dir)] \
        == [(7, "Top1Accuracy", 0.5)]


@pytest.mark.parametrize("key,kw", OPTIMIZERS)
def test_optimizer_leaves_are_optax_leaves(key, kw):
    """After 3 updates, every optimizer's state as the port writes it
    (``optimizer_leaves``) equals optax's ``tree_leaves`` in order, dtype
    and value (1e-6: the port's float64 host schedules), and loading
    optax's leaves back into the port reproduces them."""
    rs = np.random.default_rng(0)
    params = {"zeta": {"kernel": rs.standard_normal((3, 4))},
              "alpha": {"kernel": rs.standard_normal((2,)),
                        "bias": rs.standard_normal((4,))}}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    flat = {f"{l}.{k}": v for l, d in params.items() for k, v in d.items()}
    order = sorted(flat, key=lambda p: tuple(p.split(".")))
    jtx = _build_optimizer(jopt, key, kw).to_optax()
    ttx = _build_optimizer(topt, key, kw).transformation()
    jp = jax.tree.map(jax.numpy.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rs.standard_normal(a.shape) * 2.0)
                         .astype(np.float32), params)
        ju, jstate = jtx.update(jax.tree.map(jax.numpy.asarray, g), jstate,
                                jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update({f"{l}.{k}": torch.from_numpy(v) for l, d
                                 in g.items() for k, v in d.items()},
                                tstate, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
    got = [np.asarray(l.numpy() if torch.is_tensor(l) else l)
           for l in optimizer_leaves(tstate, order)]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=1e-6)
    # optax's leaves load back into a fresh port state
    fresh = ttx.init({k: torch.zeros_like(v) for k, v in tp.items()})
    fresh = load_optimizer_leaves(fresh, want, order)
    for g_, w_ in zip(optimizer_leaves(fresh, order), want):
        np.testing.assert_array_equal(np.asarray(
            g_.numpy() if torch.is_tensor(g_) else g_), w_)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The small BERT classifier trains 3 Adam steps in JAX with a
    checkpoint; the port (its own layer names) restores it and trains the
    next epoch's 3 steps: losses and Adam moments within 1e-5 of JAX
    continuing (dropout off, float32)."""
    _classifier("torch")    # the port's layer counters move on
    jmodel, tmodel = _classifier("jax"), _classifier("torch")
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path / "tb"), "jax")
    jmodel.set_checkpoint(str(tmp_path / "ckpt"),
                          trigger=JSeveralIteration(3))
    x, y = _bert_data(0, 12)
    jmodel.fit(x, y, batch_size=4, nb_epoch=1)
    assert (tmp_path / "ckpt" / "latest").read_text() == "ckpt-3"
    shutil.copytree(tmp_path / "ckpt", tmp_path / "at3")
    jmodel.fit(x, y, batch_size=4, nb_epoch=1)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")][3:]
    assert len(jlosses) == 3
    assert {l.name for l in tmodel.graph_function().layers} != \
        set(jmodel.get_params())

    trainer = tmodel._ensure_trainer()
    trainer.load_checkpoint(str(tmp_path / "at3"))
    assert (trainer.step, trainer.epoch, trainer.epoch_batches) == (3, 1, 0)
    tmodel.fit(x, y, batch_size=4, nb_epoch=1)
    np.testing.assert_allclose(trainer.step_losses, jlosses, rtol=0,
                               atol=1e-5)
    jstate = jmodel.trainer.opt_state
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
    names = list(jax.tree.map(np.asarray, jmodel.get_params()))
    got = optimizer_leaves(trainer.opt_state, param_order(tmodel, names))
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        g_ = np.asarray(g_.detach().numpy() if torch.is_tensor(g_) else g_)
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-5)


def test_summaries_hold_one_loss_per_window(tmp_path):
    """``set_tensorboard``: one Loss (and LearningRate, Throughput,
    StepTimeMs) per ``log_every_n_steps`` window, each equal to the step
    loss it names; GradNorm where L2-norm clipping computes it and
    ``log_grad_norm`` is set; a validation scalar each epoch. JAX's
    trainer writes the same tags at the same steps: the memory
    accountant's HBM*MB and the infeed scalars too."""
    _ctx(log_every_n_steps=2, log_grad_norm=True)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=2,
                                                   log_grad_norm=True)))
    x, y = _xy()
    tags = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            model = Sequential()
            model.add(tl.Dense(8, activation="relu", input_shape=(4,)))
            model.add(tl.Dense(1))
        else:
            model = JSequential()
            model.add(jl.Dense(8, activation="relu", input_shape=(4,)))
            model.add(jl.Dense(1))
        model.compile(optimizer="sgd", loss="mse", metrics=["mae"])
        model.set_gradient_clipping_by_l2_norm(1.0)
        model.set_tensorboard(str(tmp_path), pkg)
        model.fit(x, y, batch_size=16, nb_epoch=2, validation_data=(x, y))
        tags[pkg] = sorted({(t, s) for s, _, t, _ in
                            model.get_train_summary()})
        val = model.get_validation_summary()
        assert sorted({(t, s) for s, _, t, _ in val
                       if t in ("loss", "mae")}) == \
            [("loss", 4), ("loss", 8), ("mae", 4), ("mae", 8)]
        if pkg == "port":
            losses = model.trainer.step_losses
            summary = model.get_train_summary("Loss")
            assert [s for s, _, _, _ in summary] == [2, 4, 6, 8]
            for step, _, _, value in summary:
                assert value == np.float32(losses[step - 1])
    assert {t for t, _ in tags["port"]} == {t for t, _ in tags["jax"]}
    assert {"Loss", "LearningRate", "GradNorm", "Throughput",
            "StepTimeMs"} <= {t for t, _ in tags["port"]}
    assert [s for t, s in tags["port"] if t == "Loss"] == \
        [s for t, s in tags["jax"] if t == "Loss"]


# -- the Estimator ---------------------------------------------------------

def test_estimator_with_multi_optimizer_matches_jax():
    """``Estimator`` over a ``MultiOptimizer`` (SGD with momentum on one
    layer, Adam on the other) trains, evaluates and predicts as JAX's
    from copied weights: parameters and predictions within 1e-5, the
    optimizer state's leaves equal to ``optax.multi_transform``'s in
    order and within 1e-5."""
    from analytics_zoo_tpu.pipeline.estimator.estimator import \
        MultiOptimizer as JMultiOptimizer
    from analytics_zoo_tpu_torch.pipeline.estimator import MultiOptimizer
    x, y = _xy()
    model = Sequential()
    model.add(tl.Dense(8, activation="relu", input_shape=(4,),
                       name="est_a"))
    model.add(tl.Dense(1, name="est_b"))
    model.graph_function()
    init = {k: p.detach().numpy().copy()
            for k, p in model.named_parameters()}
    est = Estimator(model, MultiOptimizer(
        {"est_a": topt.SGD(lr=0.1, momentum=0.9),
         "est_b": topt.Adam(lr=1e-2)}))
    jmodel = JSequential()
    jmodel.add(jl.Dense(8, activation="relu", input_shape=(4,),
                        name="est_a"))
    jmodel.add(jl.Dense(1, name="est_b"))
    jest = JEstimator(jmodel, JMultiOptimizer(
        {"est_a": jopt.SGD(lr=0.1, momentum=0.9),
         "est_b": jopt.Adam(lr=1e-2)}))
    jest._ensure_trainer(jobj.get_loss("mse"), None)
    jest.trainer.set_params(
        {l: {"kernel": init[f"{l}.kernel"], "bias": init[f"{l}.bias"]}
         for l in ("est_a", "est_b")}, {})
    for e, fs, trig in ((est, ArrayFeatureSet(x, y), MaxIteration(6)),
                        (jest, JArrayFeatureSet(x, y), JMaxIteration(6))):
        e.train(fs, "mse", end_trigger=trig, batch_size=8)
    want = jax.tree.map(np.asarray, jest.trainer.params)
    for k, p in model.named_parameters():
        layer, leaf = k.split(".")
        np.testing.assert_allclose(p.detach().numpy(), want[layer][leaf],
                                   rtol=0, atol=1e-5, err_msg=k)
    jres = jest.evaluate(JArrayFeatureSet(x, y), ["mae"], batch_size=16)
    tres = est.evaluate(ArrayFeatureSet(x, y), ["mae"], batch_size=16)
    assert set(tres) == set(jres)
    for k in tres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        est.predict(x, batch_size=16),
        np.asarray(jest.predict(JArrayFeatureSet(x), batch_size=16)),
        rtol=0, atol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jest.trainer.opt_state)
    tleaves = optimizer_leaves(est.trainer.opt_state, param_order(model))
    assert len(tleaves) == len(jleaves)
    for g_, w_ in zip(tleaves, jleaves):
        g_ = np.asarray(g_.detach().numpy() if torch.is_tensor(g_) else g_)
        assert g_.shape == np.shape(w_)
        np.testing.assert_allclose(g_, np.asarray(w_), rtol=0, atol=1e-5)
