"""The port's training observability against the JAX package on the CPU:
the health monitor, the infeed monitor, the memory accountant, the step
FLOP count, the NaN poison sites and the halt ladder, OOM forensics, the
``train_cli`` reader and the trace merge.

The model is bench.py's BERT classifier at a small size: 2 blocks, 64
wide, one head (d = 64, the kernel route), seq 32, batch 4, dropout off,
the port holding the JAX model's weights (``load_jax_params``). Token,
position and segment ids are int32 and the mask float32 (the card's
layout), so ``step:nan@N`` poisons the mask alone in both packages.

Tolerances:
- the health and infeed streams: states, alerts and windows equal;
  z-scores within 1e-12 (the same float64 arithmetic in both);
- byte counts: exact;
- the step FLOP count: within 1% of bench.py's formula (both count
  model FLOPs: three times the forward's matmuls, no recomputation);
- losses of a monitored ``fit``: 1e-5 a step (the training tolerance of
  ``tests/test_torch_training.py``), parameters in the restored
  checkpoint 1e-5.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.common.zoo_trigger import \
    SeveralIteration as JSeveralIteration
from analytics_zoo_tpu.pipeline import engine as jengine
from analytics_zoo_tpu.pipeline import health as jhealth
from analytics_zoo_tpu.pipeline import train_cli as jcli
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu.utils import faults as jfaults
from analytics_zoo_tpu.utils import memory as jmemory
from analytics_zoo_tpu.utils import profiling as jprof
from analytics_zoo_tpu.utils import telemetry as jtel
from analytics_zoo_tpu.utils import trace_merge as jmerge
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.common.zoo_trigger import SeveralIteration
from analytics_zoo_tpu_torch.pipeline import engine as tengine
from analytics_zoo_tpu_torch.pipeline import health as thealth
from analytics_zoo_tpu_torch.pipeline import train_cli as tcli
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
    Sequential as TSequential
from analytics_zoo_tpu_torch.utils import faults as tfaults
from analytics_zoo_tpu_torch.utils import memory as tmemory
from analytics_zoo_tpu_torch.utils import profiling as tprof
from analytics_zoo_tpu_torch.utils import serialization as tser
from analytics_zoo_tpu_torch.utils import telemetry as ttel
from analytics_zoo_tpu_torch.utils import trace_merge as tmerge
from analytics_zoo_tpu_torch.utils import load_jax_params

L, HID, VOCAB, BATCH, BLOCKS = 32, 64, 50, 4, 2
PEAK = 1e12
_ENV = ("ZOO_TPU_FAULT", "ZOO_TPU_FAULT_STATE", "ZOO_TPU_TELEMETRY",
        "ZOO_TPU_TRACE_DIR", "ZOO_TPU_TELEMETRY_SERVICE",
        "ZOO_TPU_PEAK_FLOPS", "ZOO_TPU_AUTO_RESUME")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for mod in (jfaults, tfaults):
        mod.reset()
    for mod in (jtel, ttel, jmemory, tmemory):
        mod.reset_for_tests()
    jengine.clear_preemption()
    tengine.clear_preemption()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    torch.set_num_threads(threads)
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    jengine.clear_preemption()
    tengine.clear_preemption()
    for mod in (jfaults, tfaults):
        mod.reset()
    for mod in (jtel, ttel, jmemory, tmemory):
        mod.reset_for_tests()


# ---------------------------------------------------------------------------
# the health and infeed streams
# ---------------------------------------------------------------------------

def _streams(seed, n=40):
    """Seeded window scalars: noisy loss, grad-norm and step-time streams
    with spikes, a slow-window pair and a non-finite loss late on."""
    rs = np.random.default_rng(seed)
    loss = 2.0 * np.exp(-np.arange(n) / 20) + 0.01 * rs.standard_normal(n)
    gnorm = 1.0 + 0.05 * rs.standard_normal(n)
    step_ms = 70.0 + rs.standard_normal(n)
    loss[17] += 1.5                      # a loss spike
    gnorm[25] *= 40.0                    # a grad-norm spike
    step_ms[30:32] *= 3.0                # two slow windows in a row
    step_ms[12] *= 3.0                   # one slow window: no alert
    if seed % 2:
        loss[36] = np.nan
    return loss, gnorm, step_ms


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ewma_std_streams_match_jax(seed):
    rs = np.random.default_rng(seed)
    xs = np.cumsum(rs.standard_normal(200)) + 5.0
    alpha = [0.1, 0.25, 0.5, 1.0][seed]
    j, t = jprof.EwmaStd(alpha=alpha, min_samples=3), \
        tprof.EwmaStd(alpha=alpha, min_samples=3)
    for x in xs:
        zj, zt = j.zscore(x), t.zscore(x)
        assert abs(zj - zt) <= 1e-12
        assert j.update(x) == t.update(x)
    assert (j.mean, j.var, j.n) == (t.mean, t.var, t.n)


def _alerts(mon):
    return [{k: v for k, v in a.items() if k != "ts"} for a in mon.alerts]


@pytest.mark.parametrize("halt", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_monitor_streams_match_jax(seed, halt):
    loss, gnorm, step_ms = _streams(seed)
    mons = {"jax": jhealth.HealthMonitor(z_threshold=4.0, warmup_windows=3,
                                         halt=halt),
            "port": thealth.HealthMonitor(z_threshold=4.0,
                                          warmup_windows=3, halt=halt)}
    trace = {k: [] for k in mons}
    for i in range(len(loss)):
        for name, mon in mons.items():
            if i == 33:
                mon.on_nonfinite(i * 4, signal="sentinel")
            mon.observe_window(i * 4, loss=loss[i], grad_norm=gnorm[i],
                               step_time_ms=step_ms[i])
            trace[name].append((mon.state, mon.halted, mon.halt_step))
    assert trace["jax"] == trace["port"]
    ja, ta = _alerts(mons["jax"]), _alerts(mons["port"])
    assert [{k: v for k, v in a.items() if k != "z"} for a in ja] == \
        [{k: v for k, v in a.items() if k != "z"} for a in ta]
    for a, b in zip(ja, ta):
        if "z" in a:
            assert abs(a["z"] - b["z"]) <= 1e-12
    assert {a["kind"] for a in ta} >= {"spike", "nonfinite"}
    assert mons["jax"].summary()["state"] == mons["port"].summary()["state"]
    assert jengine.preemption_requested() == \
        tengine.preemption_requested() == halt


@pytest.mark.parametrize("seed", [0, 1])
def test_infeed_monitor_windows_match_jax(seed):
    rs = np.random.default_rng(seed)
    j, t = jprof.InfeedMonitor(scope="train"), \
        tprof.InfeedMonitor(scope="train")
    for _ in range(6):
        for w in rs.uniform(0, 2e-3, size=rs.integers(1, 9)):
            j.input_wait(w)
            t.input_wait(w)
        steps, wall = int(rs.integers(1, 9)), float(rs.uniform(1e-3, 0.5))
        assert j.window(steps, wall) == t.window(steps, wall)
    assert j.total_wait == t.total_wait
    n, s, w = 7, 25, 0.125
    assert jprof.inference_window(j, n, s, w, 0, "Eval") == \
        tprof.inference_window(t, n, s, w, 0, "Eval")


def test_device_sync_walks_to_the_first_tensor(monkeypatch):
    """The barrier is ``torch.cuda.synchronize`` on the device of the
    first tensor of the tree (none for a CPU tensor or an empty tree)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    tprof.device_sync({"a": [torch.ones(2)], "b": None})
    tprof.device_sync([])
    assert calls == []


def test_peak_flops_table_and_override(monkeypatch):
    assert tprof.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert tprof.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tprof.peak_flops("cpu") is None
    monkeypatch.setenv("ZOO_TPU_PEAK_FLOPS", "2.5e12")
    assert tprof.peak_flops("cpu") == 2.5e12
    assert tprof.device_kind("cpu") == "cpu"


# ---------------------------------------------------------------------------
# the small BERT classifier in both packages
# ---------------------------------------------------------------------------

def _classifier(pkg):
    """bench.py's classifier at a small size, named layers (the memory
    groups and checkpoints pair by name), dropout off."""
    layers = jl if pkg == "jax" else tl
    bert_cls = jsa.BERT if pkg == "jax" else tl.BERT
    bert = bert_cls(vocab=VOCAB, hidden_size=HID, n_block=BLOCKS, n_head=1,
                    seq_len=L, intermediate_size=4 * HID, hidden_p_drop=0.0,
                    attn_p_drop=0.0, output_all_block=False, name="obs_bert")
    ins = [layers.Input(shape=(L,), name="tokens"),
           layers.Input(shape=(L,), name="positions"),
           layers.Input(shape=(L,), name="segments"),
           layers.Input(shape=(1, 1, L), name="mask")]
    _, pooled = bert(ins)
    probs = layers.Dense(2, activation="softmax", name="obs_head")(pooled)
    model = (JModel if pkg == "jax" else TModel)(ins, probs)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


def _data(seed, n):
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
    return x, labels.astype(np.float32)


def _pair(logdir=None, ckpt=None, ckpt_every=2, **cfg):
    """The two models with the port holding JAX's initial weights and a
    context in each package from the same config fields; with ``logdir``
    a TrainSummary each (apps "jax" and "port"), attached before JAX's
    trainer is built; with ``ckpt`` a checkpoint every ``ckpt_every``
    steps into its "jax" and "port" subdirectories."""
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(**cfg)))
    jmodel, tmodel = _classifier("jax"), _classifier("torch")
    if logdir is not None:
        jmodel.set_tensorboard(logdir, "jax")
        tmodel.set_tensorboard(logdir, "port")
    if ckpt is not None:
        jmodel.set_checkpoint(os.path.join(ckpt, "jax"),
                              trigger=JSeveralIteration(ckpt_every))
        tmodel.set_checkpoint(os.path.join(ckpt, "port"),
                              trigger=SeveralIteration(ckpt_every))
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    tnn.set_nncontext(None)
    tnn.init_nncontext(tnn.ZooConfig.from_env(**cfg), device="cpu")
    return jmodel, tmodel


def _bench_flops(batch, seq, hidden, blocks, n_classes):
    """bench.py's ``_bert_flops_per_step`` (bench.py:357-367), copied."""
    tokens = batch * seq
    dense = 2 * hidden * (3 * hidden + hidden + 8 * hidden)
    attn = 4 * seq * hidden
    fwd = tokens * blocks * (dense + attn)
    fwd += batch * 2 * hidden * hidden
    fwd += batch * 2 * hidden * n_classes
    return 3 * fwd


MONITORED = dict(log_every_n_steps=2, health_monitor=True,
                 memory_accounting=True)


def _fit_both(tmp_path, monkeypatch, epochs=2, n=16, **cfg):
    monkeypatch.setenv("ZOO_TPU_PEAK_FLOPS", str(PEAK))
    jmodel, tmodel = _pair(str(tmp_path / "logs"), **dict(MONITORED, **cfg))
    x, y = _data(0, n)
    jmodel.fit(x, y, batch_size=BATCH, nb_epoch=epochs)
    tmodel.fit(x, y, batch_size=BATCH, nb_epoch=epochs)
    return jmodel, tmodel


def test_monitored_fit_matches_jax_losses_and_tags(tmp_path, monkeypatch):
    """With the monitor, the accountant and MFU on, the port's step losses
    follow JAX's ``fit`` step for step (a window every step, so JAX logs
    each loss) and its TrainSummary holds JAX's tag set."""
    jmodel, tmodel = _fit_both(tmp_path, monkeypatch, log_every_n_steps=1)
    jloss = {s: v for s, _, _, v in jmodel.get_train_summary("Loss")}
    tlosses = tmodel.trainer.step_losses
    assert len(tlosses) == 8 and sorted(jloss) == list(range(1, 9))
    for step, v in jloss.items():
        assert abs(tlosses[step - 1] - v) <= 1e-5
    jtags = {t for _, _, t, _ in jmodel.get_train_summary()}
    ttags = {t for _, _, t, _ in tmodel.get_train_summary()}
    assert ttags == jtags
    assert {"HealthState", "HBMTotalMB", "HBMParamsMB", "HBMOptStateMB",
            "HBMActivationsMB", "HBMTransfersMB", "InfeedWaitMs",
            "InputBoundFraction", "MFU"} <= ttags
    for s, _, t, v in tmodel.get_train_summary():
        assert np.isfinite(v), (t, s)
        if t == "HealthState":
            assert v == 0.0
    # MFU is the counted FLOPs over the window's wall over the peak
    tr = tmodel.trainer
    mfu = {s: v for s, _, _, v in tmodel.get_train_summary("MFU")}
    st = {s: v for s, _, _, v in tmodel.get_train_summary("StepTimeMs")}
    for s in mfu:
        want = tr.flops_per_step / (st[s] * 1e-3) / PEAK
        assert mfu[s] == pytest.approx(want, rel=1e-5)
    assert ttel.counter("zoo_train_steps_total").value == 8


def test_step_flops_match_bench_formula(tmp_path, monkeypatch):
    """The counted FLOPs a step against bench.py's formula (1%); JAX's
    ``cost_analysis()`` count, which adds elementwise work and the
    interpret-mode kernels' own, beside it (ROADMAP C)."""
    jmodel, tmodel = _fit_both(tmp_path, monkeypatch, epochs=1, n=8)
    want = _bench_flops(BATCH, L, HID, BLOCKS, 2)
    got = tmodel.trainer.flops_per_step
    assert got == pytest.approx(want, rel=0.01)
    jflops = jmodel.trainer.flops_per_step
    print(f"\nstep FLOPs: port {got:.6g}, bench.py {want:.6g}, JAX "
          f"cost_analysis {jflops:.6g} ({jflops / got:.3f}x)")
    assert jflops > got


def test_memory_bytes_match_jax(tmp_path, monkeypatch):
    """Parameter bytes, optimizer-state bytes and the optimizer state by
    parameter group: exactly JAX's accountant's; the saved activations
    and transfers measured and positive."""
    _fit_both(tmp_path, monkeypatch, epochs=1, n=8)
    jbd = jmemory.program_breakdowns()["train"]
    tbd = tmemory.program_breakdowns()["train"]
    for key in ("params_bytes", "opt_state_bytes",
                "opt_state_per_device_bytes"):
        assert tbd[key] == jbd[key], key
    assert tbd["opt_state_groups"] == jbd["opt_state_groups"]
    assert set(tbd["opt_state_groups"]) == {"obs_bert", "obs_head",
                                            "_other"}
    assert tbd["activations_temp_bytes"] > 0
    # the batch's ids and mask plus labels and weights, and the loss
    x, y = _data(0, BATCH)
    moved = sum(a.nbytes for a in x) + BATCH * 4 * 2 + 4
    assert tbd["transfers_bytes"] == moved
    assert tbd["total_bytes"] == tbd["params_bytes"] + \
        tbd["opt_state_bytes"] + tbd["activations_temp_bytes"] + moved
    assert tbd["step_peak_bytes"] is None       # no allocator on the CPU
    assert tmemory.poll_device_memory([torch.device("cpu")]) is None


def test_saved_activation_bytes_count_each_storage_once():
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    with tmemory.StepAccountant("cpu", exclude=[w]) as acc:
        h = torch.tanh(x @ w)          # saves x (w excluded) and tanh's out
        (h * h).sum().backward()       # h saved once for both operands
    assert acc.saved_bytes == x.nbytes + h.nbytes


def _halt_run(pkg, tmp_path, fault, n=16, epochs=2, log_every=2,
              ckpt_every=2):
    """A ``fit`` of ``epochs`` epochs of ``n`` samples (4 a step) with a
    window every ``log_every`` steps, a checkpoint every ``ckpt_every``
    and the fault armed; returns (health monitor, checkpoint dir, latest
    checkpoint's name)."""
    cfg = dict(log_every_n_steps=log_every, health_monitor=True,
               health_halt=True, failure_retry_times=0)
    os.environ["ZOO_TPU_FAULT"] = fault
    try:
        jmodel, tmodel = _pair(ckpt=str(tmp_path), ckpt_every=ckpt_every,
                               **cfg)
        model = jmodel if pkg == "jax" else tmodel
        x, y = _data(0, n)
        directory = str(tmp_path / pkg)
        halted = (jengine if pkg == "jax" else tengine).TrainingHalted
        with pytest.raises(halted):
            model.fit(x, y, batch_size=BATCH, nb_epoch=epochs)
        with open(os.path.join(directory, "latest")) as f:
            latest = f.read().strip()
        return model.trainer._health, directory, latest
    finally:
        os.environ.pop("ZOO_TPU_FAULT", None)


def test_step_nan_halt_keeps_the_last_good_checkpoint(tmp_path):
    """``step:nan@3`` with ``health_halt``: both raise TrainingHalted with
    halt step 3, ``latest`` at ckpt-2, its parameters within 1e-5 of
    JAX's and finite; the drain flag is cleared."""
    jh, jdir, jlatest = _halt_run("jax", tmp_path, "step:nan@3")
    th, tdir, tlatest = _halt_run("port", tmp_path, "step:nan@3")
    assert jh.halt_step == th.halt_step == 3
    assert jlatest == tlatest == "ckpt-2"
    assert [a["signal"] for a in _alerts(th)] == \
        [a["signal"] for a in _alerts(jh)]
    assert not tengine.preemption_requested()
    jp = tser.load_pytree(os.path.join(jdir, jlatest, "model.npz"))
    tp = tser.load_pytree(os.path.join(tdir, tlatest, "model.npz"))
    jflat, tflat = _flat(jp["params"]), _flat(tp["params"])
    assert set(jflat) == set(tflat)
    for k in jflat:
        assert np.all(np.isfinite(tflat[k])), k
        np.testing.assert_allclose(tflat[k], jflat[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_halt_latched_after_the_last_window_raises(tmp_path):
    """``step:nan@3`` in one epoch of 3 steps, windows and checkpoints
    every 2: no window or save reads the sentinel after step 3, so the
    epoch end's read latches the halt. The port raises TrainingHalted
    there as JAX does at step 3, ``latest`` stays at ckpt-2 and the drain
    flag is cleared, so a later ``fit`` in the process is not drained
    into a poisoned checkpoint."""
    kw = dict(n=12, epochs=1, log_every=2, ckpt_every=2)
    jh, jdir, jlatest = _halt_run("jax", tmp_path, "step:nan@3", **kw)
    th, tdir, tlatest = _halt_run("port", tmp_path, "step:nan@3", **kw)
    assert jh.halt_step == th.halt_step == 3
    assert jlatest == tlatest == "ckpt-2"
    assert [a["signal"] for a in _alerts(th)] == \
        [a["signal"] for a in _alerts(jh)]
    assert not tengine.preemption_requested()
    # ckpt-2 is the step-2 state bit for bit: the same fit without the
    # fault saves the same parameters there
    _, clean = _pair(ckpt=str(tmp_path / "clean"), ckpt_every=2,
                     log_every_n_steps=2)
    x, y = _data(0, 12)
    clean.fit(x, y, batch_size=BATCH, nb_epoch=1)
    want = _flat(tser.load_pytree(os.path.join(
        str(tmp_path / "clean" / "port"), "ckpt-2", "model.npz"))["params"])
    got = _flat(tser.load_pytree(os.path.join(tdir, tlatest,
                                              "model.npz"))["params"])
    assert set(got) == set(want)
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_grad_nan_latches_fault_like_jax(tmp_path, monkeypatch):
    """``grad:nan@3`` without halt: state 2 (fault), the same alerts as
    JAX's, and ``fit`` runs to its end."""
    monkeypatch.setenv("ZOO_TPU_FAULT", "grad:nan@3")
    jmodel, tmodel = _fit_both(tmp_path, monkeypatch)
    jh, th = jmodel.trainer._health, tmodel.trainer._health
    assert th.state == jh.state == thealth.STATE_FAULT
    assert not th.halted
    assert [(a["kind"], a["signal"], a["step"]) for a in _alerts(th)] == \
        [(a["kind"], a["signal"], a["step"]) for a in _alerts(jh)]
    assert tmodel.trainer.step == 8
    assert {s: v for s, _, _, v in tmodel.get_train_summary("HealthState")
            } == {s: v for s, _, _, v in
                  jmodel.get_train_summary("HealthState")}


def _nan_grad_loss(pkg):
    """Squared error plus ``sqrt(square(0 * p))``: the value stays finite
    (the second term is 0) while every gradient is NaN (inf times 0), so
    only the grad-norm check sees step 1; step 2's loss is NaN."""
    if pkg == "jax":
        import jax.numpy as jnp

        return lambda p, t: jnp.sum(jnp.square(p - t), -1) + \
            jnp.sum(jnp.sqrt(jnp.square(0.0 * p)), -1)
    return lambda p, t: torch.sum(torch.square(p - t), -1) + \
        torch.sum(torch.sqrt(torch.square(0.0 * p)), -1)


@pytest.mark.parametrize("grad_sentinel", [True, False])
def test_grad_sentinel_without_clipping_matches_jax(grad_sentinel):
    """``health_grad_sentinel`` without clipping: the extra global norm
    catches a NaN gradient under a finite loss at step 1; without it the
    halt waits for step 2's NaN loss. Same halt step, state and alerts as
    JAX."""
    cfg = dict(log_every_n_steps=2, health_monitor=True, health_halt=True,
               health_grad_sentinel=grad_sentinel, failure_retry_times=0)
    rs = np.random.default_rng(3)
    x = rs.standard_normal((16, 3)).astype(np.float32)
    y = rs.standard_normal((16, 1)).astype(np.float32)
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(**cfg)))
    tnn.init_nncontext(tnn.ZooConfig(**cfg), device="cpu")
    monitors = {}
    for pkg, layers, halted in (("jax", jl, jengine.TrainingHalted),
                                ("port", tl, tengine.TrainingHalted)):
        model = (JSequential if pkg == "jax" else TSequential)()
        model.add(layers.Dense(4, input_shape=(3,), activation="tanh"))
        model.add(layers.Dense(1))
        model.compile(optimizer="adam", loss=_nan_grad_loss(pkg))
        with pytest.raises(halted):
            model.fit(x, y, batch_size=BATCH, nb_epoch=1)
        monitors[pkg] = model.trainer._health
    jh, th = monitors["jax"], monitors["port"]
    assert jh.halt_step == th.halt_step == (1 if grad_sentinel else 2)
    assert th.state == jh.state == thealth.STATE_HALTED
    assert [(a["kind"], a["signal"], a["step"]) for a in _alerts(th)] == \
        [(a["kind"], a["signal"], a["step"]) for a in _alerts(jh)]
    assert not tengine.preemption_requested()


def test_eval_and_predict_activations_are_not_measured(tmp_path):
    """evaluate and predict run without autograd, so nothing is saved for
    backward: their breakdowns say not measured (None), not 0."""
    ttel.configure(enabled=True, trace_dir=str(tmp_path))
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig()))
    tmodel = _classifier("torch")
    tnn.init_nncontext(tnn.ZooConfig(memory_accounting=True), device="cpu")
    x, y = _data(2, 8)
    tmodel.evaluate(x, y, batch_size=BATCH)
    tmodel.predict(x, batch_size=BATCH)
    bds = tmemory.program_breakdowns()
    for program in ("eval", "predict"):
        bd = bds[program]
        assert bd["activations_temp_bytes"] is None, program
        assert bd["total_bytes"] == bd["params_bytes"] + \
            bd["transfers_bytes"], program


def test_no_sentinel_read_between_windows(tmp_path, monkeypatch):
    """The sentinel is read at windows, epoch ends and checkpoint saves,
    not a step: 8 steps, windows of 4, one epoch: 3 reads (two windows
    and the epoch end)."""
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig()))
    tmodel = _classifier("torch")
    tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=4,
                                     health_monitor=True), device="cpu")
    reads = []
    real = tengine.SPMDTrainer._read_sentinel

    def counted(self):
        reads.append(self.step)
        return real(self)

    monkeypatch.setattr(tengine.SPMDTrainer, "_read_sentinel", counted)
    x, y = _data(1, 32)
    tmodel.fit(x, y, batch_size=BATCH, nb_epoch=1)
    assert reads == [4, 8, 8]


def test_oom_forensics_payload_matches_jax(tmp_path):
    jpath = jmemory.oom_forensics("test", out_dir=str(tmp_path / "j"))
    tpath = tmemory.oom_forensics("test", out_dir=str(tmp_path / "t"))
    with open(jpath) as f:
        jkeys = set(json.load(f))
    with open(tpath) as f:
        tkeys = set(json.load(f))
    assert tkeys == jkeys
    assert tmemory.maybe_oom_forensics(
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        out_dir=str(tmp_path / "t")) is not None
    assert tmemory.maybe_oom_forensics(
        RuntimeError("shape mismatch"), out_dir=str(tmp_path / "t")) is None
    assert len(os.listdir(tmp_path / "t" / "debug")) == 2


def test_train_cli_reads_either_packages_logs(tmp_path, monkeypatch,
                                              capsys):
    """Each package's ``train_cli`` reads the other's TrainSummary the way
    it reads its own: the same latest scalars, the same status lines."""
    _fit_both(tmp_path, monkeypatch, epochs=1, n=8)
    for app in ("jax", "port"):
        d = str(tmp_path / "logs" / app)
        assert tcli.read_latest_scalars(d) == jcli.read_latest_scalars(d)
        assert tcli.render_status(d, None) == jcli.render_status(d, None)
        assert tcli.main(["summary", "--logdir", d]) == 0
        got = json.loads(capsys.readouterr().out)
        assert jcli.main(["summary", "--logdir", d]) == 0
        assert json.loads(capsys.readouterr().out) == got
        assert {"MFU", "HBMParamsMB", "HealthState"} <= set(got["scalars"])
    status = tcli.render_status(str(tmp_path / "logs" / "port"), None)
    assert any("MFU" in line for line in status)
    assert any(line.strip().startswith("HBM") for line in status)
    assert any("health: OK" in line for line in status)


def test_trace_merge_matches_jax(tmp_path):
    """The same trace files merge to the same JSON in both packages: the
    port's telemetry trace of a monitored fit, a second process's file
    and a profiler-style trace given as ``--extra``."""
    trace_dir = tmp_path / "trace"
    ttel.configure(enabled=True, trace_dir=str(trace_dir))
    try:
        with ttel.span("train/step", step=0):
            ttel.event("train/mark")
        path = ttel.write_trace()
    finally:
        ttel.reset_for_tests()
    other = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 7, "tid": 0,
         "args": {"name": "worker"}},
        {"name": "train/step", "ph": "B", "pid": 7, "tid": 1, "ts": 5},
        {"name": "train/step", "ph": "E", "pid": 7, "tid": 1, "ts": 9}]}
    with open(trace_dir / "trace-7.json", "w") as f:
        json.dump(other, f)
    prof = tmp_path / "prof"
    prof.mkdir()
    kern = {"traceEvents": [{"name": "flash_fwd_kernel", "ph": "X",
                             "pid": 0, "tid": 7, "ts": 3, "dur": 2}]}
    with open(prof / "trace-torch-profiler-1-2.json", "w") as f:
        json.dump(kern, f)
    extra = [str(prof / "trace-torch-profiler-1-2.json")]
    assert tmerge.merge_trace_dir(str(trace_dir)) == \
        jmerge.merge_trace_dir(str(trace_dir))
    got = tmerge.merge_trace_dir(str(trace_dir), extra_files=extra)
    assert got == jmerge.merge_trace_dir(str(trace_dir), extra_files=extra)
    assert sum(1 for e in got["traceEvents"]
               if e.get("name") == "train/step" and e["ph"] == "B") == 2
    out = tmp_path / "merged.json"
    assert tmerge.main(["merge", "--dir", str(trace_dir), "--extra",
                        str(prof), "-o", str(out)]) == 0
    with open(out) as f:
        assert json.load(f) == got
    assert os.path.exists(path)


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    hook = tprof.ProfilerHook(str(tmp_path), start_step=1, num_steps=2)
    a = torch.randn(16, 16)
    for step in range(1, 5):
        a = a @ a.T / 16
        hook.step(step)
    assert hook.done and hook.path is not None
    with open(hook.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    # a later fit's hook, past the window, traces nothing
    late = tprof.ProfilerHook(str(tmp_path / "late"), start_step=1,
                              num_steps=2)
    late.step(7)
    late.close()
    assert late.done and late.path is None
    assert not os.path.exists(tmp_path / "late")


def test_context_arms_telemetry_from_config(tmp_path):
    tnn.init_nncontext(tnn.ZooConfig(telemetry=True,
                                     trace_dir=str(tmp_path)), device="cpu")
    assert ttel.enabled()
    tnn.set_nncontext(None)
    os.environ.pop("ZOO_TPU_TELEMETRY", None)
    os.environ.pop("ZOO_TPU_TRACE_DIR", None)
    ttel.reset_for_tests()
    tnn.init_nncontext(tnn.ZooConfig(), device="cpu")
    assert not ttel.enabled()
