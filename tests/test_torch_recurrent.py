"""The port's recurrent layers, wrappers, ``WordEmbedding`` and ``Lambda``
against the JAX package on the CPU. JAX's parameters are copied into the
port with ``load_jax_params``; inputs and cotangents come from numpy
seeds.

Tolerances, float32 on both sides: outputs within 1e-5 of their norm;
gradients (``jax.grad`` against autograd through the sum of the output
times a seeded cotangent, for every parameter and the input) within 1e-4
of each gradient's norm. A T-step recurrence sums its matmuls in
another order on each side (XLA's CPU dots, PyTorch's BLAS, ``addmm``'s
fused add), some 1e-7 apart a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api import autograd as jag
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api import autograd as tag
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import recurrent
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.utils import load_jax_params

OUT_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
B, T, D = 3, 7, 5


@pytest.fixture(autouse=True)
def _context():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    tnn.set_nncontext(None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-12), \
        (what, err, np.linalg.norm(want))


def _paired(make, in_shape, seed=0):
    """The layer built in both packages, the port holding JAX's
    parameters."""
    jlayer, tlayer = make(jl), make(tl)
    jparams = jlayer.build(jax.random.PRNGKey(seed), in_shape)
    tlayer.build_params(torch.Generator().manual_seed(seed), in_shape)
    load_jax_params(tlayer, {tlayer.name: _np_tree(jparams)})
    return jlayer, jparams, tlayer


def _check_forward_and_grads(jlayer, jparams, tlayer, x, seed):
    """Output, parameter and input gradients of both layers on ``x``."""
    want = np.asarray(jlayer.call(jparams, jnp.asarray(x)))
    ct = np.random.default_rng(seed).standard_normal(
        want.shape).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(jlayer.call(p, xx) * ct), argnums=(0, 1))(
        jparams, jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    got = tlayer(tx)
    _close(got.detach().numpy(), want, OUT_REL_TOL, "output")
    tparams = dict(tlayer.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                list(tparams.values()) + [tx])
    jflat = _flat(_np_tree(jgp))
    assert set(jflat) == set(tparams)
    for (name, _), g in zip(tparams.items(), grads):
        _close(g.numpy(), jflat[name], GRAD_REL_TOL, name)
    _close(grads[-1].numpy(), np.asarray(jgx), GRAD_REL_TOL, "input")
    return got


@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_recurrent_layer_matches_jax(cls, return_sequences, go_backwards):
    seed = ["SimpleRNN", "LSTM", "GRU"].index(cls) * 4 + \
        2 * return_sequences + go_backwards
    jlayer, jparams, tlayer = _paired(
        lambda m: getattr(m, cls)(6, return_sequences=return_sequences,
                                  go_backwards=go_backwards), (None, T, D),
        seed)
    x = np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)
    got = _check_forward_and_grads(jlayer, jparams, tlayer, x, seed + 100)
    assert tuple(got.shape) == ((B, T, 6) if return_sequences else (B, 6))
    assert tlayer.compute_output_shape((None, T, D)) == \
        jlayer.compute_output_shape((None, T, D))


def test_recurrent_parameters_are_the_jax_layers():
    """W, U, b at the JAX shapes; U orthogonal; LSTM's forget-gate bias
    1 and the rest 0; GRU's bias 0."""
    g = torch.Generator().manual_seed(0)
    for cls, gates in (("SimpleRNN", 1), ("LSTM", 4), ("GRU", 3)):
        layer = getattr(tl, cls)(8)
        layer.build_params(g, (None, T, D))
        jshapes = jax.tree.map(
            np.shape, getattr(jl, cls)(8).build(jax.random.PRNGKey(0),
                                                (None, T, D)))
        assert {k: tuple(p.shape) for k, p in layer.named_parameters()} \
            == jshapes
        u = layer.U.detach()
        assert u.shape == (8, 8 * gates)
        b = layer.b.detach().numpy()
        want = np.zeros(8 * gates, np.float32)
        if cls == "LSTM":
            want[8:16] = 1.0
        np.testing.assert_array_equal(b, want)
    # an orthogonal (8, 32) block: orthonormal rows
    torch.testing.assert_close(u @ u.T, torch.eye(8), atol=1e-5, rtol=0)


def test_the_time_loop_takes_the_hard_sigmoid_and_keras1_gru():
    """The inner activation is Keras-1's hard sigmoid (not the logistic
    sigmoid cuDNN's cells use), and the GRU scales h_prev by r before
    U_h: one step by hand."""
    rs = np.random.default_rng(3)
    h, xt = rs.standard_normal((2, 4)), rs.standard_normal((2, 12))
    U = rs.standard_normal((4, 12))
    hs = lambda v: np.clip(0.2 * v + 0.5, 0.0, 1.0)
    zr = hs(xt[:, :8] + h @ U[:, :8])
    z, r = zr[:, :4], zr[:, 4:]
    hh = np.tanh(xt[:, 8:] + (r * h) @ U[:, 8:])
    want = z * h + (1 - z) * hh
    t = lambda a: torch.from_numpy(a)
    (parts,), Us = recurrent.timesteps(t(xt)[:, None], t(U),
                                       tl.GRU.parts(4))
    got, _ = recurrent.gru_step(t(h), parts, Us, torch.tanh,
                                recurrent.get_activation_fn("hard_sigmoid"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_a_rowwise_inner_activation_matches_jax(cls):
    """An inner activation that is not elementwise (softmax) goes over
    each gate apart, as the JAX cell applies it, where an elementwise one
    goes over the whole gate block at once."""
    seed = 40 + ["LSTM", "GRU"].index(cls)
    jlayer, jparams, tlayer = _paired(
        lambda m: getattr(m, cls)(6, inner_activation="softmax",
                                  return_sequences=True), (None, T, D),
        seed)
    x = np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)
    _check_forward_and_grads(jlayer, jparams, tlayer, x, seed + 100)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_jax(merge_mode):
    seed = ["concat", "sum", "mul", "ave"].index(merge_mode)
    inner = ("LSTM", "GRU", "SimpleRNN", "LSTM")[seed]
    jlayer, jparams, tlayer = _paired(
        lambda m: m.Bidirectional(getattr(m, inner)(
            4, return_sequences=seed % 2 == 0), merge_mode=merge_mode),
        (None, T, D), seed)
    assert sorted(_flat(_np_tree(jparams))) == \
        sorted(n for n, _ in tlayer.named_parameters())
    assert {n.split(".")[0] for n, _ in tlayer.named_parameters()} == \
        {"forward", "backward"}
    x = np.random.default_rng(seed + 20).standard_normal(
        (B, T, D)).astype(np.float32)
    _check_forward_and_grads(jlayer, jparams, tlayer, x, seed + 30)
    assert tlayer.backward.go_backwards and \
        not tlayer.forward.go_backwards
    assert tlayer.compute_output_shape((None, T, D)) == \
        jlayer.compute_output_shape((None, T, D))


def test_time_distributed_dense_matches_jax():
    jlayer, jparams, tlayer = _paired(
        lambda m: m.TimeDistributed(m.Dense(3, activation="tanh")),
        (None, T, D), 7)
    assert [n for n, _ in tlayer.named_parameters()] == \
        ["layer.kernel", "layer.bias"]
    x = np.random.default_rng(7).standard_normal(
        (B, T, D)).astype(np.float32)
    got = _check_forward_and_grads(jlayer, jparams, tlayer, x, 8)
    assert tuple(got.shape) == (B, T, 3)
    assert tlayer.compute_output_shape((None, T, D)) == (None, T, 3)


def test_wrappers_train_in_bf16_through_functional_call():
    """The trainer's bf16 path swaps parameters by path with
    ``torch.func.functional_call``: the role keys (``forward``, the name
    of nn.Module's call method, among them) resolve to the wrapped
    layers."""
    model = Sequential()
    model.add(tl.Bidirectional(tl.GRU(4, return_sequences=True),
                               input_shape=(T, D)))
    model.add(tl.TimeDistributed(tl.Dense(2)))
    model.compile("sgd", "mse")
    model.set_compute_dtype("bfloat16")
    rs = np.random.default_rng(9)
    x = rs.standard_normal((4, T, D)).astype(np.float32)
    y = rs.standard_normal((4, T, 2)).astype(np.float32)
    model.graph_function()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    model.fit(x, y, batch_size=4, nb_epoch=1)
    assert len(before) == 8
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert not torch.equal(p.detach(), before[k]), k


def test_layer_recorder_records_bidirectional():
    """A Bidirectional call runs through ``nn.Module``'s, so its forward
    hooks fire: ``utils.layer_parity`` records the layer and holds it
    against a twin, and finds it when the twin's weights differ."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        get_optimizer
    from analytics_zoo_tpu_torch.pipeline.engine import SPMDTrainer
    from analytics_zoo_tpu_torch.utils.layer_parity import (LayerRecorder,
                                                            compare_layers)

    def build():
        model = Sequential()
        model.add(tl.Bidirectional(tl.LSTM(4, return_sequences=True),
                                   input_shape=(T, D)))
        model.add(tl.TimeDistributed(tl.Dense(2)))
        model.graph_function()
        return model

    model, twin, changed = build(), build(), build()
    with torch.no_grad():
        for m in (twin, changed):
            for a, b in zip(m.parameters(), model.parameters()):
                a.copy_(b)
        changed.layers[0].backward.U.mul_(1.5)
    rs = np.random.default_rng(13)
    x = rs.standard_normal((4, T, D)).astype(np.float32)
    y = rs.standard_normal((4, T, 2)).astype(np.float32)
    trainer = SPMDTrainer(model, get_loss("mse"), get_optimizer("sgd"),
                          device="cpu")
    trainer.ensure_initialized()
    with LayerRecorder(model) as recorder:
        trainer.train_step(trainer.put_batch(([x], y,
                                              np.ones(4, np.float32))))
    bidir = model.layers[0].name
    assert bidir in recorder.records
    same = compare_layers(recorder, twin)
    assert set(same) == {layer.name for layer in model.layers}
    r = same[bidir]
    # the model's input takes no gradient
    assert r["y"] == 0.0 and r["dx"] == [None]
    assert {k for k in r["ref_norm"]} == {
        f"{role}.{w}" for role in ("forward", "backward")
        for w in ("W", "U", "b")}
    assert all(r[k] == 0.0 and r["ref_norm"][k] > 0 for k in r["ref_norm"])
    assert compare_layers(recorder, changed)[bidir]["y"] > 1e-3


def _glove_file(tmp_path, rs, words, dim):
    path = tmp_path / "glove.test.txt"
    vecs = rs.standard_normal((len(words), dim)).astype(np.float32)
    path.write_text("".join(
        w + " " + " ".join(repr(float(v)) for v in vec) + "\n"
        for w, vec in zip(words, vecs)), encoding="utf-8")
    return str(path), vecs


@pytest.mark.parametrize("source", ["weights", "glove_file"])
def test_word_embedding_matches_jax(source, tmp_path):
    rs = np.random.default_rng(11)
    words = ["the", "cat", "sat", "on", "mat", "é"]
    if source == "weights":
        table = rs.standard_normal((7, 4)).astype(np.float32)
        kw = dict(weights=table)
    else:
        path, vecs = _glove_file(tmp_path, rs, words, 4)
        # a word index with a word the file lacks and one it skips
        index = {"cat": 1, "mat": 2, "dog": 3, "é": 5}
        kw = dict(embedding_file=path, word_index=index)
        assert tl.WordEmbedding.get_word_index(path) == \
            jl.WordEmbedding.get_word_index(path) == \
            {w: i + 1 for i, w in enumerate(words)}
    jlayer, tlayer = jl.WordEmbedding(**kw), tl.WordEmbedding(**kw)
    jparams = jlayer.build(jax.random.PRNGKey(0), (None, 5))
    tlayer.build_params(torch.Generator().manual_seed(0), (None, 5))
    np.testing.assert_array_equal(tlayer.table.detach().numpy(),
                                  np.asarray(jparams["table"]))
    if source == "glove_file":
        t = tlayer.table.detach().numpy()
        assert t.shape == (6, 4) and not t[[0, 3, 4]].any()
        np.testing.assert_array_equal(t[1], vecs[1])
        np.testing.assert_array_equal(t[5], vecs[5])
    ids = rs.integers(0, tlayer.table.shape[0], (3, 5)).astype(np.float32)
    want = np.asarray(jlayer.call(jparams, jnp.asarray(ids)))
    got = tlayer(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # frozen: JAX's gradient is zero, the port's table takes none
    jg = jax.grad(lambda p: jnp.sum(jlayer.call(p, jnp.asarray(ids)) ** 2))(
        jparams)
    assert not np.asarray(jg["table"]).any()
    assert not got.requires_grad and tlayer.table.requires_grad
    # trainable: the gradients agree
    jt, tt = (pkg.WordEmbedding(trainable=True, **kw) for pkg in (jl, tl))
    tt.build_params(torch.Generator().manual_seed(0), (None, 5))
    jg = jax.grad(lambda p: jnp.sum(jt.call(p, jnp.asarray(ids)) ** 2))(
        jparams)
    (tt(torch.from_numpy(ids)) ** 2).sum().backward()
    np.testing.assert_allclose(tt.table.grad.numpy(),
                               np.asarray(jg["table"]), rtol=0, atol=1e-6)


def test_word_embedding_needs_a_source():
    with pytest.raises(ValueError, match="weights or embedding_file"):
        tl.WordEmbedding()


LAMBDA_CASES = {
    "sum_over_time": (lambda: jnp.sum, lambda: torch.sum,
                      lambda f: (lambda x: f(x, 1)), [(None, 4, 3)]),
    "two_inputs": (lambda: jnp.multiply, lambda: torch.mul,
                   lambda f: (lambda a, b: f(a, b) + 1.0),
                   [(None, 4, 3), (None, 4, 3)]),
    "reshape": (lambda: jnp.reshape, lambda: torch.reshape,
                lambda f: (lambda x: f(x, (x.shape[0], 12))),
                [(None, 4, 3)]),
}


@pytest.mark.parametrize("case", sorted(LAMBDA_CASES))
def test_lambda_matches_jax(case):
    jfn, tfn, wrap, shapes = LAMBDA_CASES[case]
    jlayer = jag.Lambda(wrap(jfn()))
    tlayer = tag.Lambda(wrap(tfn()))
    in_shape = shapes[0] if len(shapes) == 1 else shapes
    assert tlayer.compute_output_shape(in_shape) == \
        jlayer.compute_output_shape(in_shape)
    rs = np.random.default_rng(len(case))
    xs = [rs.standard_normal((2,) + s[1:]).astype(np.float32)
          for s in shapes]
    want = np.asarray(jlayer.call({}, [jnp.asarray(x) for x in xs]
                                  if len(xs) > 1 else jnp.asarray(xs[0])))
    got = tlayer([torch.from_numpy(x) for x in xs] if len(xs) > 1
                 else torch.from_numpy(xs[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_lambda_output_shapes_given_and_several():
    two = tag.Lambda(lambda x: (x[:, 0], x[:, 1:]), num_outputs=2,
                     output_shape=[(3,), (None, 2, 3)])
    assert two.compute_output_shape((None, 3, 3)) == \
        [(None, 3), (None, 2, 3)]
    inferred = tag.Lambda(lambda x: (x[:, 0], x[:, 1:]), num_outputs=2)
    assert inferred.compute_output_shape((None, 3, 3)) == \
        [(None, 3), (None, 2, 3)]
    with pytest.raises(ValueError, match="num_outputs"):
        tag.Lambda(lambda x: x, num_outputs=2,
                   output_shape=(3,)).compute_output_shape((None, 3))
    inp = tl.Input(shape=(3, 3))
    first, rest = inferred(inp)
    assert first.shape == (None, 3) and rest.shape == (None, 2, 3)


def test_a_sequential_of_recurrent_layers_fits_like_jax(tmp_path):
    """Stacked LSTM -> GRU(go_backwards) -> Dense through ``fit``: 3 SGD
    steps' losses and the weights after them within 1e-5."""
    from analytics_zoo_tpu.common import nncontext as jnn

    def build(m, seq):
        model = seq()
        model.add(m.LSTM(6, return_sequences=True, input_shape=(T, D)))
        model.add(m.GRU(5, go_backwards=True))
        model.add(m.Dense(2))
        return model

    jmodel, tmodel = build(jl, JSequential), build(tl, Sequential)
    jmodel.compile("sgd", "mse")
    tmodel.compile("sgd", "mse")
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    try:
        jmodel.set_tensorboard(str(tmp_path), "rnn")
        load_jax_params(tmodel, _np_tree(jmodel.get_params()))
        rs = np.random.default_rng(12)
        x = rs.standard_normal((12, T, D)).astype(np.float32)
        y = rs.standard_normal((12, 2)).astype(np.float32)
        jmodel.fit(x, y, batch_size=4, nb_epoch=1)
        jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
        tmodel.fit(x, y, batch_size=4, nb_epoch=1)
        np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                                   rtol=1e-5, atol=0)
        jw = [np.asarray(w) for w in jmodel.get_weights()]
        for got, want in zip(tmodel.get_weights(), jw):
            _close(got, want, 1e-5)
    finally:
        jnn.set_nncontext(None)
