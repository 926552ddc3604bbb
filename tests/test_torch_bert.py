"""The port's serving slice against the JAX package on the CPU: a small
BERT classifier and a causal TransformerLayer built in both, JAX weights
copied into the port with ``load_jax_params``, the same seeded inputs
through both; then ``InferenceModel`` serving the port model from two
threads.

Tolerance 1e-4: both sides compute in float32, but two blocks of matmuls,
layer norms and softmaxes summed in different orders (XLA's CPU dots vs
PyTorch's BLAS) drift apart (at most 9.5e-7 seen here), and the layer
norms divide by row deviations near 1; 1e-4 leaves room for that and still
catches any wrong mask, scale, GELU form or epsilon (each moves the
outputs by 1e-2 or more).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import set_nncontext as jax_set_nncontext
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.utils import load_jax_params

TOL = 1e-4
B, L, H, NH, VOCAB = 3, 128, 64, 4, 100


@pytest.fixture(autouse=True)
def _contexts():
    jax_set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


def _bert_classifier(pkg, output_all_block=False):
    """bench.py's classifier at a small size: BERT -> pooled ->
    Dense(2, softmax); outputs [sequence states, probabilities]."""
    layers = jl if pkg == "jax" else tl
    bert_cls = jsa.BERT if pkg == "jax" else tl.BERT
    bert = bert_cls(vocab=VOCAB, hidden_size=H, n_block=2, n_head=NH,
                    seq_len=L, intermediate_size=4 * H,
                    output_all_block=output_all_block)
    ins = [layers.Input(shape=(L,), name="tokens"),
           layers.Input(shape=(L,), name="positions"),
           layers.Input(shape=(L,), name="segments"),
           layers.Input(shape=(1, 1, L), name="mask")]
    outs = bert(ins)
    probs = layers.Dense(2, activation="softmax")(outs[-1])
    model_cls = JModel if pkg == "jax" else TModel
    return model_cls(ins, [outs[0], probs])


def _causal_lm(pkg):
    layers = jl if pkg == "jax" else tl
    tl_cls = jsa.TransformerLayer if pkg == "jax" else tl.TransformerLayer
    tokens = layers.Input(shape=(L,), name="tokens")
    seq, pooled = tl_cls(n_block=2, n_head=NH, hidden_size=H, vocab=VOCAB,
                         seq_len=L, bidirectional=False)(tokens)
    model_cls = JModel if pkg == "jax" else TModel
    return model_cls(tokens, [seq, pooled])


def _bert_inputs(seed, b=B, l=L):
    """Token, position and segment ids as floats and a (B, 1, 1, L) mask
    with ragged lengths (one row unpadded, one short)."""
    rs = np.random.default_rng(seed)
    lengths = np.concatenate([[l, 5], rs.integers(1, l + 1, size=b - 2)])
    tokens = rs.integers(0, VOCAB, size=(b, l)).astype(np.float32)
    positions = np.broadcast_to(np.arange(l, dtype=np.float32), (b, l))
    segments = (np.arange(l)[None, :] >= lengths[:, None] // 2) \
        .astype(np.float32)
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    return [tokens, np.ascontiguousarray(positions), segments,
            mask[:, None, None, :]]


def _jax_params(jmodel, seed=0):
    params, _ = jmodel.graph_function().init(jax.random.PRNGKey(seed))
    return params


def _to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_jax(jmodel, params, inputs):
    out = jmodel.graph_function().apply(
        params, [jnp.asarray(x) for x in inputs], training=False)
    return [np.asarray(o) for o in out]


def _run_port(tmodel, inputs):
    with torch.inference_mode():
        out = tmodel([torch.from_numpy(np.array(x)) for x in inputs])
    return [o.numpy() for o in out]


def test_bert_classifier_matches_jax():
    jmodel, tmodel = _bert_classifier("jax"), _bert_classifier("torch")
    params = _jax_params(jmodel)
    load_jax_params(tmodel, _to_numpy_tree(params))
    inputs = _bert_inputs(0)
    ref = _run_jax(jmodel, params, inputs)
    out = _run_port(tmodel, inputs)
    assert out[0].shape == (B, L, H) and out[1].shape == (B, 2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=TOL, rtol=0)
    np.testing.assert_allclose(out[1].sum(-1), 1.0, atol=1e-6)


def test_bert_all_block_states_match_jax():
    jmodel = _bert_classifier("jax", output_all_block=True)
    tmodel = _bert_classifier("torch", output_all_block=True)
    # the classifier reads only the last output; compare every block's
    # states through the layer itself
    params = _jax_params(jmodel, seed=1)
    load_jax_params(tmodel, _to_numpy_tree(params))
    inputs = _bert_inputs(1)
    jbert = jmodel.graph_function().layers[0]
    tbert = tmodel.graph_function().layers[0]
    ref = jbert.call(params[jbert.name], [jnp.asarray(x) for x in inputs])
    with torch.inference_mode():
        out = tbert([torch.from_numpy(np.array(x)) for x in inputs])
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   rtol=0)


def test_causal_transformer_layer_matches_jax():
    jmodel, tmodel = _causal_lm("jax"), _causal_lm("torch")
    params = _jax_params(jmodel, seed=2)
    load_jax_params(tmodel, _to_numpy_tree(params))
    tokens = np.random.default_rng(2).integers(
        0, VOCAB, size=(B, L)).astype(np.float32)
    ref = _run_jax(jmodel, params, [tokens])
    out = _run_port(tmodel, [tokens])
    assert out[0].shape == (B, L, H) and out[1].shape == (B, H)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=TOL, rtol=0)
    # causal: a change in the last token leaves every earlier row alone
    tokens2 = tokens.copy()
    tokens2[:, -1] = (tokens2[:, -1] + 1) % VOCAB
    out2 = _run_port(tmodel, [tokens2])
    np.testing.assert_array_equal(out2[0][:, :-1], out[0][:, :-1])
    assert np.abs(out2[0][:, -1] - out[0][:, -1]).max() > 1e-3


def test_state_dict_keys_are_the_jax_param_paths():
    jmodel, tmodel = _bert_classifier("jax"), _bert_classifier("torch")
    params = _jax_params(jmodel)
    jbert, jdense = (l.name for l in jmodel.graph_function().layers)
    tbert, tdense = (l.name for l in tmodel.graph_function().layers)
    jpaths = {jax.tree_util.keystr(p, simple=True, separator=".")
              .replace(jbert, tbert).replace(jdense, tdense)
              for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(tmodel.state_dict()) == jpaths
    assert tmodel.state_dict()[f"{tbert}.block0.qkv_w"].shape == (H, 3 * H)
    assert tmodel.state_dict()[f"{tdense}.kernel"].shape == (H, 2)
    # get_weights follows the JAX leaf order
    load_jax_params(tmodel, _to_numpy_tree(params))
    weights = tmodel.get_weights()
    for w, r in zip(weights, jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(w, np.asarray(r))
    # set_weights takes the same order back
    other = _bert_classifier("torch")
    other.set_weights(weights)
    for w, r in zip(other.get_weights(), weights):
        np.testing.assert_array_equal(w, r)
    with pytest.raises(ValueError, match="expected"):
        other.set_weights(weights[:-1])


def test_load_jax_params_raises_on_missing_extra_and_misshaped_leaves():
    jmodel, tmodel = _bert_classifier("jax"), _bert_classifier("torch")
    good = _to_numpy_tree(_jax_params(jmodel))
    jbert = jmodel.graph_function().layers[0].name

    def edited(fn):
        tree = jax.tree.map(lambda x: x, good)
        fn(tree[jbert])
        return tree

    with pytest.raises(ValueError, match="missing"):
        load_jax_params(tmodel, edited(lambda t: t["block1"].pop("qkv_b")))
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(tmodel, edited(
            lambda t: t.__setitem__("stray", np.zeros(3, np.float32))))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tmodel, edited(lambda t: t["block0"].__setitem__(
            "proj_w", np.zeros((H, H + 1), np.float32))))
    # auto-named layers pair by class and creation order, not by the
    # order of the dict (JAX hands its params back with sorted keys): a
    # reversed dict loads the same weights, and an entry of another class
    # cannot stand in
    load_jax_params(tmodel, dict(reversed(list(good.items()))))
    for w, r in zip(tmodel.get_weights(), jax.tree_util.tree_leaves(good)):
        np.testing.assert_array_equal(w, r)
    with pytest.raises(ValueError, match="cannot pair"):
        load_jax_params(tmodel, {(k if k == jbert else "bert_999"): v
                                 for k, v in good.items()})
    with pytest.raises(ValueError, match="cannot pair"):
        load_jax_params(tmodel, {k: v for k, v in good.items()
                                 if k == jbert})


def test_inference_model_serves_two_threads_like_a_direct_call():
    model = _bert_classifier("torch")
    requests = [_bert_inputs(10 + i) for i in range(4)]
    with torch.inference_mode():
        direct = [model([torch.from_numpy(np.array(x)) for x in r])[1]
                  .numpy() for r in requests]
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(
        model, device="cpu")
    assert im.concurrent_num == 2
    times = im.warm([(L,), (L,), (L,), (1, 1, L)], [2])
    assert list(times) == [2]
    results = [None] * len(requests)

    def client(idx):
        for i in idx:
            results[i] = im.predict(requests[i])[1]

    threads = [threading.Thread(target=client, args=(range(t, 4, 2),))
               for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got, want in zip(results, direct):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # predict_async hands back tensors on the model's device
    out = im.predict_async(requests[0])
    assert isinstance(out[1], torch.Tensor) and out[1].device.type == "cpu"
    # KerasNet.predict, on the device the context names, batches the same
    # rows to the same answer
    tnn.init_nncontext(device="cpu")
    np.testing.assert_allclose(model.predict(requests[0], batch_size=2)[1],
                               direct[0], atol=1e-6, rtol=0)
    im.release()
    with pytest.raises(RuntimeError, match="no model loaded"):
        im.predict(requests[0])


def test_load_keras_net_takes_the_context_device():
    tnn.init_nncontext(device="cpu")
    im = InferenceModel().load_keras_net(_causal_lm("torch"))
    assert im.model.device == torch.device("cpu")


def test_predict_without_a_context_or_a_card_raises(monkeypatch):
    """A fresh model's ``predict`` runs on the card unless the caller asks
    for the CPU: with no context and no card it raises, never falling back
    to the CPU its weights were drawn on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _causal_lm("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.predict(np.zeros((1, L), np.float32))
    assert tnn._global_context is None


def test_parallel_branches_raise_not_implemented(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SEQUENCE_PARALLEL", "2")
    tnn.init_nncontext(device="cpu")
    model = _causal_lm("torch")
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        model(torch.zeros(1, L))
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.TransformerLayer(n_block=1, moe_experts=4)
