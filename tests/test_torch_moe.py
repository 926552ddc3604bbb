"""The port's ``SparseMoE`` and the MoE transformer against the JAX
package on the CPU.

The same seeded inputs go through both layers with the JAX weights
copied in. Tolerances: float32 forwards within 1e-5 of the output's
scale and gradients within 1e-4 of each gradient's norm (the experts'
products and the combine sum in other orders than XLA's einsums); bf16
within 2e-2 of scale. Routing, the slots kept and dropped, the dropped
rows and the drop counter are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.layers.moe import \
    SparseMoE as JSparseMoE
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu.utils import telemetry as jtel
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import moe as tmoe
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel
from analytics_zoo_tpu_torch.utils import load_jax_params
from analytics_zoo_tpu_torch.utils import telemetry as ttel

FWD_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _pair(e=4, f=16, h=8, k=2, cf=1.25, seed=0, tie=False, name=None):
    """A JAX SparseMoE with seeded weights (biases too) and the port's
    twin holding them."""
    jl_ = JSparseMoE(e, f, top_k=k, capacity_factor=cf, name=name)
    tl_ = tmoe.SparseMoE(e, f, top_k=k, capacity_factor=cf, name=name)
    rs = np.random.default_rng(seed)
    params = {
        "router_w": rs.standard_normal((h, e)).astype(np.float32),
        "w_in": (rs.standard_normal((e, h, f)) / np.sqrt(h)
                 ).astype(np.float32),
        "b_in": (0.1 * rs.standard_normal((e, f))).astype(np.float32),
        "w_out": (rs.standard_normal((e, f, h)) / np.sqrt(f)
                  ).astype(np.float32),
        "b_out": (0.1 * rs.standard_normal((e, h))).astype(np.float32)}
    if tie:   # experts 0 and 1 get equal gates for every token
        params["router_w"][:, 1] = params["router_w"][:, 0]
    tl_.build_params(torch.Generator().manual_seed(0), (None, h))
    load_jax_params(tl_, {tl_.name: params})
    return jl_, tl_, {k: jnp.asarray(v) for k, v in params.items()}


def _scale_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err} vs {tol} x {scale}"


def _norm_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert err <= tol * max(float(np.linalg.norm(want)), 1e-30), \
        f"{what}: err {err} vs norm {np.linalg.norm(want)}"


@pytest.mark.parametrize("k,tie", [(1, False), (2, False), (1, True),
                                   (2, True)])
def test_forward_and_gradients_match_jax(k, tie):
    jlay, tlay, jp = _pair(k=k, tie=tie, seed=k + 2 * tie)
    rs = np.random.default_rng(10 + k)
    x = rs.standard_normal((3, 7, 8)).astype(np.float32)
    cot = rs.standard_normal((3, 7, 8)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jlay.call(p, xx) * cot)

    want = jlay.call(jp, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tlay(tx)
    _scale_close(got.detach().numpy(), want, FWD_TOL, "forward")
    (got * torch.from_numpy(cot)).sum().backward()
    _norm_close(tx.grad.numpy(), jgx, GRAD_TOL, "dx")
    for name, p in tlay.named_parameters():
        if k == 1 and name == "router_w":
            # top-1's renormalised weight is g / g = 1: the router's
            # gradient is zero in exact arithmetic, rounding noise here
            assert np.abs(p.grad.numpy()).max() < 1e-6
            assert np.abs(np.asarray(jgp[name])).max() < 1e-6
            continue
        _norm_close(p.grad.numpy(), jgp[name], GRAD_TOL, name)


def test_tied_gates_pick_the_lower_expert_first():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    w, i = tmoe.top_k_gates(gates, 2)
    jw, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    assert i.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("k", [1, 2])
def test_overflow_drops_the_rows_jax_drops_and_counts_them(k):
    """A capacity factor of 0.3 drops most assignments: the port's output
    rows equal JAX's, zero where JAX's are, and both counters say the
    same count."""
    jtel.configure(enabled=True)
    ttel.configure(enabled=True)
    try:
        name = f"drop_moe_k{k}"
        jlay, tlay, jp = _pair(k=k, cf=0.3, seed=20 + k, name=name)
        x = np.random.default_rng(30 + k).standard_normal(
            (2, 9, 8)).astype(np.float32)
        want = np.asarray(jlay.call(jp, jnp.asarray(x))).reshape(-1, 8)
        got = tlay(torch.from_numpy(x)).detach().numpy().reshape(-1, 8)
        _scale_close(got, want, FWD_TOL, "rows")
        zero_j = np.abs(want).sum(-1) == 0
        zero_t = np.abs(got).sum(-1) == 0
        assert zero_j.any() and (zero_j == zero_t).all()

        def value(snap):
            return sum(m["value"] for m in snap["metrics"]
                       if m["name"] == "zoo_moe_dropped_tokens_total" and
                       m["labels"].get("layer") == name)

        jv = value(jtel.snapshot_metrics())
        tv = value(ttel.snapshot_metrics())
        assert jv == tv > 0
        # the recount: n*k less the slots the capacity holds
        n, e = 18, 4
        gates = tlay.route(tlay._params(), torch.from_numpy(x).reshape(n, 8))
        _, top_i = tmoe.top_k_gates(gates, k)
        _, kept = tmoe.assign_slots(top_i, e, tmoe.capacity(n, k, e, 0.3))
        assert tv == n * k - int(kept.sum())
    finally:
        jtel.configure(enabled=False)
        ttel.configure(enabled=False)


def test_capacity_goes_to_tokens_in_token_order_as_jax_pins_it():
    """``tests/test_parallel_props.py``'s case: 8 tokens, top-1, every
    one routed to expert 0 of 2 with capacity ceil(8 / 2 * 0.25) = 1:
    token 0 is served, the other 7 rows are zero (dropped, never
    re-routed to the cold expert), and the counter says 7 in both
    packages."""
    jtel.configure(enabled=True)
    ttel.configure(enabled=True)
    try:
        jlay = JSparseMoE(2, 4, top_k=1, capacity_factor=0.25,
                          name="props_moe_port")
        tlay = tmoe.SparseMoE(2, 4, top_k=1, capacity_factor=0.25,
                              name="props_moe_port")
        params = {k: np.asarray(v) for k, v in
                  jlay.build(jax.random.PRNGKey(0), (None, 4)).items()}
        params["router_w"] = np.zeros_like(params["router_w"])
        params["router_w"][:, 0] = 5.0
        tlay.build_params(torch.Generator().manual_seed(0), (None, 4))
        load_jax_params(tlay, {tlay.name: params})
        x = np.ones((8, 4), np.float32)
        want = np.asarray(jlay.call({k: jnp.asarray(v) for k, v in
                                     params.items()}, jnp.asarray(x)))
        got = tlay(torch.from_numpy(x)).detach().numpy()
        served = np.abs(got).sum(-1) > 1e-6
        assert served[0] and not served[1:].any()
        _scale_close(got, want, FWD_TOL, "rows")

        def value(snap):
            return sum(m["value"] for m in snap["metrics"]
                       if m["name"] == "zoo_moe_dropped_tokens_total" and
                       m["labels"].get("layer") == "props_moe_port")

        assert value(jtel.snapshot_metrics()) == \
            value(ttel.snapshot_metrics()) == 7
    finally:
        jtel.configure(enabled=False)
        ttel.configure(enabled=False)


def test_drop_counter_is_not_touched_when_telemetry_is_off():
    ttel.configure(enabled=False)
    _, tlay, _ = _pair(cf=0.3, name="quiet_moe")
    tlay(torch.ones(4, 8))
    assert not [m for m in ttel.snapshot_metrics()["metrics"]
                if m["labels"].get("layer") == "quiet_moe"]


def test_load_balancing_loss_matches_jax():
    jlay, tlay, jp = _pair(seed=5)
    x = np.random.default_rng(6).standard_normal((4, 5, 8)).astype(
        np.float32)
    want = float(jlay.load_balancing_loss(jp, jnp.asarray(x)))
    got = tlay.load_balancing_loss(torch.from_numpy(x)).item()
    assert got == pytest.approx(want, rel=1e-6)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.numels.append((func.__name__, tuple(t.shape)))
        return out


def test_no_dense_dispatch_or_combine_tensor_is_made():
    """The forward and backward make no tensor of N*E*C values (the JAX
    layer's dispatch and combine are (N, E, C))."""
    e, k, n = 8, 2, 2 * 64
    _, tlay, _ = _pair(e=e, k=k, f=8, h=8, cf=1.25)
    cap = tmoe.capacity(n, k, e, 1.25)
    x = torch.randn(2, 64, 8, requires_grad=True)
    with _Shapes() as rec:
        tlay(x).sum().backward()
    big = [(f, s) for f, s in rec.numels
           if int(np.prod(s)) >= n * e * cap]
    assert not big, big
    # the largest tensors are the experts' (E, C, F) activations
    assert max(int(np.prod(s)) for _, s in rec.numels) <= \
        e * cap * 8 + 8 * n


# -- the MoE transformer ---------------------------------------------------

SEQ, HID, VOCAB = 16, 32, 50


def _moe_classifier(pkg, embedding=False):
    layers = jl if pkg == "jax" else tl
    tl_cls = jsa.TransformerLayer if pkg == "jax" else tl.TransformerLayer
    kw = dict(n_block=2, hidden_size=HID, n_head=4, moe_experts=4,
              moe_top_k=2, seq_len=SEQ, vocab=VOCAB, hidden_p_drop=0.0,
              attn_p_drop=0.0, bidirectional=True)
    if embedding:
        kw["embedding_layer"] = layers.Embedding(VOCAB, HID,
                                                 name="custom_emb")
        kw.pop("moe_experts")
    tokens = layers.Input(shape=(SEQ,), name="tokens")
    _, pooled = tl_cls(**kw)(tokens)
    probs = layers.Dense(2, activation="softmax")(pooled)
    return (JModel if pkg == "jax" else TModel)(tokens, probs)


def _tokens(seed, n):
    rs = np.random.default_rng(seed)
    labels = rs.integers(0, 2, n)
    tokens = rs.integers(3, VOCAB, (n, SEQ))
    tokens[:, 0] = 1 + labels
    return tokens.astype(np.float32), labels.astype(np.float32)


def _paired(embedding=False):
    jmodel = _moe_classifier("jax", embedding)
    tmodel = _moe_classifier("torch", embedding)
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    return jmodel, tmodel


def test_moe_transformer_parameters_are_the_jax_paths():
    jmodel, tmodel = _paired()
    names = {k.split(".", 1)[1] for k, _ in tmodel.named_parameters()
             if k.startswith("transformerlayer")}
    assert {"block0.moe.router_w", "block0.moe.w_in", "block0.moe.b_in",
            "block1.moe.w_out", "block1.moe.b_out"} <= names
    assert not any("mlp_in_w" in n for n in names)


def test_moe_transformer_predict_matches_jax():
    jmodel, tmodel = _paired()
    tnn.init_nncontext(device="cpu")
    x, _ = _tokens(1, 6)
    want = np.asarray(jmodel.predict(x, batch_size=6))
    got = tmodel.predict(x, batch_size=6)
    _scale_close(got, want, FWD_TOL, "probs")


def test_moe_transformer_fit_matches_jax_step_for_step(tmp_path):
    jmodel, tmodel = _paired()
    for m in (jmodel, tmodel):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1)))
    jmodel.set_tensorboard(str(tmp_path), "jax")
    x, y = _tokens(2, 16)
    jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    jlosses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    tnn.init_nncontext(device="cpu")
    tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    assert len(jlosses) == len(tmodel.trainer.step_losses) == 4
    np.testing.assert_allclose(tmodel.trainer.step_losses, jlosses,
                               rtol=0, atol=1e-5)
    want = np.asarray(jmodel.predict(x, batch_size=8))
    _scale_close(tmodel.predict(x, batch_size=8), want, 1e-4, "after fit")


def test_moe_transformer_bf16_forward_within_tolerance():
    jmodel, tmodel = _paired()
    tnn.init_nncontext(device="cpu")
    x, _ = _tokens(3, 4)
    want = np.asarray(jmodel.predict(x, batch_size=4))
    tmodel.set_compute_dtype("bfloat16")
    got = tmodel.predict(x, batch_size=4)
    _scale_close(got, want, BF16_TOL, "bf16 probs")


def test_custom_embedding_layer_matches_jax():
    jmodel, tmodel = _paired(embedding=True)
    layer = tmodel.graph_function().layers[0]
    assert layer.hidden_size == HID and layer.embedding_layer is not None
    assert "transformerlayer" in layer.name
    assert any(k.endswith("embedding.table") for k, _ in
               tmodel.named_parameters())
    tnn.init_nncontext(device="cpu")
    x, _ = _tokens(4, 5)
    want = np.asarray(jmodel.predict(x, batch_size=5))
    _scale_close(tmodel.predict(x, batch_size=5), want, FWD_TOL, "probs")
