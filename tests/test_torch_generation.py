"""The port's generation slice against the JAX package on the CPU: the
int8 row quantizer, every KV-cache op, the ``TransformerLayer`` decode API
(``prefill``, ``decode_step``, ``decode_chunk``) from the same weights and
the same mid-stream cache, and greedy streams through
``ContinuousBatchScheduler`` over both decode engines and the stub.

The model is a ``TransformerLayer(n_block=2, hidden_size=128, n_head=2,
vocab=97, seq_len=64)`` (head dim 64, the kernel's). Its weights are drawn
with numpy from a seed, at scales that make greedy streams move (the
layer's own 0.02 init makes a tied-embedding model repeat its input
token), given to JAX and copied into the port with ``load_jax_params``.

Tolerances: the cache ops copy rows (slabs equal exactly, int8 too) and
compute attention as the same f32 einsums, so o is held at 1e-5; the
decode API's logits (two blocks of f32 matmuls summed in another order
by XLA and by PyTorch, logits of scale ~3) at 1e-4; greedy streams
exactly.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import kv_cache as jkv
from analytics_zoo_tpu.ops import quant as jquant
from analytics_zoo_tpu.pipeline.api.keras.layers.self_attention import \
    TransformerLayer as JTransformerLayer
from analytics_zoo_tpu.serving import generation as jgen
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.ops import kv_cache as tkv
from analytics_zoo_tpu_torch.ops import quant as tquant
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    TransformerLayer as TTransformerLayer
from analytics_zoo_tpu_torch.serving import generation as tgen
from analytics_zoo_tpu_torch.utils import (load_jax_decode_state,
                                           load_jax_params)

CONFIG = dict(n_block=2, hidden_size=128, n_head=2, vocab=97, seq_len=64)
NH, D = 2, 64
CAP = 32
CACHE_TOL = 1e-5
LOGIT_TOL = 1e-4
KV_DTYPES = ["float32", "int8"]


def _jdtype(name):
    return "int8" if name == "int8" else jnp.float32


def _tdtype(name):
    return "int8" if name == "int8" else torch.float32


def _np(x):
    return np.asarray(x)


def _slab_np(slab):
    """A JAX or port slab as numpy: (rows,) or (q, scale)."""
    if hasattr(slab, "q"):
        return (np.asarray(slab.q), np.asarray(slab.scale))
    return (np.asarray(slab),)


def _assert_slab_equal(jslab, tslab):
    for a, b in zip(_slab_np(jslab), _slab_np(tslab)):
        np.testing.assert_array_equal(a, b)


def _assert_slab_close(a, b, tol):
    """f32 slabs within ``tol``; int8 slabs' rows within one step (rows
    computed in another summation order can round apart) and their
    scales within ``tol`` relative."""
    a, b = _slab_np(a), _slab_np(b)
    if len(a) == 1:
        np.testing.assert_allclose(a[0], b[0], atol=tol, rtol=0)
        return
    assert np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).max() <= 1
    np.testing.assert_allclose(a[1], b[1], rtol=tol, atol=1e-30)


# ---------------------------------------------------------------------------
# weights and layers
# ---------------------------------------------------------------------------

def _draw_params(template, seed):
    """Numpy weights in the layout of ``template`` (a JAX params pytree):
    embeddings N(0, 0.3), matrices N(0, 2/sqrt(fan_in)), LN gains
    1 + N(0, 0.1), biases N(0, 0.1)."""
    rs = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if a.ndim == 2:
            std = 0.3 if "emb" in name else 2.0 / np.sqrt(a.shape[0])
            return rs.normal(0.0, std, a.shape).astype(np.float32)
        if name.endswith("_g"):
            return (1.0 + 0.1 * rs.normal(size=a.shape)).astype(np.float32)
        return (0.1 * rs.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def _layers(n_block, np_params):
    """The JAX layer with ``np_params`` as jnp arrays, and the port layer
    with the same weights copied in."""
    cfg = dict(CONFIG, n_block=n_block)
    jlayer = JTransformerLayer(**cfg)
    tlayer = TTransformerLayer(**cfg)
    tlayer.build_params(torch.Generator().manual_seed(0), (None, 64))
    load_jax_params(tlayer, {tlayer.name: np_params})
    return jlayer, jax.tree.map(jnp.asarray, np_params), tlayer


@pytest.fixture(scope="module")
def model():
    jlayer = JTransformerLayer(**CONFIG)
    template = jlayer.build(jax.random.PRNGKey(0), (None, 64))
    np_params = _draw_params(template, seed=1)
    jlayer, jparams, tlayer = _layers(CONFIG["n_block"], np_params)
    # the speculative draft: one block, the target's embeddings and block0
    draft_np = {k: np_params[k] for k in ("tok_emb", "pos_emb", "block0",
                                          "pooler_w", "pooler_b")}
    jdraft, jdraft_params, tdraft = _layers(1, draft_np)
    return dict(jlayer=jlayer, jparams=jparams, tlayer=tlayer,
                jdraft=jdraft, jdraft_params=jdraft_params, tdraft=tdraft)


@pytest.fixture(autouse=True)
def _no_port_context():
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 40.0])
def test_quantize_rows_matches_jax(scale):
    """int8 exactly equal, scales within 1 ulp, and the dequantized rows
    equal, on rows with an outlier and an all-zero row."""
    rs = np.random.default_rng(3)
    x = (scale * rs.normal(size=(3, 5, NH, D))).astype(np.float32)
    x[0, 1, 0, 7] *= 50.0
    x[1, 2, 1] = 0.0
    jq, js = jquant.quantize_rows(jnp.asarray(x), axis=-1)
    tq, ts = tquant.quantize_rows(torch.from_numpy(x), axis=-1)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (3, 5, NH, 1)
    np.testing.assert_array_equal(_np(jq), tq.numpy())
    np.testing.assert_array_max_ulp(_np(js), ts.numpy(), maxulp=1)
    np.testing.assert_array_equal(
        _np(jquant.dequantize_rows(jq, js)),
        tquant.dequantize_rows(torch.from_numpy(np.array(jq)),
                               torch.from_numpy(np.array(js))).numpy())


# ---------------------------------------------------------------------------
# ops/kv_cache.py
# ---------------------------------------------------------------------------

def _rows(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _states(kv, batch=3, cap=CAP, layers=1):
    j = jkv.init_decode_state(layers, batch, cap, NH, D, dtype=_jdtype(kv))
    t = tkv.init_decode_state(layers, batch, cap, NH, D, dtype=_tdtype(kv))
    return j, t


def _prompt_states(kv, lengths, batch=3, seed=0):
    """A JAX and a port state whose slabs hold the same prompt rows."""
    j, t = _states(kv, batch)
    lp = max(lengths)
    k, v = _rows(seed, (batch, lp, NH, D)), _rows(seed + 1,
                                                  (batch, lp, NH, D))
    jk = jkv.write_prompt(j.k_cache[0], jnp.asarray(k))
    jv = jkv.write_prompt(j.v_cache[0], jnp.asarray(v))
    tk = tkv.write_prompt(t.k_cache[0], torch.from_numpy(k))
    tv = tkv.write_prompt(t.v_cache[0], torch.from_numpy(v))
    lens = np.asarray(lengths, np.int32)
    return (jk, jv, jnp.asarray(lens)), (tk, tv, torch.from_numpy(lens))


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_init_write_prompt_place_slot_evict_and_grow_match_jax(kv):
    (jk, jv, jlen), (tk, tv, tlen) = _prompt_states(kv, [5, 9, 2])
    _assert_slab_equal(jk, tk)
    _assert_slab_equal(jv, tv)
    # splice one sequence (f32 rows, and a pre-quantized payload) into slot 1
    rows = _rows(7, (6, NH, D))
    jk = jkv.place_slot(jk, 1, jnp.asarray(rows))
    assert tkv.place_slot(tk, 1, torch.from_numpy(rows)) is tk
    _assert_slab_equal(jk, tk)
    jq = jkv.quantize_kv(jnp.asarray(rows[:4]))
    tq = tkv.quantize_kv(torch.from_numpy(rows[:4]))
    jv = jkv.place_slot(jv, 2, jq)
    tkv.place_slot(tv, 2, tq)
    _assert_slab_equal(jv, tv)
    np.testing.assert_array_equal(_np(jkv.evict_slot(jlen, 1)),
                                  tkv.evict_slot(tlen, 1).numpy())
    _assert_slab_equal(jkv.grow_slab(jk, 2 * CAP), tkv.grow_slab(tk, 2 * CAP))
    j, t = _states(kv, layers=2)
    assert jkv.kv_slab_bytes(j) == tkv.kv_slab_bytes(t)
    assert t.batch == 3 and t.capacity == CAP and t.num_layers == 2


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_cached_attention_step_matches_jax(kv):
    (jk, jv, jlen), (tk, tv, tlen) = _prompt_states(kv, [5, 9, 0], seed=2)
    q, kn, vn = (_rows(10 + i, (3, 1, NH, D)) for i in range(3))
    jo, jk, jv, jl = jkv.cached_attention_step(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv, jlen)
    to, tk2, tv2, tl = tkv.cached_attention_step(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, tlen)
    assert tk2 is tk and tv2 is tv   # written in place
    _assert_slab_equal(jk, tk)
    _assert_slab_equal(jv, tv)
    np.testing.assert_array_equal(_np(jl), tl.numpy())
    np.testing.assert_allclose(_np(jo), to.numpy(), atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("ragged", [False, True])
def test_cached_attention_chunk_matches_jax(kv, ragged):
    (jk, jv, jlen), (tk, tv, tlen) = _prompt_states(kv, [5, 9, 1], seed=4)
    c = 4
    q, kn, vn = (_rows(20 + i, (3, c, NH, D)) for i in range(3))
    nv = np.array([4, 1, 3], np.int32) if ragged else None
    jo, jk, jv, jl = jkv.cached_attention_chunk(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv, jlen,
        n_valid=None if nv is None else jnp.asarray(nv))
    to, tk, tv, tl = tkv.cached_attention_chunk(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, tlen, n_valid=None if nv is None else torch.from_numpy(nv))
    _assert_slab_equal(jk, tk)
    _assert_slab_equal(jv, tv)
    np.testing.assert_array_equal(_np(jl), tl.numpy())
    np.testing.assert_allclose(_np(jo), to.numpy(), atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_write_row_clamps_like_dynamic_update_slice(kv):
    """C = 3 rows written at lengths = S - 1 land at [S - 3, S), shifted
    back, as JAX's ``dynamic_update_slice`` clamps its start; lengths
    still advance by C."""
    (jk, jv, _), (tk, tv, _) = _prompt_states(kv, [CAP, 4, 2], seed=6)
    lens = np.array([CAP - 1, 4, CAP - 2], np.int32)
    q, kn, vn = (_rows(30 + i, (3, 3, NH, D)) for i in range(3))
    jo, jk, jv, jl = jkv.cached_attention_chunk(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv,
        jnp.asarray(lens))
    to, tk, tv, tl = tkv.cached_attention_chunk(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, torch.from_numpy(lens))
    _assert_slab_equal(jk, tk)
    _assert_slab_equal(jv, tv)
    assert tl.tolist() == [CAP + 2, 7, CAP + 1] == _np(jl).tolist()
    got = tk.dequantize() if kv == "int8" else tk
    want = tkv.quantize_kv(torch.from_numpy(kn)).dequantize() \
        if kv == "int8" else torch.from_numpy(kn)
    torch.testing.assert_close(got[0, CAP - 3:], want[0], rtol=0, atol=0)
    np.testing.assert_allclose(_np(jo), to.numpy(), atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_writing_k_leaves_v_untouched(kv):
    """K and V are separate allocations: the JAX state hands one zeros
    tuple to both, which an in-place writer must not copy."""
    state = tkv.init_decode_state(2, 2, CAP, NH, D, dtype=_tdtype(kv))
    for i in range(2):
        assert state.k_cache[i] is not state.v_cache[i]
    tkv.write_prompt(state.k_cache[0], torch.ones(2, 5, NH, D))
    for slab in (state.v_cache[0], state.k_cache[1], state.v_cache[1]):
        for part in _slab_np(slab):
            assert not part.any()
    assert _slab_np(state.k_cache[0])[0].any()


def test_cache_buckets_match_jax():
    for max_len, lo in ((64, 64), (512, 128), (1000, 128), (3, 1)):
        assert tkv.cache_length_buckets(max_len, lo) == \
            jkv.cache_length_buckets(max_len, lo)
    buckets = tkv.cache_length_buckets(512)
    assert tkv.pick_cache_bucket(129, buckets) == 256
    with pytest.raises(ValueError, match="exceeds largest"):
        tkv.pick_cache_bucket(513, buckets)


def test_decode_step_is_cached(model):
    """The cached step and chunk run no (S, S) contraction; a full
    attention over the slab's history does."""
    layer = model["tlayer"]
    state = layer.init_decode_state(2, CAP)
    _, state = layer.prefill(torch.tensor([[3, 4, 5], [6, 7, 0]]),
                             torch.tensor([3, 2]), state)
    assert tkv.decode_step_is_cached(layer.decode_step, state.clone(),
                                     torch.tensor([1, 2]), capacity=CAP)
    assert tkv.decode_step_is_cached(layer.decode_chunk, state.clone(),
                                     torch.tensor([[1, 2], [3, 4]]),
                                     capacity=CAP)

    def full_history(k):
        return torch.softmax(torch.einsum("bshd,bthd->bhst", k, k), -1)

    assert not tkv.decode_step_is_cached(full_history, state.k_cache[0],
                                         capacity=CAP)
    with pytest.raises(ValueError, match="capacity"):
        tkv.decode_step_is_cached(full_history, state.k_cache[0])


# ---------------------------------------------------------------------------
# TransformerLayer decode API
# ---------------------------------------------------------------------------

PROMPTS = np.random.default_rng(9).integers(1, 97, size=(3, 20))
PROMPT_LENGTHS = np.array([20, 7, 13], np.int32)


def _prefill_both(model, kv):
    jl, jp, tl = model["jlayer"], model["jparams"], model["tlayer"]
    js = jl.init_decode_state(3, CAP, dtype=_jdtype(kv))
    jlog, js = jl.prefill(jp, jnp.asarray(PROMPTS), jnp.asarray(
        PROMPT_LENGTHS), js)
    ts = tl.init_decode_state(3, CAP, dtype=_tdtype(kv))
    tlog, ts = tl.prefill(torch.from_numpy(PROMPTS),
                          torch.from_numpy(PROMPT_LENGTHS), ts)
    return (jlog, js), (tlog, ts)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_prefill_matches_jax(model, kv):
    (jlog, js), (tlog, ts) = _prefill_both(model, kv)
    assert tlog.shape == (3, CONFIG["vocab"])
    np.testing.assert_allclose(_np(jlog), tlog.numpy(), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(_np(js.lengths), ts.lengths.numpy())
    for jslab, tslab in zip(js.k_cache + js.v_cache, ts.k_cache + ts.v_cache):
        _assert_slab_close(jslab, tslab, LOGIT_TOL)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_decode_step_and_chunk_match_jax_from_the_same_state(model, kv):
    """From one mid-stream JAX state carried over with
    ``load_jax_decode_state``: two decode steps, then a ragged chunk."""
    jl, jp, tl = model["jlayer"], model["jparams"], model["tlayer"]
    (_, js), _ = _prefill_both(model, kv)
    ts = load_jax_decode_state(js)
    rs = np.random.default_rng(11)
    for _ in range(2):
        toks = rs.integers(1, 97, size=(3,))
        jlog, js = jl.decode_step(jp, js, jnp.asarray(toks))
        tlog, ts = tl.decode_step(ts, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(jlog), tlog.numpy(), atol=LOGIT_TOL,
                                   rtol=0)
    toks = rs.integers(1, 97, size=(3, 4))
    nv = np.array([4, 2, 1], np.int32)
    jlog, js = jl.decode_chunk(jp, js, jnp.asarray(toks),
                               n_valid=jnp.asarray(nv))
    tlog, ts = tl.decode_chunk(ts, torch.from_numpy(toks),
                               n_valid=torch.from_numpy(nv))
    assert tlog.shape == (3, 4, CONFIG["vocab"])
    np.testing.assert_allclose(_np(jlog), tlog.numpy(), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(_np(js.lengths), ts.lengths.numpy())


def test_decode_positions_clamp_at_seq_len(model):
    """Positions past seq_len - 1 embed at seq_len - 1, as in JAX (on
    the card an out-of-range index would be a device assert)."""
    jl, jp, tl = model["jlayer"], model["jparams"], model["tlayer"]
    seq = CONFIG["seq_len"]
    js = jl.init_decode_state(1, 2 * seq)
    js = js._replace(lengths=jnp.asarray([seq + 3], jnp.int32))
    ts = load_jax_decode_state(js)
    jlog, _ = jl.decode_chunk(jp, js, jnp.asarray([[5, 6]]))
    tlog, _ = tl.decode_chunk(ts, torch.tensor([[5, 6]]))
    np.testing.assert_allclose(_np(jlog), tlog.numpy(), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_decode_chunk_equals_repeated_decode_step(model, kv):
    tl = model["tlayer"]
    _, (_, ts) = _prefill_both(model, kv)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        1, 97, size=(3, 5)))
    chunk_log, chunk_state = tl.decode_chunk(ts.clone(), toks)
    for c in range(toks.shape[1]):
        step_log, ts = tl.decode_step(ts, toks[:, c])
        torch.testing.assert_close(step_log, chunk_log[:, c], rtol=0,
                                   atol=LOGIT_TOL)
    assert torch.equal(ts.lengths, chunk_state.lengths)
    for a, b in zip(ts.k_cache + ts.v_cache,
                    chunk_state.k_cache + chunk_state.v_cache):
        _assert_slab_close(a, b, LOGIT_TOL)


def test_decode_rejects_a_bidirectional_trunk():
    layer = TTransformerLayer(bidirectional=True, **CONFIG)
    layer.build_params(torch.Generator().manual_seed(0), (None, 64))
    with pytest.raises(ValueError, match="causal trunk"):
        layer.prefill(torch.tensor([[1, 2]]), torch.tensor([2]),
                      layer.init_decode_state(1, CAP))


# ---------------------------------------------------------------------------
# engines and the scheduler
# ---------------------------------------------------------------------------

def _drive(gen, engine, reqs, timeout=120.0, **kw):
    """Submit every request, then start the scheduler thread (so the
    first refill sees them all), and wait for every commit."""
    out = {}
    sched = gen.ContinuousBatchScheduler(
        engine, lambda uri, p: out.__setitem__(uri, p), **kw)
    for r in reqs:
        sched.submit(r)
    sched.start()
    t0 = time.perf_counter()
    while len(out) < len(reqs) and time.perf_counter() - t0 < timeout:
        time.sleep(0.002)
    sched.stop(drain=True, timeout=timeout)
    assert len(out) == len(reqs)
    return out, sched


def _requests(gen, repeat=False):
    """Three prompts (lengths 5, 19, 30; the last repeats the first when
    ``repeat``) with budgets 8, 5, 8: with two slots the first two join as
    one batch and the third joins alone when the shorter one finishes."""
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 97, size=n) for n in (5, 19, 30)]
    if repeat:
        prompts[2] = prompts[0].copy()
    return [gen.GenRequest(uri=f"r{i}", prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, (8, 5, 8)))]


def _engine(gen, model, mode, side):
    layer = model["jlayer" if side == "jax" else "tlayer"]
    kw = dict(kv_dtype="int8") if mode == "int8" else {}
    if mode == "prefix":
        kw["prefix_cache"] = gen.PrefixCache()

    def make(l, params, **k):
        if side == "jax":
            return gen.TransformerDecodeEngine(l, params, **k)
        return gen.TransformerDecodeEngine(l, device="cpu", **k)

    target = make(layer, model["jparams"], **kw)
    if mode != "speculative":
        return target
    draft = make(model["jdraft" if side == "jax" else "tdraft"],
                 model["jdraft_params"])
    return gen.SpeculativeDecodeEngine(target, draft, k=3)


MODES = ["batched", "chunked", "prefix", "int8", "speculative"]


def _run(gen, model, mode, side):
    engine = _engine(gen, model, mode, side)
    kw = dict(max_slots=2, prefill_chunk=8 if mode == "chunked" else 0)
    out, sched = _drive(gen, engine, _requests(gen, mode == "prefix"), **kw)
    return engine, out, sched


@pytest.fixture(scope="module")
def jax_streams(model):
    streams = {}
    for mode in ["plain"] + MODES:
        engine, out, _ = _run(jgen, model, mode, "jax")
        streams[mode] = ({u: out[u]["tokens"] for u in out},
                         engine.stats())
    return streams


@pytest.mark.parametrize("mode", MODES)
def test_greedy_streams_match_jax(model, jax_streams, mode):
    engine, out, sched = _run(tgen, model, mode, "torch")
    streams = {u: out[u]["tokens"] for u in out}
    want, jax_stats = jax_streams[mode]
    assert streams == want
    assert all(out[u]["finish"] == "max_new_tokens" for u in out)
    assert sched.counts["duplicate_commits"] == 0
    assert sched.counts["committed"] == 3
    if mode == "speculative":
        # the speculative engine's greedy output is the plain output
        assert streams == jax_streams["plain"][0]
        assert engine.stats()["draft_accepted"] == \
            jax_stats["draft_accepted"]
        assert 0.0 < engine.acceptance_rate < 1.0
    else:
        assert engine.stats()["prefill_calls"] == \
            jax_stats["prefill_calls"]
    if mode == "chunked":
        assert engine.prefill_calls > 3   # the long prompts joined in chunks
    if mode == "prefix":
        assert engine.prefix_cache.stats()["hits"] == 1
        assert engine.prefill_calls == 1   # one batched join, then a hit


def test_plain_streams_match_jax_and_int8_keeps_them(model, jax_streams):
    engine, out, _ = _run(tgen, model, "plain", "torch")
    plain = {u: out[u]["tokens"] for u in out}
    assert plain == jax_streams["plain"][0]
    assert plain == jax_streams["int8"][0]
    assert engine.prefill_calls == 2   # one batched join, one single join


def test_prefix_cache_payload_is_a_copy(model):
    """A cached payload holds copies: steps taken after the insert (in
    place, on the gang's slabs) leave it as it was, and a hit replays
    the cold stream with no prefill."""
    cache = tgen.PrefixCache()
    engine = tgen.TransformerDecodeEngine(model["tlayer"], device="cpu",
                                          prefix_cache=cache)
    reqs = _requests(tgen, repeat=True)
    cold, _ = _drive(tgen, engine, reqs[:1], max_slots=2)
    (payload, nbytes), = cache._entries.values()
    snapshot = [r.clone() for r in payload[0] + payload[1]] + \
        [payload[2].clone()]
    assert nbytes == sum(int(t.nbytes) for t in snapshot)
    _drive(tgen, engine, reqs[1:2], max_slots=2)
    calls = engine.prefill_calls
    warm, _ = _drive(tgen, engine, reqs[2:], max_slots=2)
    assert warm["r2"]["tokens"] == cold["r0"]["tokens"]
    assert engine.prefill_calls == calls and cache.hits == 1
    for was, now in zip(snapshot, list(payload[0] + payload[1]) +
                        [payload[2]]):
        assert torch.equal(was, now)


def test_sampling_repeats_under_a_seed(model):
    def run(seed):
        engine = tgen.TransformerDecodeEngine(
            model["tlayer"], device="cpu",
            rng=torch.Generator().manual_seed(seed))
        reqs = [tgen.GenRequest(uri=f"s{i}", prompt=r.prompt,
                                max_new_tokens=8, temperature=1.5)
                for i, r in enumerate(_requests(tgen))]
        out, _ = _drive(tgen, engine, reqs, max_slots=2)
        return [out[u]["tokens"] for u in sorted(out)]

    first = run(5)
    assert run(5) == first
    assert run(6) != first


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(model,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.TransformerDecodeEngine(model["tlayer"])
    tnn.init_nncontext(device="cpu")
    assert tgen.TransformerDecodeEngine(model["tlayer"]).device == \
        torch.device("cpu")


# ---------------------------------------------------------------------------
# the stub engine
# ---------------------------------------------------------------------------

def _stub_requests(gen):
    return [gen.GenRequest("stop", np.array([10, 3]), max_new_tokens=20,
                           stop_id=0),
            gen.GenRequest("budget", np.array([50]), max_new_tokens=4),
            gen.GenRequest("long", np.array([100, 0, 5, 6, 7, 8, 9, 10, 11,
                                             12, 13]), max_new_tokens=12),
            gen.GenRequest("late", np.array([7, 9]), max_new_tokens=15,
                           stop_id=0)]


def _stub_engine(gen, mode):
    if mode == "speculative":
        return gen.SpeculativeDecodeEngine(
            gen.StubDecodeEngine(ms_per_step=0.2),
            gen.StubDecodeEngine(ms_per_step=0.0, draft_skew=3), k=3)
    return gen.StubDecodeEngine(ms_per_step=0.2,
                                prefix_cache=gen.PrefixCache())


@pytest.mark.parametrize("mode,kw", [
    ("plain", dict(max_slots=2)),
    ("chunked", dict(max_slots=2, prefill_chunk=4)),
    ("static", dict(max_slots=2, continuous=False)),
    ("speculative", dict(max_slots=3)),
])
def test_stub_scheduler_payloads_match_jax(mode, kw):
    """Committed tokens and finish reasons, the scheduler's counts and
    the engine's stats equal JAX's for the same requests."""
    results = {}
    for side, gen in (("jax", jgen), ("torch", tgen)):
        engine = _stub_engine(gen, mode)
        out, sched = _drive(gen, engine, _stub_requests(gen), **kw)
        stats = engine.stats()
        results[side] = ({u: (p["tokens"], p["finish"])
                          for u, p in out.items()},
                         dict(sched.counts), stats)
    assert results["torch"] == results["jax"]
    assert results["torch"][0]["stop"] == ([11, 12, 0], "stop_id")
