"""The port's parameter sharding rules (``parallel/sharding.py``) and
layout entry points against the JAX package, on the CPU.

Each layer JAX annotates is built in both packages and its parameters'
specs compared leaf by leaf: JAX's ``make_param_sharding_fn`` on its
8-device CPU mesh against the port's on a rank mesh of the same shape
(no process group: the rules read only the axes' sizes). Covered: the
default (Megatron) rules on BERT, the MoE transformer and the stacked
GPipe layout, the FSDP rules on Dense, SparseDense, Embedding and the
convolutions; JAX's two traps (a dimension that does not divide its axis
replicates, warning from 16,384 elements; one mesh axis shards only the
largest divisible dimension); the config's modes and
``set_param_sharding``; ``spec_is_replicated``; and a leaf's block and
regions where a dimension has parts (the qkv kernel's q, k and v).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import parallel as jpar
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.parallel import sharding as jsh
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import \
    Sequential as JSequential
from analytics_zoo_tpu_torch import parallel as tpar
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.parallel import sharding as tsh
from analytics_zoo_tpu_torch.parallel import zero as tzero
from analytics_zoo_tpu_torch.parallel.mesh import RankMesh
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    self_attention as tsa
from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
    Sequential as TSequential


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


class _Graph:
    def __init__(self, *layers):
        self.layers = list(layers)


def _meshes(**axes):
    """JAX's mesh over the 8 CPU devices and the port's rank mesh of the
    same shape."""
    jmesh = jpar.make_mesh(**axes)
    shape = tuple(int(jmesh.shape[a]) for a in jpar.AXES)
    return jmesh, RankMesh(shape, 0)


def _specs_by_leaf(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_specs_by_leaf(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_same_specs(jlayer, jparams, tlayer, tparams, jmesh, tmesh,
                       rules=None):
    jspecs = _specs_by_leaf(jsh.make_param_sharding_fn(
        _Graph(jlayer), jmesh, rules)({jlayer.name: jparams})[jlayer.name])
    tspecs = _specs_by_leaf(tsh.make_param_sharding_fn(
        _Graph(tlayer), tmesh, rules)({tlayer.name: tparams})[tlayer.name])
    assert set(jspecs) == set(tspecs)
    shapes = _specs_by_leaf(jax.tree.map(np.shape, jparams))
    for key, jspec in jspecs.items():
        want = tuple(jspec.spec) + (None,) * (len(shapes[key]) -
                                              len(tuple(jspec.spec)))
        assert tspecs[key] == want, (key, tspecs[key], want)
    assert tlayer.param_axes() == jlayer.param_axes()
    return tspecs


def _bert_pair(pp=1, moe=0):
    kw = dict(vocab=64, hidden_size=32, n_block=4, n_head=4, seq_len=8,
              intermediate_size=64, output_all_block=False,
              moe_experts=moe)
    if pp > 1:
        jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(
            data_parallel=8 // pp, pipeline_parallel=pp)))
        ctx = tnn.init_nncontext(device="cpu")
        ctx.config.pipeline_parallel = pp
    jlayer, tlayer = jsa.BERT(**kw), tsa.BERT(**kw)
    jp = jlayer.build(jax.random.PRNGKey(0), [(None, 8)] * 4)
    tp = tlayer.build(torch.Generator().manual_seed(0), [(None, 8)] * 4)
    return jlayer, jp, tlayer, tp


@pytest.mark.parametrize("axes", [dict(data=2, model=4),
                                  dict(data=4, model=2),
                                  dict(data=8)])
@pytest.mark.parametrize("fsdp", [False, True])
def test_bert_specs_match_jax(axes, fsdp):
    jmesh, tmesh = _meshes(**axes)
    rules = jsh.FSDP_RULES if fsdp else None
    specs = _assert_same_specs(*_bert_pair(), jmesh, tmesh, rules)
    if axes.get("model", 1) > 1:
        # Megatron: qkv and MLP-in columns, proj and MLP-out rows
        assert specs["block0/qkv_w"][1] == "model"
        assert specs["block0/proj_w"][0] == "model"
        assert specs["block0/mlp_in_w"][1] == "model"
        assert specs["block0/mlp_out_w"][0] == "model"


@pytest.mark.parametrize("axes", [dict(data=2, expert=4),
                                  dict(data=2, expert=2, model=2)])
def test_moe_transformer_specs_match_jax(axes):
    jmesh, tmesh = _meshes(**axes)
    specs = _assert_same_specs(*_bert_pair(moe=4), jmesh, tmesh)
    assert specs["block0/moe/w_in"][0] == "expert"


def test_stacked_pipeline_layout_specs_match_jax():
    jmesh, tmesh = _meshes(data=4, pipe=2)
    jl_, jp, tl_, tp = _bert_pair(pp=2)
    assert tuple(tp["blocks"]["qkv_w"].shape) == (4, 32, 96)
    specs = _assert_same_specs(jl_, jp, tl_, tp, jmesh, tmesh)
    assert specs["blocks/qkv_w"] == ("pipe", None, "model")
    assert tl_.param_pieces() == {"blocks/qkv_w": (2, 3),
                                  "blocks/qkv_b": (1, 3)}


def _layer_pairs():
    return [
        ("dense", lambda m: m.Dense(48, input_shape=(64,)), (None, 64)),
        ("dense_tall", lambda m: m.Dense(16, input_shape=(64,)),
         (None, 64)),
        ("sparse_dense", lambda m: m.SparseDense(24, input_shape=(40,)),
         (None, 40)),
        ("embedding", lambda m: m.Embedding(40, 24, input_shape=(5,)),
         (None, 5)),
        ("conv2d", lambda m: m.Convolution2D(16, 3, 3,
                                             input_shape=(4, 8, 8)),
         (None, 4, 8, 8)),
        ("conv1d", lambda m: m.Convolution1D(16, 3, input_shape=(8, 4)),
         (None, 8, 4)),
    ]


@pytest.mark.parametrize("case", _layer_pairs(), ids=lambda c: c[0])
@pytest.mark.parametrize("axes", [dict(data=8), dict(data=2, model=4)])
def test_layer_specs_match_jax_under_both_rules(case, axes):
    _, make, shape = case
    jmesh, tmesh = _meshes(**axes)
    jlayer, tlayer = make(jl), make(tl)
    jp = jlayer.build(jax.random.PRNGKey(0), shape)
    tp = tlayer.build(torch.Generator().manual_seed(0), shape)
    for rules in (None, jsh.FSDP_RULES):
        _assert_same_specs(jlayer, jp, tlayer, tp, jmesh, tmesh, rules)


def test_one_mesh_axis_shards_only_the_largest_divisible_dim():
    jmesh, tmesh = _meshes(data=8)
    fn = tsh.make_param_sharding_fn(_Graph(), tmesh, tsh.FSDP_RULES)
    layer = tl.Dense(48, input_shape=(64,))
    layer.build(torch.Generator(), (None, 64))
    fn = tsh.make_param_sharding_fn(_Graph(layer), tmesh, tsh.FSDP_RULES)
    assert fn({layer.name: {"kernel": (64, 48), "bias": (48,)}}) == \
        {layer.name: {"kernel": ("data", None), "bias": ("data",)}}
    assert fn({layer.name: {"kernel": (16, 48), "bias": (48,)}}) == \
        {layer.name: {"kernel": (None, "data"), "bias": ("data",)}}
    # equal dims: the first keeps the axis
    assert fn({layer.name: {"kernel": (48, 48), "bias": (48,)}})[
        layer.name]["kernel"] == ("data", None)


def test_an_indivisible_dim_replicates_and_warns_from_16k(caplog):
    jmesh, tmesh = _meshes(data=2, model=4)
    big, small = tl.Embedding(30522, 64), tl.Embedding(102, 32)
    for layer in (big, small):
        layer.build(torch.Generator(), (None, 5))
    fn = tsh.make_param_sharding_fn(_Graph(big, small), tmesh)
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.parallel"):
        specs = fn({big.name: {"table": (30522, 64)},
                    small.name: {"table": (102, 32)}})
    # BERT's vocabulary of 30,522 splits over 2 model ranks, not over 4
    assert specs[big.name]["table"] == (None, None)
    assert specs[small.name]["table"] == (None, None)
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 1 and "REPLICATING" in warned[0] and \
        big.name in warned[0]
    jbig = jl.Embedding(30522, 64)
    jbig.build(jax.random.PRNGKey(0), (None, 5))
    jspec = jsh.make_param_sharding_fn(_Graph(jbig), jmesh)(
        {jbig.name: {"table": np.zeros((30522, 64))}})[jbig.name]["table"]
    assert tuple(jspec.spec) in ((), (None, None))
    _, tmesh2 = _meshes(data=4, model=2)
    fn2 = tsh.make_param_sharding_fn(_Graph(big), tmesh2)
    assert fn2({big.name: {"table": (30522, 64)}})[big.name]["table"] == \
        ("model", None)


@pytest.mark.parametrize("spec", [None, (), (None,), (None, None),
                                  ("data",), (None, "model"),
                                  ((None, None),), (("data", "model"),)])
def test_spec_is_replicated_matches_jax(spec):
    from jax.sharding import PartitionSpec as P
    jspec = None if spec is None else P(*spec)
    assert tsh.spec_is_replicated(spec) == jsh.spec_is_replicated(jspec)


@pytest.mark.parametrize("mode,want", [("auto", None), ("none", None),
                                       ("default", "model"),
                                       ("fsdp", "data")])
def test_config_modes_and_set_param_sharding(mode, want):
    """On a mesh of one rank: "auto" and "none" lay nothing out, the
    others the rules' specs; an explicit ``set_param_sharding`` wins; a
    bad mode raises JAX's message."""
    tnn.init_nncontext(tnn.ZooConfig(param_sharding=mode), device="cpu")
    model = TSequential()
    model.add(tl.Dense(8, input_shape=(16,)))
    model.compile(optimizer="adam", loss="mse")
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    name = model.graph_function().layers[0].name
    kernel = trainer.param_specs.get(f"{name}.kernel")
    if want is None:
        assert kernel is None
    elif want == "model":
        assert kernel == (None, None)
    else:
        assert kernel == ("data", None)
    # nothing is cut on one rank
    assert trainer.shards == {}
    model.set_param_sharding(lambda params: {
        name: {"kernel": (None, "model"), "bias": ("model",)}})
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    assert trainer.param_specs[f"{name}.kernel"] == (None, "model")


def test_a_bad_mode_raises_as_in_jax():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(param_sharding="bad")))
    jmodel = JSequential()
    jmodel.add(jl.Dense(8, input_shape=(16,)))
    with pytest.raises(ValueError) as want:
        jmodel._config_param_sharding(jmodel.graph_function())
    tnn.init_nncontext(tnn.ZooConfig(param_sharding="bad"), device="cpu")
    model = TSequential()
    model.add(tl.Dense(8, input_shape=(16,)))
    with pytest.raises(ValueError) as got:
        model._config_param_sharding(model.graph_function())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rank", [0, 1])
def test_a_block_of_parts_is_its_share_of_each_part(rank):
    """The qkv kernel (h, 3h) at tp = 2: a rank's block is its half of q,
    of k and of v (its heads), three regions of the whole leaf."""
    h = 4
    mesh = RankMesh((1, 1, 1, 1, 2), rank)
    shard = tsh.LeafShard((h, 3 * h), (None, "model"), mesh, pieces=(1, 3))
    whole = np.arange(h * 3 * h, dtype=np.float32).reshape(h, 3 * h)
    block = shard.block_of(whole)
    cols = [c for part in range(3)
            for c in range(part * h + rank * 2, part * h + rank * 2 + 2)]
    np.testing.assert_array_equal(block, whole[:, cols])
    regions = shard.regions()
    assert len(regions) == 3
    for region, sl in regions:
        np.testing.assert_array_equal(
            block[sl], whole[tuple(slice(a, b) for a, b in region)])
    assert block.shape == (h, 3 * h // 2)
    # its copies on the data ranks: one of them writes it
    assert shard.replica_axes() == ()
    assert tsh.LeafShard((h, 3 * h), (None, "model"),
                         RankMesh((2, 1, 1, 1, 2), 2 + rank),
                         pieces=(1, 3)).replica_axes() == ("data",)


@pytest.mark.parametrize("spec,shape,want", [
    ((None, "model"), (8, 12), 0), (("model", None), (6, 8), 1),
    (("data", None), (8, 4), None), ((None,), (3,), None),
    ((None, None), (3, 8), 1), ((), (4,), 0)])
def test_gspmd_widens_the_first_unsharded_divisible_dim_as_jax(spec, shape,
                                                               want):
    assert tzero.widen_dim(spec, shape, 2) == want


def test_the_port_exports_jax_parallel_names():
    for name in jpar.__all__:
        assert hasattr(tpar, name), name


def test_a_split_head_is_refused():
    """Tensor parallelism computes on whole heads: a block of qkv columns
    that is not whole heads of q, k and v raises (GSPMD would split any
    columns; ROADMAP C25)."""
    layer = tl.TransformerLayer(n_block=1, n_head=2, vocab=10, seq_len=4,
                                hidden_size=8)
    layer.build_params(torch.Generator().manual_seed(0), (None, 4))
    p = dict(layer.block0)
    p["qkv_w"] = p["qkv_w"][:, :6]     # 2 columns each: half a head of 4
    p["qkv_b"] = p["qkv_b"][:6]
    with pytest.raises(ValueError, match="not whole heads"):
        layer._attention(p, torch.zeros(1, 4, 8), None, None, False)
