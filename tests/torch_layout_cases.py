"""The JAX side of the port's layout tests (tensor, pipeline and expert
parallelism, FSDP): the small BERT classifier of
``test_torch_data_parallel.py`` at a given width, trained by the JAX
package on the first devices of the 8-device CPU mesh under the same
mesh axes the port's gang uses, and the helpers that line the two
packages' leaves up.

Tolerances, float32 (``test_torch_data_parallel.py``'s, which PR 17's
gates use too): each step's loss to 1e-5, the trained whole weights to
2e-5, ``predict`` to 1e-5, and a gradient (one SGD step at learning rate
1 moves each weight by minus its gradient) to 1e-3 of the leaf's
gradient norm.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import tempfile

import jax
import numpy as np

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    self_attention as jsa
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from test_torch_data_parallel import bert_data  # noqa: F401 (re-exported)

LOSS_TOL, WEIGHT_TOL, PREDICT_TOL, GRAD_TOL = 1e-5, 2e-5, 1e-5, 1e-3
GANG_TIMEOUT_S = 240.0
ROWS, BATCH, EPOCHS = 16, 8, 2
#: evaluate's batch: 16 rows make batches of 6, 6 and 4 (padded to 6),
#: and a data rank's block of 6 rows at dp = 4 pads to 8; under a pipe
#: axis 8, which the M = 4 microbatches divide (both packages refuse a
#: batch they do not)
EVAL_BATCH = 6


def eval_batch(config) -> int:
    return 8 if config.get("pipeline_parallel", 1) > 1 else EVAL_BATCH
#: the classifier's widths: 4 heads split over 4 model ranks, and a
#: vocabulary that splits over 2 ranks but not over 4 (BERT's 30,522
#: does the same: at tp = 4 the token table stays whole, JAX's rule)
ARCH = dict(vocab=102, hidden=128, seq_len=32, n_block=2, n_head=4)
AXES = ("data", "pipe", "seq", "expert", "model")


def jax_classifier(arch):
    bert = jsa.BERT(vocab=arch["vocab"], hidden_size=arch["hidden"],
                    n_block=arch.get("n_block", 2),
                    n_head=arch.get("n_head", 2), seq_len=arch["seq_len"],
                    intermediate_size=2 * arch["hidden"], hidden_p_drop=0.0,
                    attn_p_drop=0.0, output_all_block=False,
                    moe_experts=arch.get("moe_experts", 0))
    length = arch["seq_len"]
    ins = [jl.Input(shape=(length,), name="tokens"),
           jl.Input(shape=(length,), name="positions"),
           jl.Input(shape=(length,), name="segments"),
           jl.Input(shape=(1, 1, length), name="mask")]
    _, pooled = bert(ins)
    return JModel(ins, jl.Dense(2, activation="softmax")(pooled))


def world_of(config) -> int:
    return int(np.prod([max(int(config.get(f, 1)), 1) for f in (
        "data_parallel", "pipeline_parallel", "sequence_parallel",
        "expert_parallel", "model_parallel")]))


def jax_context(config):
    jnn.set_nncontext(None)
    jnn.set_nncontext(jnn.ZooContext(
        jnn.ZooConfig(log_every_n_steps=1, **config),
        devices=jax.devices()[:world_of(config)]))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    """A nested dict as {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def port_name(jname: str) -> str:
    """A JAX leaf name ("bert_7.block0.qkv_w") as the port's
    ("bert_1.block0.qkv_w"): each package numbers its own layers, and
    the classifier has one layer of each class."""
    layer, _, rest = jname.partition(".")
    return re.sub(r"_\d+$", "_1", layer) + "." + rest


def by_port_name(tree):
    return {port_name(k): v for k, v in flat(tree).items()}


@functools.lru_cache(maxsize=None)
def jax_fit(config_items, arch_items, lr=None, epochs=EPOCHS,
            batch=BATCH, seed=0):
    """JAX's fit of the classifier under ``config`` (a sorted tuple of
    items): (initial params tree, step losses, trained params by port
    name, predictions of the data, the data, the params' specs by port
    name, the optimizer leaves' specs by port name and kind)."""
    config, arch = dict(config_items), dict(arch_items)
    x, y = bert_data(seed, ROWS)
    with _pipeline_attention(config):
        return _jax_fit(config, arch, x, y, lr, epochs, batch)


@contextlib.contextmanager
def _pipeline_attention(config):
    """JAX's pipelined trunk traces only on its reference attention
    fallback: the blockwise fallback's scan carry fails this JAX's
    shard_map replication check (its own test_bert_pipeline_* fail so in
    the slow tier; ROADMAP C). The reference computes the same softmax
    attention whole."""
    if config.get("pipeline_parallel", 1) <= 1:
        yield
        return
    old = os.environ.get("ZOO_TPU_ATTN_FALLBACK")
    os.environ["ZOO_TPU_ATTN_FALLBACK"] = "reference"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ZOO_TPU_ATTN_FALLBACK", None)
        else:
            os.environ["ZOO_TPU_ATTN_FALLBACK"] = old


def _jax_fit(config, arch, x, y, lr, epochs, batch):
    jax_context(config)
    jmodel = jax_classifier(arch)
    jmodel.compile(optimizer="adam" if lr is None else
                   jopt.SGD(lr=lr),
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    with tempfile.TemporaryDirectory() as d:
        jmodel.set_tensorboard(d, "jax")
        params = _np_tree(jmodel.get_params())
        jmodel.fit(x, y, batch_size=batch, nb_epoch=epochs)
        losses = [v for _, _, _, v in jmodel.get_train_summary("Loss")]
    final = by_port_name(_np_tree(jmodel.get_params()))
    preds = np.asarray(jmodel.predict(x, batch_size=batch))
    evaluated = jmodel.evaluate(x, y, batch_size=eval_batch(config))
    trainer = jmodel._ensure_trainer()
    specs = {port_name(k): spec_of(v) for k, v in flat(
        trainer._param_shardings(trainer.params)).items()}
    jnn.set_nncontext(None)
    return params, losses, final, (preds, evaluated), (x, y), specs


def spec_of(sharding) -> tuple:
    return tuple(getattr(sharding, "spec", ()) or ())


def padded(spec, ndim) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def block_shape(shape, spec, mesh_shape) -> tuple:
    """The shape of one device's block of a leaf laid out as ``spec``."""
    out = list(shape)
    for d, axis in enumerate(padded(spec, len(shape))):
        if axis is not None:
            out[d] //= mesh_shape[axis]
    return tuple(out)


def mesh_shape(config) -> dict:
    sizes = {"pipe": config.get("pipeline_parallel", 1),
             "seq": config.get("sequence_parallel", 1),
             "expert": config.get("expert_parallel", 1),
             "model": config.get("model_parallel", 1)}
    fixed = int(np.prod(list(sizes.values())))
    data = config.get("data_parallel", -1)
    sizes["data"] = data if data > 0 else world_of(config) // fixed
    return {a: int(sizes[a]) for a in AXES}


def unstack(tree: dict) -> dict:
    """{name: leaf} with stacked ``blocks.*`` leaves as ``block{i}.*``."""
    out = {}
    for k, v in tree.items():
        m = re.match(r"(.*)\.blocks\.(.*)", k)
        if m:
            for i in range(v.shape[0]):
                out[f"{m.group(1)}.block{i}.{m.group(2)}"] = v[i]
        else:
            out[k] = v
    return out


def assert_fit_matches(got, losses, final, preds, weight_tol=WEIGHT_TOL):
    """Every rank's step losses, predictions and evaluation, and rank 0's
    whole trained weights, against JAX's."""
    preds, evaluated = preds
    for r, rank in enumerate(got):
        assert set(rank["evaluate"]) == set(evaluated)
        for k, v in evaluated.items():
            np.testing.assert_allclose(rank["evaluate"][k], v, rtol=0,
                                       atol=PREDICT_TOL,
                                       err_msg=f"{k}, rank {r}")
        assert len(rank["losses"]) == len(losses)
        np.testing.assert_allclose(rank["losses"], losses, rtol=0,
                                   atol=LOSS_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(rank["predict"], preds, rtol=0,
                                   atol=PREDICT_TOL, err_msg=f"rank {r}")
    # a leaf no axis cuts is the same on every rank (the model, pipe and
    # expert ranks update it from the same gradient)
    for r, rank in enumerate(got[1:], start=1):
        for name, leaf in rank["whole_leaves"].items():
            np.testing.assert_array_equal(leaf, got[0]["whole_leaves"][name],
                                          err_msg=f"{name}, rank {r}")
    have = got[0]["params"]
    assert set(have) == set(final)
    if weight_tol is None:
        return
    for name, p in have.items():
        np.testing.assert_allclose(p, final[name], rtol=0, atol=weight_tol,
                                   err_msg=name)


def assert_moves_match(got, init, final, tol=GRAD_TOL):
    """Each leaf's move from ``init`` against JAX's, to ``tol`` of the
    move's norm. After one SGD step at learning rate 1 the move is minus
    the gradient."""
    start = by_port_name(init)
    have = got[0]["params"]
    assert set(have) == set(final)
    for name, p in have.items():
        move_port = p - start[name]
        move_jax = final[name] - start[name]
        scale = max(float(np.linalg.norm(move_jax)), 1e-12)
        err = float(np.linalg.norm(move_port - move_jax)) / scale
        assert err <= tol, (name, err)


def assert_gradients_match(got, init, final):
    """One SGD step at learning rate 1: each leaf's move (minus its
    gradient) against JAX's, to GRAD_TOL of the gradient's norm."""
    assert_moves_match(got, init, final, GRAD_TOL)


def assert_blocks(got, specs, config):
    """Each rank holds the block JAX's spec gives a device of every
    leaf, and its moments are the same blocks (ZeRO stage 0)."""
    shape = mesh_shape(config)
    whole = got[0]["params"]
    for r, rank in enumerate(got):
        for name, local in rank["shapes"].items():
            want = block_shape(whole[name].shape, specs[name], shape)
            assert tuple(local) == want, (r, name, local, specs[name])
            assert padded(rank["specs"].get(name, ()), len(local)) == \
                padded(specs[name], len(local)), (name, specs[name])


def jax_moment_blocks(config):
    """JAX's trainer under ``config``: its ZeRO mode and the block shape
    of each optimizer moment by (port parameter name, occurrence)."""
    jax_context(config)
    jmodel = jax_classifier(ARCH)
    jmodel.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    trainer = jmodel._ensure_trainer()
    trainer.ensure_initialized()
    mode = trainer._zero_mode_resolved()
    shape = mesh_shape(config)
    names = set(by_port_name(jax.tree.map(np.asarray,
                                                trainer.params)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            trainer.opt_state)[0]:
        keys = [str(getattr(p, "key", getattr(p, "name", p)))
                for p in path]
        for start in range(len(keys)):
            name = port_name(".".join(keys[start:]))
            if name in names:
                out.setdefault(name, []).append(block_shape(
                    leaf.shape, spec_of(leaf.sharding), shape))
                break
    jnn.set_nncontext(None)
    return mode, out
