"""The port's process group, rank mesh and collectives against the JAX
package on the CPU.

- The launcher's environment contract (``_maybe_init_distributed``): the
  same partial or inconsistent environments raise with JAX's messages; a
  mesh that does not cover the world raises JAX's ``ValueError``, tensor,
  pipeline and expert parallelism asked for on one process included.
- The rank mesh numbers ranks as JAX's mesh numbers devices (row-major
  over data, pipe, seq, expert, model), and its process groups are the
  slices of each axis (checked in a gang of four ranks over gloo).
- Each collective and its backward, at world sizes 2 and 4 over gloo,
  against the ``jax.lax`` collective inside ``shard_map`` on the
  8-device CPU mesh (``check_vma=False``, so psum transposes to psum, as
  the port's all-reduce does), on the same seeded inputs and cotangents:
  float32 sums of at most four terms, 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.common.jax_compat import shard_map
from analytics_zoo_tpu.parallel import make_mesh as jax_make_mesh
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.parallel import AXES, RankMesh, collectives

TOL = 1e-6
GANG_TIMEOUT_S = 120.0
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "ppermute", "ppermute_partial")
ENV = ("ZOO_TPU_COORDINATOR", "ZOO_TPU_NUM_PROCESSES", "ZOO_TPU_PROCESS_ID")


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


# ---------------------------------------------------------------------------
# the environment contract
# ---------------------------------------------------------------------------

BAD_ENVS = {
    "world without coordinator": {"ZOO_TPU_NUM_PROCESSES": "2"},
    "rank without coordinator": {"ZOO_TPU_PROCESS_ID": "0"},
    "coordinator alone": {"ZOO_TPU_COORDINATOR": "127.0.0.1:1"},
    "coordinator without rank": {"ZOO_TPU_COORDINATOR": "127.0.0.1:1",
                                 "ZOO_TPU_NUM_PROCESSES": "2"},
    "not integers": {"ZOO_TPU_COORDINATOR": "127.0.0.1:1",
                     "ZOO_TPU_NUM_PROCESSES": "two",
                     "ZOO_TPU_PROCESS_ID": "0"},
    "rank out of range": {"ZOO_TPU_COORDINATOR": "127.0.0.1:1",
                          "ZOO_TPU_NUM_PROCESSES": "2",
                          "ZOO_TPU_PROCESS_ID": "2"},
    "empty world": {"ZOO_TPU_COORDINATOR": "127.0.0.1:1",
                    "ZOO_TPU_NUM_PROCESSES": "0",
                    "ZOO_TPU_PROCESS_ID": "0"},
}


def _set_env(monkeypatch, env):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("case", sorted(BAD_ENVS))
def test_a_partial_or_inconsistent_environment_raises_as_in_jax(
        monkeypatch, case):
    _set_env(monkeypatch, BAD_ENVS[case])
    with pytest.raises(RuntimeError) as want:
        jnn._maybe_init_distributed()
    with pytest.raises(RuntimeError) as got:
        tnn._maybe_init_distributed(device="cpu")
    assert str(got.value) == str(want.value)
    assert not torch.distributed.is_initialized()


def test_no_environment_is_a_world_of_one(monkeypatch):
    _set_env(monkeypatch, {})
    assert tnn._maybe_init_distributed(device="cpu") is None
    ctx = tnn.init_nncontext(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (ctx.process_index, ctx.num_processes, ctx.num_devices) == \
        (0, 1, 1)
    assert ctx.backend is None
    assert ctx.mesh.shape == dict(zip(AXES, (1, 1, 1, 1, 1)))
    assert all(ctx.mesh.group(a) is None for a in AXES)


def test_a_mesh_that_does_not_cover_the_world_raises_as_in_jax():
    with pytest.raises(ValueError) as want:
        jnn.ZooContext(jnn.ZooConfig(sequence_parallel=3),
                       devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        tnn.ZooContext(tnn.ZooConfig(sequence_parallel=3), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field", ["model_parallel", "pipeline_parallel",
                                   "expert_parallel"])
def test_the_modes_of_a12_2_raise(field):
    """Tensor, pipeline and expert parallelism run (test_torch_tensor_
    parallel.py, test_torch_pipeline_parallel.py, test_torch_expert_
    parallel.py): asked for on one process each meets JAX's mesh check,
    as sequence parallelism does, with JAX's message."""
    with pytest.raises(ValueError) as want:
        jnn.ZooContext(jnn.ZooConfig(**{field: 2}),
                       devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="needs 2 devices but 1") as got:
        tnn.ZooContext(tnn.ZooConfig(**{field: 2}), device="cpu")
    assert str(got.value) == str(want.value)


def test_the_backend_rule(monkeypatch):
    assert tnn.choose_backend(torch.device("cpu"), 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda", 0)
    assert tnn.choose_backend(cuda, 4) == "nccl"
    assert tnn.choose_backend(cuda, 1) == "nccl"
    # ranks sharing a card: NCCL refuses two ranks on one GPU
    assert tnn.choose_backend(cuda, 5) == "gloo"


def test_a_ranks_device_is_its_local_rank_modulo_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "3")
    assert tnn._resolve_device(None) == torch.device("cuda", 1)
    assert tnn._resolve_device("cuda") == torch.device("cuda", 1)
    assert tnn._resolve_device("cuda:0") == torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the rank mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1, 2, 1, 1), (4, 1, 1, 1, 1),
                                   (1, 1, 4, 1, 1), (2, 1, 4, 1, 1)])
def test_ranks_are_numbered_as_jax_numbers_devices(shape):
    n = int(np.prod(shape))
    devices = jax.devices()[:n]
    jmesh = jax_make_mesh(*shape, devices=devices)
    ids = {d.id: i for i, d in enumerate(devices)}
    want = np.vectorize(lambda d: ids[d.id])(jmesh.devices)
    np.testing.assert_array_equal(RankMesh(shape).ranks, want)
    for rank in range(n):
        mesh = RankMesh(shape, rank)
        coords = tuple(int(c) for c in np.argwhere(want == rank)[0])
        assert tuple(mesh.index(a) for a in AXES) == coords


def test_the_groups_are_the_slices_of_each_axis():
    got = workers.run_gang(workers.mesh_worker, 4,
                           config=dict(data_parallel=2, sequence_parallel=2),
                           timeout=GANG_TIMEOUT_S)
    seq = [[0, 1], [0, 1], [2, 3], [2, 3]]
    data = [[0, 2], [1, 3], [0, 2], [1, 3]]
    for rank, r in enumerate(got):
        assert r["groups"] == {"data": data[rank], "seq": seq[rank]}
        assert r["index"] == {"data": rank // 2, "seq": rank % 2}


# ---------------------------------------------------------------------------
# the collectives against jax.lax inside shard_map
# ---------------------------------------------------------------------------

SEED = 3


@functools.lru_cache(maxsize=None)
def _port_collectives(world):
    return workers.run_gang(workers.collectives_worker, world, args=(SEED,),
                            config=dict(data_parallel=world),
                            timeout=GANG_TIMEOUT_S)


def _jax_collective(name, xs, gs):
    n = len(xs)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    perm = [(j, (j + 1) % n) for j in range(n)] if name == "ppermute" \
        else [(0, 1)]

    def per(x):
        x = x[0]
        if name == "all_reduce":
            y = jax.lax.psum(x, "x")
        elif name == "all_gather":
            y = jax.lax.all_gather(x, "x", axis=1, tiled=True)
        elif name == "reduce_scatter":
            y = jax.lax.psum_scatter(x, "x", scatter_dimension=2,
                                     tiled=True)
        elif name == "all_to_all":
            y = jax.lax.all_to_all(x, "x", 0, 2, tiled=True)
        else:
            y = jax.lax.ppermute(x, "x", perm)
        return y[None]

    f = shard_map(per, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                  check_vma=False)
    y, vjp = jax.vjp(f, jnp.stack(xs))
    (gx,) = vjp(jnp.stack(gs))
    return np.asarray(y), np.asarray(gx)


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("world", [2, 4])
def test_each_collective_and_its_backward_match_jax(world, name):
    got = _port_collectives(world)
    xs = [np.random.default_rng(SEED + r).standard_normal(
        (world * 2, 3, world * 2)).astype(np.float32) for r in range(world)]
    ys = [got[r][name][0] for r in range(world)]
    gs = [np.random.default_rng(SEED + 100 + r).standard_normal(
        ys[r].shape).astype(np.float32) for r in range(world)]
    want_y, want_g = _jax_collective(name, xs, gs)
    for r in range(world):
        np.testing.assert_allclose(ys[r], want_y[r], rtol=0, atol=TOL,
                                   err_msg=f"{name} output, rank {r}")
        np.testing.assert_allclose(got[r][name][1], want_g[r], rtol=0,
                                   atol=TOL, err_msg=f"{name} grad, rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_the_call_counter_and_the_backend(world):
    got = _port_collectives(world)
    calls = got[0]["calls"]
    # one call forward and one backward each; the two ppermute cases
    assert {k: v["calls"] for k, v in calls.items()} == {
        "all_reduce": 2, "all_gather": 2, "reduce_scatter": 2,
        "all_to_all": 2, "ppermute": 4}
    assert all(v["host_routed"] == 0 for v in calls.values())
    shape, backend = got[0]["mesh"]
    assert shape["data"] == world and backend == "gloo"


def test_one_rank_makes_no_call():
    collectives.CALLS.reset()
    x = torch.randn(4, 6, requires_grad=True)
    y = collectives.all_reduce(x) + collectives.all_gather(x, None, 1) \
        .sum() + collectives.reduce_scatter(x) + \
        collectives.all_to_all(x, None, 0, 1) + \
        collectives.ppermute(x, None, [(0, 0)])
    y.sum().backward()
    assert collectives.CALLS.snapshot() == {}
    np.testing.assert_allclose(collectives.ppermute(x, None, []).detach(),
                               np.zeros((4, 6)))
