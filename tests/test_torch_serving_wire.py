"""The port's msgpack codec (``serving/wire.py``) against ``msgpack``, and
the file transport across the two packages.

``wire.packb(obj)`` must give the bytes of ``msgpack.packb(obj,
use_bin_type=True)`` and ``wire.unpackb(b)`` the object of
``msgpack.unpackb(b, raw=False)``, for every type a record carries:
hypothesis draws nested records, and the boundary cases pin every width
switch. Then the file queues: records written by the JAX package's
``InputQueue`` are served by the port's loop and read back by JAX's
``OutputQueue``, and the other way round, with the same weights on both
sides (probabilities within 1e-5: two float32 Dense products summed in
another order).
"""

import math
import os
import subprocess
import sys
import time

import jax
import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from analytics_zoo_tpu import serving as js
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import models as jm
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
from analytics_zoo_tpu_torch import serving as ts
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tm
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as TIM
from analytics_zoo_tpu_torch.serving import wire
from analytics_zoo_tpu_torch.utils import load_jax_params

PROB_TOL = 1e-5


def _ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(data):
    return msgpack.unpackb(data, raw=False)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_ints = st.one_of(st.integers(-2 ** 63, 2 ** 64 - 1),
                  st.integers(-300, 300))
_scalars = st.one_of(st.none(), st.booleans(), _ints,
                     st.floats(allow_nan=False), st.text(max_size=40),
                     st.binary(max_size=300))
_records = st.recursive(
    _scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.one_of(st.text(max_size=10),
                                  st.binary(max_size=10)), inner,
                        max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_records)
def test_packb_equals_msgpack_byte_for_byte(obj):
    assert wire.packb(obj) == _ref_pack(obj)


@settings(max_examples=300, deadline=None)
@given(_records)
def test_unpackb_equals_msgpack(obj):
    data = _ref_pack(obj)
    assert wire.unpackb(data) == _ref_unpack(data)


@settings(max_examples=100, deadline=None)
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_floats_round_trip_bit_for_bit(x):
    data = _ref_pack(x)
    assert wire.packb(x) == data
    got = wire.unpackb(data)
    assert isinstance(got, float)
    assert (math.isnan(got) and math.isnan(x)) or got == x


BOUNDARY_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
                 -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
BOUNDARY_LENGTHS = {"str": [0, 31, 32, 255, 256, 65535, 65536],
                    "bin": [0, 255, 256, 65535, 65536],
                    "array": [0, 15, 16, 65535, 65536],
                    "map": [0, 15, 16, 65535, 65536]}


def _sized(kind, n):
    if kind == "str":
        return "a" * n
    if kind == "bin":
        return b"\x07" * n
    if kind == "array":
        return [i % 200 for i in range(n)]
    return {f"k{i}": i for i in range(n)}


@pytest.mark.parametrize("n", BOUNDARY_INTS)
def test_integer_widths_match_msgpack(n):
    data = _ref_pack(n)
    assert wire.packb(n) == data
    assert wire.unpackb(data) == n


@pytest.mark.parametrize("kind,n", [(k, n) for k, ns in
                                    BOUNDARY_LENGTHS.items() for n in ns])
def test_length_headers_match_msgpack(kind, n):
    obj = _sized(kind, n)
    data = _ref_pack(obj)
    assert wire.packb(obj) == data
    assert wire.unpackb(data) == _ref_unpack(data)


def test_tuples_bytearrays_memoryviews_and_non_ascii_text():
    obj = {"t": (1, 2.5, "é"), "b": bytearray(b"xy"),
           "m": memoryview(b"abc"), "u": "日本語" * 20}
    assert wire.packb(obj) == _ref_pack(obj)
    assert wire.unpackb(wire.packb(obj)) == _ref_unpack(_ref_pack(obj))


def test_float32_input_is_read_as_msgpack_reads_it():
    data = b"\xca" + np.float32(1.1).byteswap().tobytes()
    assert wire.unpackb(data) == _ref_unpack(data)


@pytest.mark.parametrize("key", [1, -5, 2.5, None, True, (1, 2)])
def test_non_str_map_keys_are_refused_as_msgpack_refuses_them(key):
    data = _ref_pack({key: 1})
    with pytest.raises(ValueError):
        _ref_unpack(data)
    with pytest.raises(ValueError):
        wire.unpackb(data)


@pytest.mark.parametrize("data", [_ref_pack([1, 2, 3])[:-1],
                                  _ref_pack("abc") + b"\x01", b"\xc1",
                                  _ref_pack(b"x" * 300)[:100]])
def test_truncated_extra_and_reserved_bytes_raise(data):
    with pytest.raises(ValueError):
        _ref_unpack(data)
    with pytest.raises(ValueError):
        wire.unpackb(data)


@pytest.mark.parametrize("obj", [2 ** 64, -2 ** 63 - 1])
def test_integers_out_of_range_raise(obj):
    with pytest.raises(OverflowError):
        _ref_pack(obj)
    with pytest.raises(OverflowError):
        wire.packb(obj)


@pytest.mark.parametrize("obj", [{1, 2}, object(), np.int64(3)])
def test_unsupported_objects_raise_type_error(obj):
    with pytest.raises(TypeError):
        _ref_pack(obj)
    with pytest.raises(TypeError):
        wire.packb(obj)


def test_importing_the_port_serving_loads_no_msgpack_yaml_or_cv2():
    code = ("import sys, analytics_zoo_tpu_torch.serving, "
            "analytics_zoo_tpu_torch.utils.slo, "
            "analytics_zoo_tpu_torch.pipeline.inference.inference_summary; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('msgpack', 'yaml', 'cv2', 'jax', 'analytics_zoo_tpu')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


# ---------------------------------------------------------------------------
# the file transport across the packages
# ---------------------------------------------------------------------------

def _dense(layers, models):
    seq = models.Sequential()
    seq.add(layers.Flatten(input_shape=(2, 4, 4)))
    seq.add(layers.Dense(12, activation="softmax"))
    return seq


@pytest.fixture
def paired():
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    jmodel = _dense(jl, jm)
    tmodel = _dense(tl, tm)
    load_jax_params(tmodel, jax.tree.map(np.asarray, jmodel.get_params()))
    yield jmodel, tmodel
    tnn.set_nncontext(None)


CONFIG = {"data": {"image_shape": "2, 4, 4"},
          "params": {"batch_size": 4, "top_n": 3}}
N_RECORDS = 9


def _images():
    rs = np.random.default_rng(3)
    return {f"img-{i}": rs.standard_normal((2, 4, 4)).astype(np.float32)
            for i in range(N_RECORDS)}


def _serve(pkg, model, root, images, client_pkg):
    """Enqueue ``images`` with ``client_pkg``'s InputQueue on its
    FileStreamQueue at ``root``, serve them with ``pkg``'s loop on its own
    FileStreamQueue over the same directory, and read them back with
    ``client_pkg``'s OutputQueue."""
    srv_mod = js if pkg == "jax" else ts
    cli_mod = js if client_pkg == "jax" else ts
    client_q = cli_mod.FileStreamQueue(str(root))
    iq = cli_mod.InputQueue(backend=client_q)
    for uri, img in images.items():
        iq.enqueue(uri, t=img)
    im = (JIM if pkg == "jax" else TIM)().load_keras_net(model)
    server = srv_mod.ClusterServing(
        model=im, helper=srv_mod.ClusterServingHelper(config=CONFIG),
        backend=srv_mod.FileStreamQueue(str(root))).start()
    try:
        got = cli_mod.OutputQueue(backend=client_q).wait_all(
            list(images), timeout=60)
    finally:
        server.stop()
    return got, server


def _top3(probs):
    top = np.argsort(probs, axis=-1)[:, ::-1][:, :3]
    return top, np.take_along_axis(probs, top, axis=-1)


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("torch", "jax"), ("jax", "torch")])
def test_each_package_serves_the_others_file_queue(paired, tmp_path,
                                                   server_pkg, client_pkg):
    jmodel, tmodel = paired
    images = _images()
    model = jmodel if server_pkg == "jax" else tmodel
    got, server = _serve(server_pkg, model, tmp_path, images, client_pkg)
    assert sorted(got) == sorted(images)
    want = tmodel.predict(np.stack(list(images.values())), batch_size=16)
    ids, probs = _top3(want)
    for i, uri in enumerate(images):
        row = np.asarray(got[uri])
        assert row.shape == (3, 2)
        np.testing.assert_array_equal(row[:, 0], ids[i])
        np.testing.assert_allclose(row[:, 1], probs[i], rtol=0,
                                   atol=PROB_TOL)
        assert got[uri].timing["uri"] == uri
    stats = server.pipeline_stats()
    assert stats["results_out"] == N_RECORDS and stats["dropped"] == 0
    assert stats["queue"]["duplicates"] == 0
    assert stats["queue"]["seq_gaps"] == 0


def test_a_record_file_is_the_same_bytes_from_either_package(tmp_path):
    rec = {"uri": "r", "tensors": {"t": {"shape": [2, 3],
                                         "data": b"\x00" * 24}},
           "enqueue_ts_ms": 1.5, "trace_id": "abc"}
    for pkg, mod in (("jax", js), ("torch", ts)):
        mod.FileStreamQueue(str(tmp_path / pkg)).enqueue(dict(rec))
    files = {pkg: os.listdir(tmp_path / pkg / "image_stream")
             for pkg in ("jax", "torch")}
    blobs = {pkg: (tmp_path / pkg / "image_stream" / files[pkg][0])
             .read_bytes() for pkg in files}
    assert blobs["jax"] == blobs["torch"] == _ref_pack(rec)
    got = ts.FileStreamQueue(str(tmp_path / "jax")).read_batch(4, 1.0)
    (_rid, back), = got
    assert back["dequeue_ts_ms"] <= time.time() * 1e3
    back.pop("dequeue_ts_ms")
    assert back == rec
