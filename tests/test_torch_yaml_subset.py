"""The port's YAML-subset reader against PyYAML's ``safe_load``.

The port reads Cluster Serving's ``config.yaml`` without PyYAML
(``analytics_zoo_tpu_torch/utils/yaml_subset.py``). Held here, exactly
(``==`` on the parsed objects, floats included):

- (a) the reader equals ``yaml.safe_load`` on ``zoo-serving init``'s
  template, on the template with every commented key uncommented, on
  every config the JAX package's tests and smoke drivers write (and the
  port's own), on YAML 1.1 scalar edge cases, and on nested dicts drawn
  by hypothesis and dumped by ``yaml.safe_dump``;
- (b) the port's ``ClusterServingHelper`` reads each of those configs
  to the attributes JAX's reads;
- the helper builds with PyYAML hidden from ``sys.modules``;
- text outside the subset raises with its line number.
"""

import ast
import dataclasses
import re
import string
import sys
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from analytics_zoo_tpu.serving import cli as jcli
from analytics_zoo_tpu.serving import fleet_smoke, net_smoke, route_smoke, \
    shard_smoke
from analytics_zoo_tpu.serving.cluster_serving import \
    ClusterServingHelper as JHelper
from analytics_zoo_tpu_torch.serving import cli as tcli
from analytics_zoo_tpu_torch.serving.cluster_serving import \
    ClusterServingHelper as THelper
from analytics_zoo_tpu_torch.utils.yaml_subset import (YamlSubsetError,
                                                       safe_load)

TESTS = Path(__file__).resolve().parent

FILL = {"stream_dir": "/tmp/zoo-stream", "stub_ms": 2.0,
        "health_timeout": 3.0, "port": 6380, "target_ms": 100.0,
        "idle_s": 1.5, "src": "shard://127.0.0.1:7001,7002",
        "d": "/tmp/stream dir", "trace_dir": "/tmp/traces"}


def _uncomment(template: str) -> str:
    """Every commented-out key of the template turned on: ``# key:`` and
    ``#   - item`` lines lose their ``# ``; notes (``## ...`` and the
    ``# transport: ...`` line about ``data.src``) stay comments."""
    out = []
    for line in template.splitlines():
        m = re.match(r"^(\s*)# (\s*(?!transport:)(?:[A-Za-z_]\w*:|- ).*)$",
                     line)
        out.append(m.group(1) + m.group(2) if m else line)
    return "\n".join(out) + "\n"


def _module_constant(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _corpus():
    docs = {
        "template": jcli.CONFIG_TEMPLATE,
        "template_uncommented": _uncomment(jcli.CONFIG_TEMPLATE),
        "port_template": tcli.CONFIG_TEMPLATE,
        "port_template_uncommented": _uncomment(tcli.CONFIG_TEMPLATE),
    }
    for mod in (fleet_smoke, net_smoke, route_smoke, shard_smoke):
        docs[mod.__name__.rsplit(".", 1)[1]] = mod.CONFIG_TMPL.format(**FILL)
    fleet_cfg = _module_constant(TESTS / "test_serving_fleet.py",
                                 "_FLEET_CFG").format(**FILL)
    docs["test_serving_fleet"] = fleet_cfg
    docs["test_serving_fleet_knobs"] = \
        fleet_cfg + "  max_restarts: 4\n  restart_backoff_s: 2.5\n"
    auto = _module_constant(TESTS / "test_fleet_autoscale.py",
                            "_CFG").format(**FILL)
    docs["test_fleet_autoscale"] = auto
    docs["test_fleet_autoscale_degenerate"] = auto.replace(
        "min_workers: 1", "min_workers: 2").replace(
        "max_workers: 4", "max_workers: 2")
    docs["test_trace_slo"] = _module_constant(
        TESTS / "test_trace_slo.py", "_FLEET_CFG").format(**FILL)
    docs["test_serving_helper"] = (
        "model:\n  path: /tmp/m\ndata:\n  src:\n  image_shape: 3, 8, 8\n"
        "params:\n  batch_size: 2\n  top_n: 1\n")
    docs["test_serving_lifecycle"] = (
        "model:\n  path: /tmp/model\n"
        "data:\n  src: file:/tmp/stream\n  image_shape: 3, 16, 16\n"
        "params:\n  batch_size: 4\n  top_n: 2\n")
    docs["test_model_registry"] = (
        "model:\n  path: null\n"
        "data:\n  image_shape: 3, 16, 16\n"
        "registry:\n  root: /tmp/reg\n  default_model: img\n")
    docs["test_socket_queue"] = "data:\n  src: socket://127.0.0.1:6380\n"
    for shard_cfg in (
            {"model": {"path": "", "stub_ms_per_batch": 1.0},
             "data": {"src": "shard://127.0.0.1:7001,127.0.0.1:7002",
                      "image_shape": "3,4,4"},
             "params": {"batch_size": 4}},
            {"model": {"path": "", "stub_ms_per_batch": 1.0},
             "data": {"src": None, "image_shape": "3,4,4"},
             "params": {"batch_size": 4, "stream_maxlen": 100000},
             "slo": {"classes": [
                 {"name": "premium", "model": "m1", "weight": 3,
                  "priority": 0,
                  "objectives": [{"name": "latency", "p99_ms": 60000}]},
                 {"name": "batch", "model": "m2", "weight": 1,
                  "priority": 1, "shed_wait_ms": 60000}]}}):
        docs[f"test_shard_fabric_{len(docs)}"] = yaml.safe_dump(shard_cfg)
    for name in ("test_torch_fleet.py", "test_torch_fleet_routing.py"):
        for const in ("_SOCKET_FLEET_CFG", "_ROUTE_CFG"):
            try:
                docs[f"{name}:{const}"] = _module_constant(
                    TESTS / name, const).format(**FILL)
            except KeyError:
                continue
    return docs


CORPUS = _corpus()


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_reader_equals_safe_load_on_serving_configs(name):
    text = CORPUS[name]
    want = yaml.safe_load(text)
    assert want, name           # every config parses to something
    assert safe_load(text) == want


def test_uncommented_template_turns_on_every_section():
    cfg = safe_load(_uncomment(jcli.CONFIG_TEMPLATE))
    assert set(cfg) == {"model", "data", "params", "generate", "registry",
                        "slo"}
    assert cfg["params"]["pipelined"] is True
    assert cfg["params"]["bucket_sizes"] == "1,2,4,8,16,32"
    assert cfg["generate"]["speculative"] == {"k": 0,
                                              "draft_ms_per_step": 0.1}
    assert [c["name"] for c in cfg["slo"]["classes"]] == ["premium",
                                                          "batch"]
    assert cfg["slo"]["objectives"][0] == {"name": "latency", "p99_ms": 250}
    assert safe_load(jcli.CONFIG_TEMPLATE)["data"]["image_shape"] == \
        "3, 224, 224"
    # the port's `init` writes the JAX package's keys
    assert safe_load(tcli.CONFIG_TEMPLATE) == \
        safe_load(jcli.CONFIG_TEMPLATE)


SCALARS = """\
t1: true
t2: True
t3: TRUE
y: yes
Y: Yes
n: no
on1: on
off1: OFF
n1: null
n2: ~
n3:
i1: 42
i2: -17
i3: +5
i4: 0
i5: 012
i6: 0x1F
i7: 0b101
i8: 1_000_000
i9: 1:30
f1: 1.5
f2: -0.25
f3: 1.0e+20
f4: 1e5
f5: 1.5e5
f6: .5
f7: .inf
f8: -.Inf
f9: 6.
f10: 190:20:30.15
s1: 3, 224, 224
s2: hello world
s3: 'quoted # not a comment'
s4: "tab\\there \\u00e9 \\x41"
s5: it's plain # but this is a comment
s6: 'it''s'
s7: file:/tmp/a#b
s8: "true"
s9: '123'
s10: a:b
s11: -dash
l1: [1, 'two', "3", [4, 5], [], yes]
l2: []
m1: {}
"key with spaces": 1
'7': seven
8: eight
"""


def test_scalar_resolution_equals_pyyaml():
    assert safe_load(SCALARS) == yaml.safe_load(SCALARS)


def test_nan_resolves_as_pyyaml():
    got, want = safe_load("x: .nan\n")["x"], yaml.safe_load("x: .nan\n")["x"]
    assert got != got and want != want


NESTED = """\
top:
  inner:
    deep: 1
  seq:
  - a
  - b: 2
    c: [3]
  - - nested
    - list
  indented_seq:
    - x
    - y
after: 2
- not allowed here
"""


def test_block_structure_equals_pyyaml():
    text = NESTED.rsplit("- not allowed here\n", 1)[0]
    assert safe_load(text) == yaml.safe_load(text)
    assert safe_load("- a\n- b: 1\n  c: 2\n") == \
        yaml.safe_load("- a\n- b: 1\n  c: 2\n")
    assert safe_load("plain") == "plain"
    assert safe_load("") is None and safe_load("# only a comment\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: |\n  block\n", 1),
    ("a: >\n  folded\n", 1),
    ("a: &anchor 1\nb: *anchor\n", 1),
    ("a: !!str 1\n", 1),
    ("---\na: 1\n", 1),
    ("%YAML 1.1\n---\na: 1\n", 1),
    ("a: 1\nb: two\n  words\n", 3),
    ("a: 'open\n  close'\n", 1),
    ("a: [1,\n  2]\n", 1),
    ("a: {b: 1}\n", 1),
    ("a:\n\tb: 1\n", 2),
    ("? complex\n: key\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a: 1\n b: 2\n", 2),
    ("a: b: c\n", 1),
    (NESTED, 14),
])
def test_text_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(YamlSubsetError) as e:
        safe_load(text)
    assert e.value.lineno == line
    assert f"line {line}:" in str(e.value)


# -- hypothesis: dicts dumped by safe_dump --------------------------------

_KEYS = st.text(alphabet=string.ascii_letters + string.digits + "_-. ",
                min_size=1, max_size=12)
_SCALAR = (st.none() | st.booleans()
           | st.integers(min_value=-10 ** 12, max_value=10 ** 12)
           | st.floats(allow_nan=False, width=64)
           | st.text(alphabet=string.printable.replace("\r", "")
                     .replace("\n", "").replace("\x0b", "")
                     .replace("\x0c", "").replace("\t", ""),
                     max_size=20))
_TREE = st.recursive(
    _SCALAR,
    lambda kids: st.lists(kids, max_size=3)
    | st.dictionaries(_KEYS, kids, max_size=3),
    max_leaves=10)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(_KEYS, _TREE, min_size=1, max_size=4))
def test_reader_equals_safe_load_on_safe_dump_output(doc):
    text = yaml.safe_dump(doc)
    assert safe_load(text) == yaml.safe_load(text) == doc


# -- (b) the helper -------------------------------------------------------

def _plain(v):
    """A helper attribute as comparable plain data (the SLO objects are
    each package's own dataclasses)."""
    if dataclasses.is_dataclass(v):
        return _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "__dict__"):
        return _plain(vars(v))
    return v


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_helper_attributes_equal_jax(name, tmp_path, monkeypatch):
    monkeypatch.delenv("ZOO_SERVING_TRANSPORT", raising=False)
    path = tmp_path / "config.yaml"
    path.write_text(CORPUS[name])
    j = _plain(vars(JHelper(config_path=str(path))))
    t = _plain(vars(THelper(config_path=str(path))))
    assert t == j


def test_helper_builds_without_pyyaml(tmp_path, monkeypatch):
    """The card's machine has no PyYAML: with ``yaml`` hidden (an import
    of it raises), the port's helper still reads the config."""
    monkeypatch.delenv("ZOO_SERVING_TRANSPORT", raising=False)
    path = tmp_path / "config.yaml"
    path.write_text(CORPUS["template_uncommented"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _hidden  # noqa: F401
    h = THelper(config_path=str(path))
    assert h.model_path == "/opt/work/model"
    assert h.image_shape == (3, 224, 224)
    assert h.bucket_sizes == [1, 2, 4, 8, 16, 32]
    assert h.registry_root == "/tmp/zoo-serving-registry"
    assert [c.name for c in h.slo_classes] == ["premium", "batch"]
    assert tcli._load_config(str(tmp_path))["params"]["workers"] == 2
