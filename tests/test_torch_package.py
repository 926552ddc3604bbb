"""The port stands alone: no module of ``analytics_zoo_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
run on the GPU unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from analytics_zoo_tpu_torch.common import nncontext as tnn

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "analytics_zoo_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu", "yaml",
             "msgpack", "cv2", "PIL", "pandas", "tensorflow")


@pytest.fixture(autouse=True)
def _fresh_port_context():
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


#: the port's modules whose routes need TensorFlow at run time (the
#: frozen-graph freezer, the host callback, tfpark's lowering bridge and
#: what stands on it): they import it inside functions, never at import
TF_ROUTES = {f"analytics_zoo_tpu_torch/{m}.py" for m in (
    "pipeline/api/net/tfnet", "tfpark/tf_bridge", "tfpark/model",
    "tfpark/estimator", "tfpark/tf_optimizer")}


def _absolute_imports(path: Path):
    """(line, module, inside a function) of each absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node) if n is not node)
    for node in ast.walk(tree):
        inner = id(node) in in_function
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name, inner
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or "", inner
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value), inner


def test_no_port_module_imports_jax_or_the_jax_package():
    """No port module imports a FORBIDDEN package, but TensorFlow inside
    a function of a TF_ROUTES module."""
    assert len(PORT_SOURCES) > 20 and PORT_SOURCES[-1].exists()
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in PORT_SOURCES
           for line, mod, inner in _absolute_imports(p)
           if mod.split(".")[0] in FORBIDDEN and not (
               mod.split(".")[0] == "tensorflow" and inner and
               str(p.relative_to(ROOT)) in TF_ROUTES)]
    assert not bad, "\n".join(bad)
    for route in TF_ROUTES:
        assert (ROOT / route).exists(), route


def test_importing_the_port_loads_no_jax():
    code = ("import sys, analytics_zoo_tpu_torch.pipeline.inference, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.layers, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.models, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.objectives, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.metrics, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.optimizers, "
            "analytics_zoo_tpu_torch.pipeline.engine, "
            "analytics_zoo_tpu_torch.feature, "
            "analytics_zoo_tpu_torch.feature.host_pipeline, "
            "analytics_zoo_tpu_torch.feature.infeed_worker, "
            "analytics_zoo_tpu_torch.feature.dataset, "
            "analytics_zoo_tpu_torch.feature.tfrecord, "
            "analytics_zoo_tpu_torch.utils.native_loader, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.datasets, "
            "analytics_zoo_tpu_torch.models.recommendation, "
            "analytics_zoo_tpu_torch.models.image, "
            "analytics_zoo_tpu_torch.models.image.imageclassification, "
            "analytics_zoo_tpu_torch.models.image.objectdetection, "
            "analytics_zoo_tpu_torch.feature.image, "
            "analytics_zoo_tpu_torch.feature.image.codec, "
            "analytics_zoo_tpu_torch.feature.image.resize, "
            "analytics_zoo_tpu_torch.feature.image3d, "
            "analytics_zoo_tpu_torch.models.textclassification, "
            "analytics_zoo_tpu_torch.models.anomalydetection, "
            "analytics_zoo_tpu_torch.models.textmatching, "
            "analytics_zoo_tpu_torch.models.seq2seq, "
            "analytics_zoo_tpu_torch.pipeline.api.autograd, "
            "analytics_zoo_tpu_torch.pipeline.api.keras2, "
            "analytics_zoo_tpu_torch.pipeline.api.onnx, "
            "analytics_zoo_tpu_torch.pipeline.api.caffe, "
            "analytics_zoo_tpu_torch.pipeline.api.net, "
            "analytics_zoo_tpu_torch.ops.crf, "
            "analytics_zoo_tpu_torch.common.zoo_trigger, "
            "analytics_zoo_tpu_torch.ops, "
            "analytics_zoo_tpu_torch.ops.kv_cache, "
            "analytics_zoo_tpu_torch.ops.quant, "
            "analytics_zoo_tpu_torch.ops.batchnorm, "
            "analytics_zoo_tpu_torch.ops.conv, "
            "analytics_zoo_tpu_torch.serving, "
            "analytics_zoo_tpu_torch.serving.generation, "
            "analytics_zoo_tpu_torch.serving.admission, "
            "analytics_zoo_tpu_torch.serving.cli, "
            "analytics_zoo_tpu_torch.serving.fleet_worker, "
            "analytics_zoo_tpu_torch.serving.routing, "
            "analytics_zoo_tpu_torch.serving.shard_fabric, "
            "analytics_zoo_tpu_torch.serving.socket_queue, "
            "analytics_zoo_tpu_torch.launcher, "
            "analytics_zoo_tpu_torch.launcher.cli, "
            "analytics_zoo_tpu_torch.launcher.worker, "
            "analytics_zoo_tpu_torch.parallel, "
            "analytics_zoo_tpu_torch.parallel.collectives, "
            "analytics_zoo_tpu_torch.parallel.zero, "
            "analytics_zoo_tpu_torch.utils.sharded_checkpoint, "
            "analytics_zoo_tpu_torch.utils.yaml_subset, "
            "analytics_zoo_tpu_torch.utils.telemetry, "
            "analytics_zoo_tpu_torch.utils.profiling, "
            "analytics_zoo_tpu_torch.utils.memory, "
            "analytics_zoo_tpu_torch.utils.trace_merge, "
            "analytics_zoo_tpu_torch.pipeline.health, "
            "analytics_zoo_tpu_torch.pipeline.train_cli, "
            "analytics_zoo_tpu_torch.utils.layer_parity, "
            "analytics_zoo_tpu_torch.pipeline.nnframes, "
            "analytics_zoo_tpu_torch.pipeline.estimator, "
            "analytics_zoo_tpu_torch.utils.arrow_fs, "
            "analytics_zoo_tpu_torch.ray, "
            "analytics_zoo_tpu_torch.ray.cluster, "
            "analytics_zoo_tpu_torch.ray.worker_host, "
            "analytics_zoo_tpu_torch.automl, "
            "analytics_zoo_tpu_torch.tfpark, "
            "analytics_zoo_tpu_torch.tfpark.text, "
            "analytics_zoo_tpu_torch.utils; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


#: JAX packages with an ``__all__`` the port has not ported yet, each
#: with the ROADMAP item that ports it; a package named with a list is
#: ported but for those names
NOT_PORTED = {}


def _jax_all(init: Path):
    """A JAX package's ``__all__``, read from its source (no import)."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _jax_packages():
    out = {}
    for init in sorted((ROOT / "analytics_zoo_tpu").rglob("__init__.py")):
        names = _jax_all(init)
        if names is not None:
            out[".".join(init.parent.relative_to(ROOT).parts)] = names
    return out


@pytest.mark.parametrize("package", sorted(_jax_packages()))
def test_every_public_jax_name_imports_from_the_port(package):
    """Each name of a JAX package's ``__all__`` imports from the port's
    package of the same path, but for the packages and names that are
    still to port (each naming its ROADMAP item)."""
    import importlib

    names = _jax_packages()[package]
    waiting = NOT_PORTED.get(package)
    port_name = "analytics_zoo_tpu_torch" + package[len("analytics_zoo_tpu"):]
    if isinstance(waiting, str):
        assert waiting.startswith("A")
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_name)
        return
    exempt = set(waiting[1]) if waiting else set()
    port = importlib.import_module(port_name)
    missing = sorted(n for n in names if n not in exempt and
                     not hasattr(port, n))
    assert not missing, f"{port_name} lacks {missing}"
    assert all(not hasattr(port, n) for n in exempt), \
        f"{port_name} has {exempt}: take them out of NOT_PORTED"


def test_every_jax_layer_class_is_in_the_ports_layers_all():
    """The JAX layers package (which has no ``__all__``) exports each of
    its layer classes; the port's ``layers.__all__`` lists them all,
    ``KerasLayerWrapper`` included."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    tree = ast.parse((ROOT / "analytics_zoo_tpu/pipeline/api/keras/layers/"
                      "__init__.py").read_text())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    names |= {t.id for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets}
    missing = sorted(names - set(tl.__all__))
    assert not missing, missing
    assert "KerasLayerWrapper" in tl.__all__


def test_init_nncontext_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.init_nncontext()
    assert tnn._global_context is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.init_nncontext(device="cuda")


def test_init_nncontext_on_request_runs_on_the_cpu(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SEED", "7")
    ctx = tnn.init_nncontext(device="cpu")
    assert ctx.device == torch.device("cpu") and ctx.config.seed == 7
    assert tnn.get_nncontext() is ctx and tnn.init_nncontext() is ctx
    monkeypatch.setenv("ZOO_TPU_SEED", "x")
    with pytest.raises(ValueError, match="ZOO_TPU_SEED"):
        tnn.ZooConfig.from_env()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or where no CUDA device is visible, the
    script fails and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, alone), (ROOT, ROOT / "chip_smoke.py")):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"CUDA_VISIBLE_DEVICES": "",
                                  "PATH": "/usr/bin:/bin"})
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


@pytest.mark.parametrize("phase", ["estimators", "parallel", "layout"])
def test_chip_smoke_phase_refuses_to_run_without_a_card(phase):
    """``--phase NAME`` runs one phase on the card: where no CUDA device
    is visible it fails before building anything and writes no report."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--phase", phase], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


_FINISH_RUN = """
import multiprocessing, os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke

def children():
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if stat[stat.rindex(")") + 2:].split()[1] == str(os.getpid()):
                out.append(int(name))
    return out

if __name__ == "__main__":
    owner = chip_smoke.own_run()
    mark = os.environ[chip_smoke.RUN_MARK]
    worker = multiprocessing.get_context("spawn").Process(target=print)
    worker.start()
    worker.join()
    left = subprocess.Popen(["sleep", "60"])
    orphan = subprocess.Popen(["sh", "-c", "sleep 60 & echo $!"],
                              stdout=subprocess.PIPE, text=True)
    grandchild = int(orphan.stdout.readline())
    orphan.wait()
    assert chip_smoke.own_run() is False
    assert len(children()) == 2, children()   # the tracker, the sleep
    chip_smoke.finish_run(owner)
    assert children() == [], children()
    assert chip_smoke.run_strays() == []
    assert not os.path.exists(f"/proc/{grandchild}")
    print("strays stopped", mark)
"""


def test_chip_smoke_leaves_no_process_of_its_run(tmp_path):
    """At its end the script reaps its multiprocessing resource tracker
    itself (an orphan's zombie can outlive the run on a slow init) and
    stops, and names, every live process whose environment carries the
    run's mark: a child left running and an orphaned grandchild."""
    script = tmp_path / "finish_run.py"
    script.write_text(_FINISH_RUN)
    res = subprocess.run([sys.executable, str(script), str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "strays stopped" in res.stdout
    assert "stopped 2 process(es) that outlived their phase" in res.stderr
    assert res.stderr.count("sleep 60") == 2


def test_the_data_layer_works_without_pyarrow(tmp_path, monkeypatch):
    """The card's machine has no pyarrow: with it hidden (an import of it
    raises), the feature package imports, npz shards stream through the
    staged pipeline into ``fit``, and a parquet shard raises an
    ``ImportError`` that names pyarrow."""
    import numpy as np

    for name in [m for m in sys.modules if m.split(".")[0] == "pyarrow"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError):
        import pyarrow as _hidden  # noqa: F401
    from analytics_zoo_tpu_torch.feature import (FeatureSet,
                                                 build_host_pipeline)
    from analytics_zoo_tpu_torch.feature.dataset import write_parquet_shards
    from analytics_zoo_tpu_torch.feature.feature_set import DiskFeatureSet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    rng = np.random.default_rng(0)
    d = tmp_path / "npz"
    d.mkdir()
    for i in range(3):
        DiskFeatureSet.write_shard(
            str(d / f"part-{i}.npz"),
            rng.standard_normal((8, 4)).astype(np.float32),
            rng.standard_normal((8, 1)).astype(np.float32))
    fs = FeatureSet.from_dataset(str(d), process_index=0, num_processes=1)
    assert sum(1 for _ in build_host_pipeline(fs, 4)) == 6
    tnn.init_nncontext(device="cpu")
    m = Sequential()
    m.add(Dense(1, input_shape=(4,)))
    m.compile(optimizer="sgd", loss="mse")
    m.fit(fs, batch_size=4, nb_epoch=1)
    assert len(m.trainer.step_losses) == 6
    (tmp_path / "p").mkdir()
    (tmp_path / "p" / "part-0.parquet").write_bytes(b"PAR1")
    with pytest.raises(ImportError, match="pyarrow"):
        list(FeatureSet.from_dataset(str(tmp_path / "p"), process_index=0,
                                     num_processes=1).batches(4))
    with pytest.raises(ImportError, match="pyarrow"):
        write_parquet_shards(str(tmp_path / "w"), np.zeros((4, 2)))


def test_estimators_ray_automl_work_without_pandas_pyarrow_cloudpickle():
    """The card's machine has neither pandas, pyarrow nor cloudpickle:
    with the three hidden, nnframes fits and transforms a dict of columns,
    ``arrow_fs`` imports, and the ray runtime ships module-level tasks
    through the standard pickle; a lambda raises naming cloudpickle."""
    code = r'''
import sys
for m in ("pandas", "pyarrow", "pyarrow.fs", "cloudpickle"):
    sys.modules[m] = None
import numpy as np
from analytics_zoo_tpu_torch.common import nncontext
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.nnframes import NNEstimator
from analytics_zoo_tpu_torch.utils import arrow_fs
from analytics_zoo_tpu_torch.ray import raycontext
from analytics_zoo_tpu_torch import automl
nncontext.init_nncontext(device="cpu")
m = Sequential()
m.add(Dense(1, input_shape=(3,)))
df = {"features": np.ones((8, 3)).tolist(), "label": [1.0] * 8}
out = NNEstimator(m, "mse", [3], [1]).setBatchSize(4).fit(df).transform(df)
assert isinstance(out, dict) and len(out["prediction"]) == 8
assert raycontext._serializer() is raycontext._StdPickle
assert raycontext._serializer().loads(
    raycontext._serializer().dumps(automl.rolling_window)) \
    is automl.rolling_window
try:
    raycontext._serializer().dumps(lambda x: x)
except TypeError as e:
    assert "cloudpickle" in str(e)
else:
    raise AssertionError("a lambda pickled without cloudpickle")
print("ok")
'''
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, \
        res.stdout + res.stderr
