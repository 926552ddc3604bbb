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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")


@pytest.fixture(autouse=True)
def _fresh_port_context():
    tnn.set_nncontext(None)
    yield
    tnn.set_nncontext(None)


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_no_port_module_imports_jax_or_the_jax_package():
    assert len(PORT_SOURCES) > 20 and PORT_SOURCES[-1].exists()
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in PORT_SOURCES for line, mod in _absolute_imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, analytics_zoo_tpu_torch.pipeline.inference, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.layers, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.models, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.objectives, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.metrics, "
            "analytics_zoo_tpu_torch.pipeline.api.keras.optimizers, "
            "analytics_zoo_tpu_torch.pipeline.engine, "
            "analytics_zoo_tpu_torch.feature, "
            "analytics_zoo_tpu_torch.models.recommendation, "
            "analytics_zoo_tpu_torch.models.image, "
            "analytics_zoo_tpu_torch.models.image.imageclassification, "
            "analytics_zoo_tpu_torch.models.textclassification, "
            "analytics_zoo_tpu_torch.models.anomalydetection, "
            "analytics_zoo_tpu_torch.models.textmatching, "
            "analytics_zoo_tpu_torch.models.seq2seq, "
            "analytics_zoo_tpu_torch.pipeline.api.autograd, "
            "analytics_zoo_tpu_torch.common.zoo_trigger, "
            "analytics_zoo_tpu_torch.ops, "
            "analytics_zoo_tpu_torch.ops.kv_cache, "
            "analytics_zoo_tpu_torch.ops.quant, "
            "analytics_zoo_tpu_torch.ops.batchnorm, "
            "analytics_zoo_tpu_torch.ops.conv, "
            "analytics_zoo_tpu_torch.serving, "
            "analytics_zoo_tpu_torch.serving.generation, "
            "analytics_zoo_tpu_torch.serving.admission, "
            "analytics_zoo_tpu_torch.utils.telemetry, "
            "analytics_zoo_tpu_torch.utils.profiling, "
            "analytics_zoo_tpu_torch.utils.layer_parity, "
            "analytics_zoo_tpu_torch.utils; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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
