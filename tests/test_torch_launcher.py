"""The port's launcher (``analytics_zoo_tpu_torch.launcher``): the
counterparts of ``tests/test_launcher.py`` — environment propagation and
log fan-in, the three failure policies, the hosts-file surface, argument
validation, the CLI and the end-to-end launch over a partitioned dataset
— plus the two-process train and checkpoint of
``tests/test_distributed_2proc.py`` (data parallelism over gloo, in the
flat and the sharded checkpoint formats) and the restart policy's
auto-resume. Every exit-order assertion is made deterministic: the later
rank waits on a file the earlier one writes before it exits, and then
longer than the launcher's poll interval. Gangs that train run through
the CLI in a session of their own, killed whole past a time bound.
"""

import io
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from analytics_zoo_tpu_torch.launcher import (HostSpec, LaunchError, launch,
                                              parse_hosts_file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _trace_dir(tmp_path, monkeypatch):
    """Telemetry's output of this process and of the workers it starts
    (flight dumps on a fault path, traces) lands under ``tmp_path``, never
    in the checkout the tests run from."""
    from analytics_zoo_tpu_torch.utils import telemetry

    trace = str(tmp_path / "trace")
    monkeypatch.setenv("ZOO_TPU_TRACE_DIR", trace)
    monkeypatch.setattr(telemetry, "_TRACE_DIR", trace)
    return trace


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _env():
    """The launcher's own environment: no ZOO_TPU_* of the test run."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith("ZOO_TPU_")}


def _run_cli(cwd, args, timeout=TIMEOUT_S):
    """``python -m analytics_zoo_tpu_torch.launcher.cli *args`` from
    ``cwd`` (what a rank writes beside itself, a flight dump, lands
    there), in a session of its own: (exit code, merged output). A gang
    that outlives ``timeout`` is killed whole and fails the test."""
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env["ZOO_TPU_TRACE_DIR"] = os.path.join(str(cwd), "trace")
    p = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher.cli",
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(cwd), start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate(timeout=30)
        pytest.fail(f"the gang ran past {timeout} s:\n{out[-4000:]}")
    return p.returncode, out


def test_env_propagation_and_log_prefixes(tmp_path):
    script = _write(tmp_path, "envcheck.py", """
        import os, sys
        print("ENV", os.environ["ZOO_TPU_PROCESS_ID"],
              os.environ["ZOO_TPU_NUM_PROCESSES"],
              os.environ["ZOO_TPU_COORDINATOR"],
              os.environ.get("EXTRA_FLAG", "-"), sys.argv[1])
    """)
    cap = io.StringIO()
    rc = launch([script, "payload"], num_hosts=3,
                env={"EXTRA_FLAG": "on"}, stream=cap)
    out = cap.getvalue()
    assert rc == 0
    assert "[zoo-launch] job complete: 3 worker(s) exited 0" in out
    seen = {}
    for line in out.splitlines():
        if " ENV " in line:
            tag, rest = line.split(" ENV ", 1)
            rank, world, coord, extra, arg = rest.split()
            seen[tag] = (rank, world)
            assert world == "3"
            assert coord.startswith("127.0.0.1:")
            assert extra == "on"
            assert arg == "payload"
    assert sorted(seen) == [f"[worker-{i}]" for i in range(3)]
    assert sorted(r for r, _ in seen.values()) == ["0", "1", "2"]


def test_kill_all_policy_terminates_survivors(tmp_path):
    script = _write(tmp_path, "failfast.py", """
        import os, sys, time
        if os.environ["ZOO_TPU_PROCESS_ID"] == "0":
            sys.exit(3)
        time.sleep(60)
        print("SURVIVED")
    """)
    cap = io.StringIO()
    rc = launch([script], num_hosts=2, on_failure="kill-all",
                grace_s=5.0, stream=cap)
    out = cap.getvalue()
    assert rc == 3
    assert "SURVIVED" not in out
    assert "worker-0 exited rc=3" in out
    assert "terminating 1 remaining worker(s)" in out
    assert "job FAILED" in out


def test_report_policy_lets_survivors_finish(tmp_path):
    script = _write(tmp_path, "report.py", """
        import os, sys, time
        if os.environ["ZOO_TPU_PROCESS_ID"] == "0":
            sys.exit(7)
        time.sleep(0.3)
        print("SURVIVED", os.environ["ZOO_TPU_PROCESS_ID"])
    """)
    cap = io.StringIO()
    rc = launch([script], num_hosts=2, on_failure="report", stream=cap)
    out = cap.getvalue()
    assert rc == 7
    assert "SURVIVED 1" in out
    assert "job FAILED" in out


def test_first_nonzero_exit_code_wins(tmp_path):
    """Rank 1 exits only after rank 0 has written its marker and two
    seconds more (forty of the launcher's 50 ms polls): rank 0's code is
    the first the launcher sees, whatever the load on the machine."""
    marker = tmp_path / "rank0-exiting"
    script = _write(tmp_path, "codes.py", f"""
        import os, sys, time
        rank = int(os.environ["ZOO_TPU_PROCESS_ID"])
        marker = {str(marker)!r}
        if rank == 0:
            open(marker, "w").close()
            sys.exit(5)
        deadline = time.time() + 60
        while not os.path.exists(marker) and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(2.0)
        sys.exit(9)
    """)
    cap = io.StringIO()
    rc = launch([script], num_hosts=2, on_failure="report", stream=cap)
    assert rc == 5
    assert "first failure worker-0 rc=5; exit codes [5, 9]" in cap.getvalue()


def test_hosts_file_parse_and_remote_rejection(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("# placement\nlocalhost 2\n127.0.0.1\n")
    assert parse_hosts_file(str(hosts)) == [
        HostSpec("localhost", 2), HostSpec("127.0.0.1", 1)]

    bad = tmp_path / "bad"
    bad.write_text("localhost twelve\n")
    with pytest.raises(LaunchError, match="bad slot count"):
        parse_hosts_file(str(bad))

    remote = tmp_path / "remote"
    remote.write_text("localhost 1\ngpu-node-7 4\n")
    with pytest.raises(LaunchError, match="remote hosts not supported"):
        launch(["x.py"], hosts_file=str(remote))

    mismatch = tmp_path / "ok"
    mismatch.write_text("localhost 2\n")
    with pytest.raises(LaunchError, match="disagrees"):
        launch(["x.py"], num_hosts=3, hosts_file=str(mismatch))


def test_launch_validation():
    with pytest.raises(LaunchError, match="on_failure"):
        launch(["x.py"], num_hosts=1, on_failure="retry")
    with pytest.raises(LaunchError, match="no train script"):
        launch([], num_hosts=1)
    with pytest.raises(LaunchError, match=">= 1 worker"):
        launch(["x.py"], num_hosts=0)


def test_cli_rejects_bad_env_pair():
    from analytics_zoo_tpu_torch.launcher.cli import main

    assert main(["--env", "NOEQUALS", "script.py"]) == 2


def test_cli_runs_a_gang_as_a_module(tmp_path):
    script = _write(tmp_path, "hello.py", """
        import os
        print("HELLO", os.environ["ZOO_TPU_PROCESS_ID"])
    """)
    rc, out = _run_cli(tmp_path, ["--hosts", "2", script])
    assert rc == 0, out
    assert "[worker-0] HELLO 0" in out
    assert "[worker-1] HELLO 1" in out
    assert "job complete: 2 worker(s) exited 0" in out


_SMOKE = """
import sys
import numpy as np
from analytics_zoo_tpu_torch.common import nncontext as tnn

ctx = tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1000),
                         device="cpu")
rank = ctx.process_index
from analytics_zoo_tpu_torch.common.zoo_trigger import MaxEpoch
from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

fs = FeatureSet.from_dataset(sys.argv[1])
print(f"SHARDS pid={rank} {','.join(fs.local_shards)}", flush=True)
model = Sequential()
model.add(Dense(8, activation="relu", input_shape=(4,), name="s_d0"))
model.add(Dense(1, name="s_d1"))
model.compile(optimizer="adam", loss="mse")
trainer = model._ensure_trainer()
trainer.ensure_initialized()
before = [p.detach().clone() for p in model.parameters()]
assert before
trainer.train(fs, batch_size=8, end_trigger=MaxEpoch(1))
moved = any(not bool((a == b).all())
            for a, b in zip(before, model.parameters()))
print(f"FIT_DONE pid={rank} trained={int(moved)} steps={trainer.step}",
      flush=True)
"""


def test_launch_smoke_end_to_end(tmp_path):
    """Two ranks over an 8-shard npz dataset: disjoint shard sets that
    cover it, data-parallel training that moved the weights, the same
    step count on both ranks, and no hand-set ZOO_TPU_* environment."""
    root = tmp_path / "data"
    root.mkdir()
    rs = np.random.default_rng(0)
    for i in range(8):
        x = rs.standard_normal((16, 4)).astype(np.float32)
        np.savez(root / f"part-{i:02d}.npz", x0=x,
                 y0=x.sum(1, keepdims=True).astype(np.float32))
    script = _write(tmp_path, "smoke_train.py", _SMOKE)
    rc, out = _run_cli(tmp_path, ["--hosts", "2", script, str(root)])
    assert rc == 0, out
    shards = {}
    for line in out.splitlines():
        if " SHARDS pid=" in line:
            pid, names = line.split(" SHARDS pid=", 1)[1].split(" ", 1)
            shards[pid] = set(names.split(","))
    assert sorted(shards) == ["0", "1"]
    assert not shards["0"] & shards["1"]
    assert shards["0"] | shards["1"] == {f"part-{i:02d}.npz"
                                         for i in range(8)}
    # 64 rows a rank, 4 of each global batch of 8: 16 steps
    for pid in ("0", "1"):
        assert f"FIT_DONE pid={pid} trained=1 steps=16" in out
    assert "job complete: 2 worker(s) exited 0" in out


_TRAIN = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from analytics_zoo_tpu_torch.common import nncontext as tnn

torch.set_num_threads(1)
ctx = tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1000),
                         device="cpu")
assert ctx.num_processes == 2 and ctx.backend == "gloo", ctx.backend
assert ctx.mesh.shape["data"] == 2
rank = ctx.process_index

from analytics_zoo_tpu_torch.common.zoo_trigger import MaxIteration
from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

rng = np.random.default_rng(100)
x = rng.standard_normal((64, 8)).astype(np.float32)
y = (x[:, :1] > 0).astype(np.float32)

model = Sequential()
model.add(Dense(16, activation="relu", input_shape=(8,), name="t_d0"))
model.add(Dense(1, activation="sigmoid", name="t_d1"))
model.compile(optimizer=Adam(lr=0.01), loss="binary_crossentropy")
trainer = model._ensure_trainer()
ckpt = sys.argv[1]
trainer.checkpoint_dir = ckpt
trainer.train(ArrayFeatureSet([x], y), batch_size=32,
              end_trigger=MaxIteration(4))
assert trainer.step == 4, trainer.step

def flat():
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

# the gradient sum crossed the process boundary: the replicas agree
mine = flat()
both = [torch.empty_like(mine) for _ in range(2)]
dist.all_gather(both, mine)
assert torch.equal(both[0], both[1]), "params diverged across ranks"

trainer.save_checkpoint(ckpt)
trainer.train(ArrayFeatureSet([x], y), batch_size=32,
              end_trigger=MaxIteration(5))
trainer.load_checkpoint(ckpt)
assert trainer.step == 4, trainer.step
assert torch.equal(flat(), mine), "restore is not the saved state"
trainer.train(ArrayFeatureSet([x], y), batch_size=32,
              end_trigger=MaxIteration(6))
assert trainer.step == 6, trainer.step
print(f"WORKER_{rank}_OK files={sorted(os.listdir(ckpt))}", flush=True)
"""


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_two_process_train_and_checkpoint(tmp_path, fmt):
    script = _write(tmp_path, "train2.py", _TRAIN)
    ckpt = tmp_path / "ckpt"
    rc, out = _run_cli(tmp_path, ["--hosts", "2", "--env",
                                  "ZOO_TPU_SHARDED_CHECKPOINT="
                                  + ("1" if fmt == "sharded" else "0"),
                                  script, str(ckpt)])
    assert rc == 0, out
    for rank in (0, 1):
        assert f"WORKER_{rank}_OK" in out
    names = os.listdir(ckpt)
    if fmt == "sharded":
        # one shard file a process for each group, the commit names s4
        assert (ckpt / "sharded.commit").read_text() == "s4"
        for group in ("params", "state", "optim"):
            assert f"{group}.s4.shard0.npz" in names
            assert f"{group}.s4.shard1.npz" in names
    else:
        assert "ckpt-4" in names and (ckpt / "latest").read_text() == \
            "ckpt-4"


_RESTART = """
import os, sys, time
from analytics_zoo_tpu_torch.common import nncontext as tnn

ctx = tnn.init_nncontext(tnn.ZooConfig(log_every_n_steps=1000),
                         device="cpu")
rank = ctx.process_index
import numpy as np
from analytics_zoo_tpu_torch.common.zoo_trigger import (MaxIteration,
                                                        SeveralIteration)
from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

ckpt, marker = sys.argv[1], sys.argv[2]
first = not os.path.exists(marker)
x = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
y = x[:, :1].copy()
model = Sequential()
model.add(Dense(1, input_shape=(4,), name="r_d0"))
model.compile(optimizer="sgd", loss="mse")
trainer = model._ensure_trainer()
trainer.checkpoint_dir = ckpt
trainer.train(ArrayFeatureSet([x], y), batch_size=8,
              end_trigger=MaxIteration(2 if first else 4),
              checkpoint_trigger=SeveralIteration(1))
if first:
    if rank == 1:
        open(marker, "w").close()
        sys.exit(3)
    time.sleep(60)
print(f"RESUMED rank={rank} auto={os.environ['ZOO_TPU_AUTO_RESUME']} "
      f"ran={len(trainer.step_losses)} step={trainer.step}", flush=True)
"""


def test_restart_policy_relaunches_and_resumes(tmp_path):
    """A rank dies after the step-2 checkpoint: the gang is torn down and
    relaunched with ZOO_TPU_AUTO_RESUME=1, and the second attempt resumes
    at step 2 and runs only steps 3 and 4."""
    script = _write(tmp_path, "restart.py", _RESTART)
    rc, out = _run_cli(tmp_path, ["--hosts", "2", "--on-failure",
                                  "restart", "--max-restarts", "2",
                                  "--restart-backoff-s", "0.1", script,
                                  str(tmp_path / "ckpt"),
                                  str(tmp_path / "died")])
    assert rc == 0, out
    assert "worker-1 rc=3: restarting gang (attempt 1/2)" in out
    for rank in (0, 1):
        assert f"RESUMED rank={rank} auto=1 ran=2 step=4" in out
