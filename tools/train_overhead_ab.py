"""The trainer's per-step host cost, one checkout of the port against
another, on host-bound training paths on one CUDA card.

Two worker processes, each importing ``analytics_zoo_tpu_torch`` and
``chip_smoke`` from its own checkout (``--a`` and ``--b``), build the same
model from the same seed with the default ``ZooConfig`` (no TrainSummary,
no monitor) and run one unkept warm-up window. Then the driver asks them
for timed windows in alternating order, A B, B A, A B, ..., one worker at
a time, so both share the card and its clocks. A window is ``fit`` over
whole epochs between two ``torch.cuda.synchronize`` calls; its number is
wall over steps. Paths:

- ``ncf``: ``chip_smoke``'s NeuralCF (bench_ncf's MovieLens-1M shape) at
  batch 8192, float32, 64 steps a window;
- ``bert_bf16``: ``chip_smoke.ckpt_model`` (BERT-base + Dense(2), bf16,
  dropout 0.1, Adam) at 32 x 512 on int32 ids, 8 steps a window.

Prints one JSON line a path (each side's window times, p50 and the
distance between its quartiles, the pairs' differences) and writes them
to ``--out`` when given. Needs a card:

    python tools/train_overhead_ab.py --a PARENT_CHECKOUT --b CHECKOUT \\
        [--paths ncf,bert_bf16] [--pairs 12] [--out result.json]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = ("ncf", "bert_bf16")


# ---------------------------------------------------------------------------
# the worker: one checkout, one path
# ---------------------------------------------------------------------------

def _worker(root, path, seed):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.common.nncontext import init_nncontext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_nncontext()
    if path == "ncf":
        config = init_nncontext().config
        seed0, config.seed = config.seed, seed + 11
        model = cs.NeuralCF(cs.NCF_USERS, cs.NCF_ITEMS, cs.NCF_CLASSES,
                            **cs.NCF_KW)
        config.seed = seed0
        model.compile(optimizer=cs.Adam(lr=1e-3),
                      loss="sparse_categorical_crossentropy")
        x, y = cs.ncf_data(seed + 12)
        batch, epochs = cs.NCF_BATCH, 2
        steps = cs.NCF_SAMPLES // batch * epochs
    else:
        model = cs.ckpt_model(seed)
        batch, epochs, steps = cs.TRAIN_BATCH, 1, 8
        x, y, _ = cs.train_data(seed, steps * batch, ids=np.int32)

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(x, y, batch_size=batch, nb_epoch=epochs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    window()
    print(json.dumps({"ready": True, "steps": steps,
                      "root": os.path.abspath(root)}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        print(json.dumps({"ms_per_step": window()}), flush=True)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class _Side:
    def __init__(self, name, root, path, seed):
        self.name, self.times = name, []
        root = os.path.abspath(root)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", "--root",
             root, "--path", path, "--seed", str(seed)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=root)
        self.ready = self._read()

    def _read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"worker {self.name} exited "
                               f"({self.proc.wait()})")
        return json.loads(line)

    def run(self):
        self.proc.stdin.write("run\n")
        self.proc.stdin.flush()
        self.times.append(self._read()["ms_per_step"])

    def close(self):
        try:
            self.proc.stdin.close()
        finally:
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _p50(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _iqr(xs):
    """The distance between the quartiles: a side's own spread."""
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return q3 - q1


def compare(a_root, b_root, path, pairs, seed):
    sides = []
    try:
        for name, root in (("a", a_root), ("b", b_root)):
            sides.append(_Side(name, root, path, seed))
        a, b = sides
        for i in range(pairs):
            for side in ((a, b) if i % 2 == 0 else (b, a)):
                side.run()
    finally:
        for side in sides:
            side.close()
    diffs = [tb - ta for ta, tb in zip(a.times, b.times)]
    pa, pb = _p50(a.times), _p50(b.times)
    return {"path": path, "pairs": pairs, "steps_per_window": a.ready[
        "steps"], "a_root": a.ready["root"], "b_root": b.ready["root"],
            "a_ms": a.times, "b_ms": b.times, "a_p50_ms": pa,
            "b_p50_ms": pb, "b_over_a": pb / pa,
            "a_iqr_ms": _iqr(a.times), "b_iqr_ms": _iqr(b.times),
            "pair_diff_p50_ms": _p50(diffs),
            "pairs_b_slower": sum(d > 0 for d in diffs)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "worker":
        ap = argparse.ArgumentParser()
        ap.add_argument("--root", required=True)
        ap.add_argument("--path", choices=PATHS, required=True)
        ap.add_argument("--seed", type=int, default=0)
        args = ap.parse_args(argv[1:])
        _worker(args.root, args.path, args.seed)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="the first checkout")
    ap.add_argument("--b", required=True, help="the second checkout")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for path in args.paths.split(","):
        res = dict(compare(args.a, args.b, path, args.pairs, args.seed),
                   card=smi)
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
